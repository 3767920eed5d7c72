"""Bag-of-binary-words vocabulary as device tensors (DBoW2-compatible).

Port of orbslam3_tpu/loop/vocab.py:
  * tree descent quantization (k-way, L levels, Hamming metric): each
    feature gathers only its node's k children per level ((N, k, 32) and a
    popcount), so memory and work are O(N*k*levels) whatever the tree's
    size;
  * L1-normalized TF-IDF BowVector, dense (small vocabularies) or sparse
    (top-leaf ids + weights) for million-leaf vocabularies;
  * L1 similarity s = 1 - 0.5*||v1 - v2||_1. For L1-normalized non-negative
    vectors this equals sum_i min(v1_i, v2_i), which `score_sparse_many`
    evaluates against a whole keyframe database from the sparse form in one
    gather and reduce;
  * the DBoW2 text-format loader for ORBvoc.txt files, with per-level
    validity masks for under-full nodes (padded child slots never win the
    argmin);
  * a compressed npz of the tree (`save_npz` / `load_npz`), how the
    repository ships the vocabularies its reference runs used.

`train_vocabulary` builds a tree from a descriptor corpus by recursive
binary k-means (majority-bit centers, Hamming assignment), the construction
DBoW2 uses. Training and the text files are host-side numpy; both return a
Vocabulary of CPU tensors, and `Vocabulary.to(device)` moves it.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from orbslam3_tpu_torch.ops.fast import topk_stable


class Vocabulary(NamedTuple):
    """k-way tree, `levels` deep. Level l has k^(l+1) nodes; children of
    node n (local index at its level) are local indices n*k..n*k+k-1."""

    level_desc: tuple  # per level: (k^(l+1), 32) uint8 node centers
    idf: torch.Tensor  # (n_leaves,) inverse-document-frequency weights
    k: int
    levels: int
    # per level: (k^(l+1),) bool; False marks padded child slots of
    # under-full nodes (real DBoW2 trees are not perfectly k-ary)
    level_valid: tuple = ()

    @property
    def n_leaves(self):
        return self.idf.shape[0]

    def to(self, device) -> "Vocabulary":
        return self._replace(level_desc=tuple(a.to(device) for a in self.level_desc),
                             idf=self.idf.to(device),
                             level_valid=tuple(a.to(device) for a in self.level_valid))


# -------------------------------------------------------------- training
def _unpack_bits_np(desc):
    return np.unpackbits(desc, axis=-1, bitorder="little")


def _pack_bits_np(bits):
    return np.packbits(bits, axis=-1, bitorder="little")


def _hamming_np(a, b):
    """(Na, 32) x (Nb, 32) -> (Na, Nb) int"""
    ba = _unpack_bits_np(a).astype(np.int16)
    bb = _unpack_bits_np(b).astype(np.int16)
    # distance = 256 - matches = (256 - a.b_pm1)/2 trick in int space
    return (256 - (2 * ba - 1) @ (2 * bb - 1).T) // 2


def _kmeans_binary(desc, k, rng, iters=8):
    """Binary k-means with Hamming assignment + majority-bit centers."""
    n = len(desc)
    if n <= k:
        centers = np.zeros((k, 32), np.uint8)
        centers[:n] = desc
        if n < k:
            centers[n:] = desc[rng.integers(0, n, k - n)] if n else 0
        assign = np.arange(n) % k
        return centers, assign
    centers = desc[rng.choice(n, k, replace=False)]
    assign = np.zeros(n, np.int64)
    for _ in range(iters):
        d = _hamming_np(desc, centers)
        assign = d.argmin(1)
        for c in range(k):
            sel = desc[assign == c]
            if len(sel) == 0:
                centers[c] = desc[rng.integers(0, n)]
            else:
                bits = _unpack_bits_np(sel)
                centers[c] = _pack_bits_np((bits.mean(0) >= 0.5).astype(np.uint8))
    return centers, assign


def train_vocabulary(descriptors: np.ndarray, k: int = 10, levels: int = 3,
                     seed: int = 0, doc_ids: np.ndarray | None = None) -> Vocabulary:
    """Build a k^levels-leaf tree from a (N, 32) uint8 corpus.

    doc_ids: optional (N,) frame/document index per descriptor for IDF
    estimation; defaults to all-one-document (uniform idf).
    """
    rng = np.random.default_rng(seed)
    level_desc = []
    # recursive split, breadth-first
    groups = [descriptors]
    group_members = [np.arange(len(descriptors))]
    for lv in range(levels):
        centers_lv = np.zeros((k ** (lv + 1), 32), np.uint8)
        new_groups = []
        new_members = []
        for gi, g in enumerate(groups):
            centers, assign = _kmeans_binary(g, k, rng)
            centers_lv[gi * k : (gi + 1) * k] = centers
            for c in range(k):
                sel = assign == c
                new_groups.append(g[sel] if len(g) else g)
                new_members.append(group_members[gi][sel] if len(g) else group_members[gi])
        groups = new_groups
        group_members = new_members
        level_desc.append(torch.from_numpy(centers_lv))

    n_leaves = k**levels
    # idf from document frequency
    if doc_ids is None:
        idf = np.ones(n_leaves, np.float32)
    else:
        n_docs = int(doc_ids.max()) + 1
        df = np.zeros(n_leaves, np.float64)
        for leaf, members in enumerate(group_members):
            if len(members):
                df[leaf] = len(np.unique(doc_ids[members]))
        idf = np.log(n_docs / np.maximum(df, 1.0)).astype(np.float32) + 1e-3
    valid = tuple(torch.ones((k ** (lv + 1),), dtype=torch.bool) for lv in range(levels))
    return Vocabulary(tuple(level_desc), torch.from_numpy(idf), k, levels, valid)


def world_vocab_corpus(frames, device=None):
    """The corpus of `train_world_vocab`: the valid ORB descriptors
    (default OrbConfig) of every len(frames) // 16-th left image, and the
    index of the image each came from. Returns numpy (descriptors (N, 32)
    uint8, doc_ids (N,))."""
    from orbslam3_tpu_torch import default_device
    from orbslam3_tpu_torch.frontend.orb import OrbConfig, detect_orb

    dev = default_device(device)
    descs, doc = [], []
    oc = OrbConfig()
    for di, i in enumerate(range(0, len(frames), max(len(frames) // 16, 1))):
        img = torch.from_numpy(np.asarray(frames[i][0]).astype(np.float32)).to(dev)
        f = detect_orb(img, oc)
        d = f.desc[f.valid].cpu().numpy()
        descs.append(d)
        doc.append(np.full(len(d), di))
    return np.concatenate(descs), np.concatenate(doc)


def train_world_vocab(world, frames, device=None) -> Vocabulary:
    """A small BoW vocabulary trained on a sequence's own ORB descriptors
    (bench.py::train_world_vocab): k=10, L=4 (10k leaves) with per-image
    idf. The features run on `device` (the card by default); `world` is
    not read (the JAX signature)."""
    corpus, doc_ids = world_vocab_corpus(frames, device)
    return train_vocabulary(corpus, k=10, levels=4, doc_ids=doc_ids)


# -------------------------------------------------------------- runtime
_POPCOUNT = np.array([bin(i).count("1") for i in range(256)], np.uint8)


def quantize(vocab: Vocabulary, desc, valid):
    """(N, 32) uint8 -> (N,) int32 leaf ids (batched descent).

    Each feature gathers only its current node's k children per level,
    (N, k, 32) work, never distances to a whole level (k^(l+1) nodes:
    gigabytes at ORBvoc's size). Among children at equal distance the first
    wins."""
    N = desc.shape[0]
    dev = desc.device
    popcount = torch.from_numpy(_POPCOUNT).to(dev)
    local = torch.zeros((N,), dtype=torch.long, device=dev)
    kids = torch.arange(vocab.k, device=dev)
    for lv in range(vocab.levels):
        base = local * vocab.k
        idx = base[:, None] + kids[None, :]  # (N, k)
        cand = vocab.level_desc[lv][idx]  # (N, k, 32) gather
        d = torch.sum(popcount[(desc[:, None, :] ^ cand).long()], dim=-1, dtype=torch.int32)
        if len(vocab.level_valid) > lv:
            d = torch.where(vocab.level_valid[lv][idx], d, torch.full_like(d, 1 << 20))
        # the first minimum: a stable sort keeps the lower child among ties
        local = base + torch.sort(d, dim=1, stable=True).indices[:, 0]
    return torch.where(valid, local.to(torch.int32), torch.full_like(local, -1, dtype=torch.int32))


def _term_counts(vocab: Vocabulary, leaf_ids):
    """(n_leaves,) float32 count of each leaf among the ids >= 0 (counts are
    small integers, exact in float32 in any order of summation)."""
    ok = leaf_ids >= 0
    tf = torch.zeros((vocab.n_leaves,), dtype=torch.float32, device=leaf_ids.device)
    return tf.index_add(0, torch.where(ok, leaf_ids, torch.zeros_like(leaf_ids)).long(),
                        ok.to(torch.float32))


def bow_vector(vocab: Vocabulary, leaf_ids):
    """(N,) leaf ids -> L1-normalized TF-IDF vector (n_leaves,)."""
    v = _term_counts(vocab, leaf_ids) * vocab.idf
    return v / torch.clamp(torch.sum(torch.abs(v)), min=1e-9)


def transform(vocab: Vocabulary, desc, valid):
    """Full transform: descriptors -> (bow_vector, leaf_ids)."""
    leaves = quantize(vocab, desc, valid)
    return bow_vector(vocab, leaves), leaves


def bow_sparse(vocab: Vocabulary, leaf_ids):
    """(N,) leaf ids -> sparse L1-normalized TF-IDF: (ids (N,), w (N,)).

    Unused slots carry id -1 / weight 0. Duplicate leaves are aggregated
    exactly (scatter-add into a dense scratch, then the at most N non-zeros
    are taken by weight, equal weights in order of leaf id). Storage per
    keyframe is O(N), not O(n_leaves)."""
    N = leaf_ids.shape[0]
    dense = _term_counts(vocab, leaf_ids) * vocab.idf
    dense = dense / torch.clamp(torch.sum(dense), min=1e-9)
    k_eff = min(N, vocab.n_leaves)  # tiny test vocabularies: n_leaves < N
    w, ids = topk_stable(dense, k_eff)
    if k_eff < N:
        ids = torch.nn.functional.pad(ids, (0, N - k_eff))
        w = torch.nn.functional.pad(w, (0, N - k_eff))
    ids = ids.to(torch.int32)
    return torch.where(w > 0, ids, torch.full_like(ids, -1)), w


def transform_sparse(vocab: Vocabulary, desc, valid):
    """descriptors -> (sparse_ids, sparse_weights, leaf_ids)."""
    leaves = quantize(vocab, desc, valid)
    ids, w = bow_sparse(vocab, leaves)
    return ids, w, leaves


def score_sparse_many(vocab: Vocabulary, q_ids, q_w, db_ids, db_w):
    """L1 score of one sparse query against a (K, L) sparse database.

    For L1-normalized non-negative vectors, 1 - 0.5*||a-b||_1 ==
    sum_i min(a_i, b_i); evaluated as one dense scatter of the query
    (n_leaves scratch), a (K, L) gather and a reduce."""
    # Padded -1 ids are routed to a spare slot past the last leaf and cut
    # off: scattering them to index 0 with weight 0 would race a real leaf-0
    # entry. A sparse vector holds each leaf once, so no other lanes collide.
    n = vocab.n_leaves
    real = q_ids >= 0
    qd = torch.zeros((n + 1,), dtype=torch.float32, device=q_ids.device)
    qd = qd.index_copy(0, torch.where(real, q_ids, torch.full_like(q_ids, n)).long(),
                       torch.where(real, q_w, torch.zeros_like(q_w)))[:n]
    g = qd[db_ids.long().clamp(0, n - 1)]
    g = torch.where(db_ids >= 0, g, torch.zeros_like(g))
    return torch.sum(torch.minimum(db_w, g), dim=-1)


def score_l1(v1, v2):
    """DBoW2 L1 score between L1-normalized vectors: 1 - 0.5*||v1-v2||_1.

    Broadcasts: v1 (V,) or (A, V), v2 (V,) or (B, V)."""
    diff = (torch.abs(v1[..., None, :] - v2[None, ...]) if v1.dim() == v2.dim() == 2
            else torch.abs(v1 - v2))
    return 1.0 - 0.5 * torch.sum(diff, dim=-1)


def save_dbow2_text(vocab: Vocabulary, path: str):
    """Write a (trained, full k-ary) vocabulary in DBoW2 ORBvoc.txt format:
    header `k L 0 0`, then one `parent is_leaf b0..b31 weight` line per node
    in breadth-first order."""
    k, levels = vocab.k, vocab.levels
    lines = [f"{k} {levels} 0 0"]
    # node ids: root=0 (implicit, not written); level l node i ->
    # 1 + sum_{j<l} k^(j+1) + i
    offsets = [1]
    for lv in range(levels):
        offsets.append(offsets[-1] + k ** (lv + 1))
    idf = vocab.idf.cpu().numpy()
    for lv in range(levels):
        arr = vocab.level_desc[lv].cpu().numpy()
        for i in range(arr.shape[0]):
            parent = 0 if lv == 0 else offsets[lv - 1] + i // k
            is_leaf = 1 if lv == levels - 1 else 0
            w = float(idf[i]) if lv == levels - 1 else 0.0
            d = " ".join(str(int(x)) for x in arr[i])
            lines.append(f"{parent} {is_leaf} {d} {w}")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def load_dbow2_text(path: str) -> Vocabulary:
    """Load a DBoW2 text vocabulary (ORBvoc.txt format): header `k L s1 s2`,
    then one line per node: parent_id is_leaf 32-bytes weight.
    """
    with open(path) as f:
        header = f.readline().split()
        k, levels = int(header[0]), int(header[1])
        children: dict[int, list[int]] = {0: []}
        descs = [np.zeros(32, np.uint8)]
        weights = [0.0]
        parents = [0]
        for line in f:
            parts = line.split()
            if len(parts) < 35:
                continue
            parent = int(parts[0])
            d = np.array([int(x) for x in parts[2:34]], np.uint8)
            w = float(parts[34])
            nid = len(descs)
            descs.append(d)
            weights.append(w)
            parents.append(parent)
            children.setdefault(parent, []).append(nid)
            children.setdefault(nid, [])

    # breadth-first flatten into per-level dense arrays. Real DBoW2 trees
    # are not perfectly k-ary: under-full nodes get INVALID padded child
    # slots (masked out of the descent argmin — a padded copy of the
    # parent's descriptor could beat every real child and divert the
    # descent), and early-leaf nodes carry through on slot 0
    # only (so the argmin deterministically follows them to the bottom,
    # where their stored weight applies).
    level_desc = []
    level_valid = []
    idf_leaves = []
    frontier = [0]  # node id per local slot at the current level
    carried = {0: False}  # slot node is a carried-through early leaf
    for lv in range(levels):
        n_nodes = k ** (lv + 1)
        arr = np.zeros((n_nodes, 32), np.uint8)
        ok = np.zeros((n_nodes,), bool)
        next_frontier = [-1] * n_nodes
        next_carried = {}
        for local_idx, node in enumerate(frontier):
            if node < 0:
                continue
            base = local_idx * k
            kids = [] if carried.get(local_idx, False) else children.get(node, [])
            if kids:
                for j, c in enumerate(kids[:k]):
                    arr[base + j] = descs[c]
                    ok[base + j] = True
                    next_frontier[base + j] = c
                    next_carried[base + j] = False
            else:
                # leaf above the bottom level: carry through on slot 0
                arr[base] = descs[node]
                ok[base] = True
                next_frontier[base] = node
                next_carried[base] = True
        level_desc.append(torch.from_numpy(arr))
        level_valid.append(torch.from_numpy(ok))
        frontier = next_frontier
        carried = next_carried
        if lv == levels - 1:
            idf_leaves = [weights[c] if c >= 0 else 0.0 for c in frontier]
    return Vocabulary(
        tuple(level_desc),
        torch.from_numpy(np.asarray(idf_leaves, np.float32)),
        k,
        levels,
        tuple(level_valid),
    )


def save_npz(vocab: Vocabulary, path: str):
    """The tree as a compressed npz: per-level node centres and validity
    masks, idf, k and the level count."""
    arrays = {"idf": vocab.idf.cpu().numpy(), "k": np.int64(vocab.k),
              "levels": np.int64(vocab.levels)}
    for lv in range(vocab.levels):
        arrays[f"desc_{lv}"] = vocab.level_desc[lv].cpu().numpy()
        if len(vocab.level_valid) > lv:
            arrays[f"valid_{lv}"] = vocab.level_valid[lv].cpu().numpy()
    np.savez_compressed(path, **arrays)


def load_npz(path: str) -> Vocabulary:
    """A tree written by `save_npz`, as CPU tensors."""
    with np.load(path) as z:
        levels = int(z["levels"])
        desc = tuple(torch.from_numpy(z[f"desc_{lv}"]) for lv in range(levels))
        valid = tuple(torch.from_numpy(z[f"valid_{lv}"]) for lv in range(levels)
                      if f"valid_{lv}" in z)
        return Vocabulary(desc, torch.from_numpy(z["idf"]), int(z["k"]), levels, valid)
