"""Loop closer: place recognition -> consistency -> Sim3 verification ->
pose-graph correction or map merge -> seam fusion -> global BA and inertial
refinement.

Port of orbslam3_tpu/loop/closer.py. Place recognition is an exhaustive
mutual-best Hamming match count of the query keyframe against every
earlier keyframe (row chunks of 16, each an (N, 16 N) product), with the
BoW database scoring every query beside it; geometric verification matches
two keyframes' map-point features and runs the reprojection-scored Sim3
RANSAC of loop/sim3.py; correction solves the essential graph
(optim/pose_graph.py), moves the points by their first keyframe's
correction, fuses duplicates across the seam and, when the seam moved far
enough, refines the whole map (parallel/distributed_ba.py) and the recent
inertial chain (optim/vi_ba.py).

The JAX package compiles each program once and pipelines its device->host
copies; here every program runs eagerly on the map's device and "in flight"
means device tensors that the host has not read yet. The host reads them
where the JAX host fetches them: one read per detection packet (candidates,
counts and their covisibility groups together), one per verification (its
counts, implied seams and the map ids it gates on), and in a correction one
for the new loop edge, one for the seam (with the anchor's validity), one
for the inertial refinement's gate. `sync` (a function that reads a small
tensor to the host and counts it) is the caller's, so FusedSlam counts these
reads among its own.

RANSAC draws come from a torch.Generator seeded from (7, kf_id) on the
map's device; `sampler` lets a caller supply the (C, 256, 3) draws instead
(the JAX package draws with jax.random.fold_in(PRNGKey(7), kf_id)).
"""
from __future__ import annotations

import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from orbslam3_tpu_torch.frontend.camera import Camera
from orbslam3_tpu_torch.frontend.stereo import pow12
from orbslam3_tpu_torch.geometry import quat
from orbslam3_tpu_torch.geometry.sim3 import Sim3
from orbslam3_tpu_torch.loop import vocab as vb
from orbslam3_tpu_torch.loop.sim3 import draw_samples, sim3_ransac_reproj
from orbslam3_tpu_torch.map.slam_map import MapState, scatter_set
from orbslam3_tpu_torch.ops.fast import topk_stable
from orbslam3_tpu_torch.ops.hamming import hamming_matrix
from orbslam3_tpu_torch.optim.pose_graph import PoseGraphProblem, solve_pose_graph
from orbslam3_tpu_torch.utils.logging import get_logger

I32 = torch.int32
F32 = torch.float32

# accumulated-loop-edge capacity: fixed so every pose-graph solve has one
# shape; 16 distinct loop closures in one session is far past any
# EuRoC-scale sequence
LOOP_EDGE_CAP = 16
N_HYP = 256  # Sim3 RANSAC hypotheses per candidate


class LoopConfig(NamedTuple):
    recent_gap: int = 15  # keyframe-id exclusion window
    consistency_needed: int = 3  # consecutive-keyframe consistency
    # consistency required in relocalization mode: 1 lets a single aliased
    # candidate weld the map wrongly; 2 costs one extra lost keyframe
    reloc_consistency: int = 2
    match_hamming_max: int = 50  # keyframe-keyframe descriptor gate
    # pose-graph odometry edges whose endpoints were inserted with fewer
    # pose-solve inliers (dead reckoning, lost-mode reacquisition) get
    # weak_edge_weight instead of 1.0: the correction bends the trajectory
    # where tracking was blind instead of in the healthy segments
    weak_edge_inliers: int = 30
    weak_edge_weight: float = 0.05
    min_sim3_matches: int = 20
    min_sim3_inliers: int = 15
    # Sim3 RANSAC inlier gate: two-way reprojection chi^2 in pixels,
    # octave-scaled (9.21 = chi2(2) 99%)
    sim3_chi2: float = 9.21
    # second-stage two-way per-match reprojection verification
    reproj_min_inliers: int = 25
    reproj_radius: float = 3.0  # [px] base radius (scaled by 1.2^octave)
    # place-recognition floor: a candidate's mutual-match count must exceed
    # this fraction of the query's valid features before verification
    rerank_min_frac: float = 0.25
    n_candidates: int = 4  # candidates examined per keyframe, best count first
    # keyframes sharing >= this many observations are not candidates
    covis_exclude_min: int = 15
    covis_edge_weight_min: int = 30  # pose-graph covisibility edges
    covis_edges_per_node: int = 6
    pose_graph_iters: int = 10
    loop_edge_weight: float = 100.0
    allow_cross_map: bool = True  # candidates in archived maps -> merge
    # min-score gate: candidates must score at least the lowest BoW score
    # among the query's covisible keyframes
    bow_min_score_gate: bool = True
    run_global_ba: bool = True
    # whole-map BA only when the correction moved the seam this far [m]
    heavy_repair_min_seam: float = 0.5
    # steady-state plausibility ceiling [m]: while tracking has been
    # healthy, a multi-meter implied seam is a periodic-texture alias
    steady_max_seam: float = 1.0
    # post-correction visual-inertial refinement of the recent temporal chain
    run_vi_refine: bool = True
    vi_refine_window: int = 96
    vi_refine_points: int = 2048
    vi_refine_fixed: int = 8
    vi_refine_iters: int = 6
    # whole-map budget (32768 = MapCapacity.max_mp), tiled Schur reduction
    gba_max_points: int = 32768
    gba_obs: int = 12
    gba_iters: int = 5
    gba_tile: int = 4096


class LoopStats(NamedTuple):
    candidates_checked: int = 0
    consistent: int = 0
    verified: int = 0
    corrected: int = 0
    # corrections that landed while the tracker was RECENTLY_LOST:
    # relocalizations into the existing map
    relocalized: int = 0


CHUNK = 16  # keyframe rows per exhaustive-match chunk


def _mutual_counts(desc, feat_valid, kf_desc, kf_feat_valid, hamming_max: int):
    """(K,) int32 mutual-best match count of the query's features against
    each keyframe row's, distances gated at hamming_max. Row chunks of
    CHUNK keep the (N, CHUNK, N) distance block small. Distances are
    integers <= 256 (exact in float32); among equal minima the first index
    wins, as in the JAX package."""
    K, N = kf_feat_valid.shape
    counts = []
    ar = torch.arange(N, device=desc.device)
    for c0 in range(0, K, CHUNK):
        rows = slice(c0, min(c0 + CHUNK, K))
        C = rows.stop - rows.start
        D = hamming_matrix(desc, kf_desc[rows].reshape(-1, 32)).reshape(N, C, N).to(F32)
        okr = feat_valid[:, None, None] & kf_feat_valid[rows][None, :, :]
        cost = torch.where(okr, D, torch.full_like(D, 1e6))
        bv, bb = torch.min(cost, dim=2)  # (N, C): best row feature per query feature
        ba = torch.argmin(cost, dim=0)  # (C, N): best query feature per row feature
        mutual = torch.gather(ba, 1, bb.T) == ar[None]
        counts.append(torch.sum(mutual & (bv.T <= hamming_max), dim=1, dtype=I32))
    return torch.cat(counts)


def _bow_program(vocab: vb.Vocabulary, bow_ids, bow_w, kf_desc, kf_feat_valid, kf_id: int):
    """BoW transform of keyframe kf_id into its database rows (in place)."""
    ids, w, _ = vb.transform_sparse(vocab, kf_desc[kf_id], kf_feat_valid[kf_id])
    bow_ids[kf_id] = ids
    bow_w[kf_id] = w


def _kf_program(vocab: vb.Vocabulary, cfg: LoopConfig, bow_ids, bow_w, st: MapState,
                kf_id: int, Kb: int):
    """BoW update, then exhaustive place recognition of keyframe kf_id
    against rows [0, Kb) and candidate gating. Returns (packet, groups):
    packet = [top ids (nc), their counts (nc), valid features, their BoW
    scores (nc), lowest BoW score among the covisible keyframes] as float32,
    groups (nc, Kb) bool: each candidate's covisibility group (itself
    included). Rows >= Kb are later than kf_id and masked anyway, so Kb
    changes the cost, not the result."""
    nc = cfg.n_candidates
    desc = st.kf_desc[kf_id]
    feat_valid = st.kf_feat_valid[kf_id]
    _bow_program(vocab, bow_ids, bow_w, st.kf_desc, st.kf_feat_valid, kf_id)
    kf_valid = st.kf_valid[:Kb]
    kf_map_id = st.kf_map_id[:Kb]
    covis = st.covis[:Kb, :Kb]
    dev = desc.device
    same_map = kf_map_id == kf_map_id[kf_id]
    map_ok = (same_map | (kf_map_id >= 0)) if cfg.allow_cross_map else same_map
    connected = covis[kf_id] >= cfg.covis_exclude_min
    idx = torch.arange(Kb, device=dev)
    # id recency proxies temporal recency only within a map
    recent = ((idx - kf_id).abs() < cfg.recent_gap) & same_map
    earlier = idx < kf_id
    mask = kf_valid & map_ok & ~connected & ~recent & earlier

    counts = _mutual_counts(desc, feat_valid, st.kf_desc[:Kb], st.kf_feat_valid[:Kb],
                            cfg.match_hamming_max)
    counts = torch.where(mask, counts, torch.full_like(counts, -1))
    top_c, top_i = topk_stable(counts, nc)
    bow_scores = vb.score_sparse_many(vocab, bow_ids[kf_id], bow_w[kf_id], bow_ids[:Kb],
                                      bow_w[:Kb])
    covis_rows = connected & kf_valid & same_map & (idx != kf_id)
    min_covis = torch.min(torch.where(covis_rows, bow_scores, torch.full_like(bow_scores, np.inf)))
    packet = torch.cat([top_i.to(F32), top_c.to(F32),
                        torch.sum(feat_valid, dtype=F32)[None], bow_scores[top_i], min_covis[None]])
    groups = (covis[top_i] > 0) & kf_valid[None, :]
    groups[torch.arange(nc, device=dev), top_i] = True
    return packet, groups


def _match_kf_pair(desc_a, valid_a, mp_a, desc_b, valid_b, mp_b):
    """Mutual-best Hamming matches between keyframe A's map-point-bearing
    features and B's; B's arrays may carry leading batch axes (candidates).
    Returns (best_b (..., N), best_val (..., N), ok (..., N)) aligned to A's
    rows; the first minimum wins ties."""
    D = hamming_matrix(desc_a, desc_b).to(F32)
    ok_a = valid_a & (mp_a >= 0)
    ok_b = valid_b & (mp_b >= 0)
    BIG = 1e6
    cost = torch.where(ok_a[..., :, None] & ok_b[..., None, :], D, torch.full_like(D, BIG))
    best_val, best_b = torch.min(cost, dim=-1)
    best_a_of_b = torch.argmin(cost, dim=-2)
    N = cost.shape[-2]
    mutual = torch.gather(best_a_of_b, -1, best_b) == torch.arange(N, device=D.device)
    return best_b, best_val, (best_val < BIG) & mutual


def _over_points(S: Sim3) -> Sim3:
    return Sim3(S.q[..., None, :], S.t[..., None, :], S.s[..., None])


def _reproj_pair_inliers(pa, pb, uv_a, uv_b, oct_a, oct_b, match_ok, S: Sim3, cam: Camera,
                         radius: float):
    """Two-way per-match reprojection count under S (C candidates): the
    candidate's point through S^-1 must land within radius*1.2^octave px of
    the current keyframe's feature, and the current point through S within
    the candidate's. pa (N, 3), pb (C, N, 3) body-frame points."""
    Sp = _over_points(S)
    uv_a_pred, za = cam.project_body(Sp.inverse().apply(pb))
    err_a = torch.linalg.norm(uv_a_pred - uv_a[None], dim=-1)
    rad_a = radius * pow12(oct_a)
    uv_b_pred, zb = cam.project_body(Sp.apply(pa[None]))
    err_b = torch.linalg.norm(uv_b_pred - uv_b, dim=-1)
    rad_b = radius * pow12(oct_b)
    ok = match_ok & (za > 0.2) & (zb > 0.2) & (err_a <= rad_a[None]) & (err_b <= rad_b)
    return torch.sum(ok, dim=-1, dtype=I32)


def _verify_program(st: MapState, kf_id: int, cands, cam: Camera, hamming_max: int, chi2: float,
                    radius: float, samples=None, generator: torch.Generator = None):
    """Geometric verification of a batch of candidates: mutual-best match,
    reprojection-scored Sim3 RANSAC, two-way pair reprojection count, and
    the implied seam (how far the candidate's Sim3 would move the current
    keyframe). `samples` (C, N_HYP, 3) or a function of the RANSAC mask
    (C, N) giving them; else drawn from `generator`. Returns (nm, ninl, nrp,
    disp, S) with a leading candidate axis."""
    M = st.mp_pos.shape[0]
    cb = torch.as_tensor(cands, device=st.kf_q.device).long()
    desc_a, valid_a, mp_a = st.kf_desc[kf_id], st.kf_feat_valid[kf_id], st.kf_mp[kf_id]
    qa, pa_ = st.kf_q[kf_id], st.kf_p[kf_id]
    mpa_safe = mp_a.clamp(0, M - 1).long()
    pa = quat.rotate(quat.conj(qa)[None], st.mp_pos[mpa_safe] - pa_[None])
    oct_a = st.kf_octave[kf_id]
    sig_a = pow12(oct_a)
    uv_a = st.kf_uv[kf_id]
    a_mp_valid = st.mp_valid[mpa_safe]

    best_b, best_val, ok = _match_kf_pair(desc_a, valid_a, mp_a, st.kf_desc[cb],
                                          st.kf_feat_valid[cb], st.kf_mp[cb])
    ok = ok & (best_val <= hamming_max)
    nm = torch.sum(ok, dim=-1, dtype=I32)
    mp_b = torch.gather(st.kf_mp[cb], 1, best_b).clamp(0, M - 1).long()
    ok = ok & a_mp_valid[None] & st.mp_valid[mp_b]
    # each keyframe's points in its own body frame (world estimates disagree
    # by exactly the drift to measure)
    qb, pb_ = st.kf_q[cb], st.kf_p[cb]
    pb = quat.rotate(quat.conj(qb)[:, None], st.mp_pos[mp_b] - pb_[:, None])
    oct_b = torch.gather(st.kf_octave[cb], 1, best_b)
    sig_b = pow12(oct_b)
    uv_b = torch.gather(st.kf_uv[cb], 1, best_b[..., None].expand(-1, -1, 2))
    if callable(samples):
        samples = samples(ok)
    Ss, ninl = [], []
    for c in range(cb.shape[0]):
        smp = (samples[c] if samples is not None
               else draw_samples(ok[c], N_HYP, generator))
        S_c, _, n_c = sim3_ransac_reproj(pa, pb[c], uv_a, uv_b[c], sig_a, sig_b[c], ok[c], cam,
                                         samples=smp, chi2=chi2, fix_scale=True)
        Ss.append(S_c)
        ninl.append(n_c)
    S = Sim3(*[torch.stack(x) for x in zip(*Ss)])
    ninl = torch.stack(ninl)
    nrp = _reproj_pair_inliers(pa, pb, uv_a, uv_b, oct_a, oct_b, ok, S, cam, radius)
    # implied seam: T_cand . S . T_cur^-1 applied to the current keyframe
    one = torch.ones((), dtype=F32, device=qa.device)
    T_cand = Sim3(qb, pb_, one.expand(cb.shape[0]))
    T_cur = Sim3(qa, pa_, one)
    T_corr = T_cand.compose(S).compose(T_cur.inverse())
    disp = torch.linalg.norm(T_corr.apply(pa_) - pa_, dim=-1)
    return nm, ninl, nrp, disp, S


def _take(S: Sim3, r: int) -> Sim3:
    return Sim3(*[a[r] for a in S])


class LoopCloser:
    # keyframe-table rows are sliced to the next multiple of this before the
    # detection program: cost scales with the live map prefix instead of
    # the capacity (rows > kf_id are masked out anyway)
    ROW_BUCKET = 64

    def __init__(self, vocabulary: vb.Vocabulary, cfg: LoopConfig = LoopConfig(), sync=None):
        self.vocab = vocabulary
        self.cfg = cfg
        # sparse keyframe BoW database: (K_cap, L) leaf ids + weights
        self.bow_ids: Optional[torch.Tensor] = None
        self.bow_w: Optional[torch.Tensor] = None
        self.stats = LoopStats()
        self._consistency_groups: list = []  # (group set, chain length, kf)
        self.last_loop_kf = -100
        # True iff the latest correction was a cross-map merge (the tracker's
        # world frame itself moved); same-map corrections keep the anchor frame
        self.last_was_merge = False
        # one-deep detection pipeline: the packet launched for keyframe k is
        # read and acted on while servicing keyframe k+1
        self._pending: Optional[tuple] = None  # (kf_id, packet, groups)
        # one-deep verification pipeline, read at the next loop service:
        # (round_id, kf_id, cands, reloc, steady, nm, ninl, nrp, disp, S)
        self._verify_pending: Optional[tuple] = None
        # host wall time per stage ("loop.<stage>": [total_s, calls]); the
        # device runs ahead, so its work lands in the stage that next reads
        self.timing: dict = {}
        # one record per correction: rows, kind, seam, stage times
        self.corrections: list = []
        # accumulated loop edges (i=cand, j=cur, q(4), t(3), s), host-side,
        # capped at LOOP_EDGE_CAP; they stay in every later pose-graph solve
        self._loop_edges: list = []
        # world-frame gravity for the post-correction inertial refinement,
        # kept in sync by the host once the IMU initializes (None = visual only)
        self.gravity_w = None
        # optional RANSAC draws: f(kf_id, mask (C, N)) -> (C, N_HYP, 3)
        self.sampler = None
        self.host_syncs = 0
        self._sync_fn = sync
        self._log = get_logger("orbslam3_tpu_torch.loop")

    # ------------------------------------------------------------------
    def _sync(self, x):
        if self._sync_fn is not None:
            return self._sync_fn(x)
        self.host_syncs += 1
        return x.tolist()

    def _clock(self, name: Optional[str] = None, t0: float = 0.0) -> float:
        """Now; with a stage name, its time since t0 is added to timing."""
        now = time.perf_counter()
        if name is not None:
            cell = self.timing.setdefault("loop." + name, [0.0, 0])
            cell[0] += now - t0
            cell[1] += 1
        return now

    def _ensure_storage(self, st: MapState):
        dev = st.kf_q.device
        if self.vocab.idf.device != dev:
            self.vocab = self.vocab.to(dev)
        if self.bow_ids is None:
            K, L = st.kf_desc.shape[:2]
            self.bow_ids = torch.full((K, L), -1, dtype=I32, device=dev)
            self.bow_w = torch.zeros((K, L), dtype=F32, device=dev)

    def remap_rows(self, kf_old_to_new):
        """Re-index per-keyframe state after map compaction. kf_old_to_new:
        (K,) int, -1 = row removed."""
        km = np.asarray(kf_old_to_new)
        if self.bow_ids is not None:
            dev = self.bow_ids.device
            old_rows = np.nonzero(km >= 0)[0]
            new_ids = torch.full_like(self.bow_ids, -1)
            new_w = torch.zeros_like(self.bow_w)
            if len(old_rows):
                src = torch.from_numpy(old_rows).to(dev)
                dst = torch.from_numpy(km[old_rows].astype(np.int64)).to(dev)
                new_ids[dst] = self.bow_ids[src]
                new_w[dst] = self.bow_w[src]
            self.bow_ids, self.bow_w = new_ids, new_w
        # the consistency history and the in-flight packet and verification
        # hold old row ids: dropping them delays a detection by a few keyframes
        self._consistency_groups.clear()
        self._pending = None
        self._verify_pending = None
        if 0 <= self.last_loop_kf < len(km) and km[self.last_loop_kf] >= 0:
            self.last_loop_kf = int(km[self.last_loop_kf])
        elif self.last_loop_kf >= 0:
            self.last_loop_kf = -100
        # loop edges follow their endpoints; an edge goes with a culled end
        self._loop_edges = [
            (int(km[i]), int(km[j]), q, t, s)
            for (i, j, q, t, s) in self._loop_edges
            if 0 <= i < len(km) and 0 <= j < len(km) and km[i] >= 0 and km[j] >= 0
        ]

    @property
    def pending_kf(self) -> Optional[int]:
        """Newest keyframe row with work in flight (detection packet or
        verification), or None."""
        rows = [p[0] for p in (self._pending,) if p is not None]
        rows += [p[1] for p in (self._verify_pending,) if p is not None]
        return max(rows) if rows else None

    def warmup(self, st: MapState, cam: Camera):
        """Run every loop-closing program once on `st` (a shape donor) and
        discard the results: the first calls load the solver libraries and
        size the allocator's pools, which would otherwise land at the first
        real loop closure. The BoW database and the loop-edge store are left
        as they were; the reads are counted."""
        self._ensure_storage(st)
        cfg = self.cfg
        K = st.kf_valid.shape[0]
        _kf_program(self.vocab, cfg, self.bow_ids.clone(), self.bow_w.clone(), st, 0,
                    min(self.ROW_BUCKET, K))
        _bow_program(self.vocab, self.bow_ids.clone(), self.bow_w.clone(), st.kf_desc,
                     st.kf_feat_valid, 0)
        self._verify_all(st, 1, [0], cam)
        g_saved, self.gravity_w = self.gravity_w, torch.tensor(
            [0.0, 0.0, -9.81], dtype=F32, device=st.kf_q.device)
        n_corr = len(self.corrections)
        self._correct(st, 1, 0, Sim3.identity(device=st.kf_q.device), cam, record=False)
        del self.corrections[n_corr:]
        self.gravity_w = g_saved
        self.timing.clear()

    def on_keyframe(self, st: MapState, kf_id: int, cam: Camera, multi_map: bool = True,
                    round_id: int = -1, reloc: bool = False, steady: bool = False):
        """Launch detection for this keyframe and act on the previous
        keyframe's detection packet (and on a verification of an earlier
        round).

        multi_map: whether archived maps exist (the host's knowledge as of
        the previous round). With one map the first recent_gap keyframes
        have no admissible candidate: they take the BoW-only program.
        reloc: relocalization mode (tracker RECENTLY_LOST): the consistency
        gate drops to reloc_consistency. steady: tracking has been healthy
        for a long while: the implied-seam veto is armed.
        Returns (MapState, corrected)."""
        self._ensure_storage(st)
        st, corrected0 = self._apply_verify(st, cam, round_id=round_id)
        prev, self._pending = self._pending, None
        c1 = False
        if prev is not None:
            st, c1 = self._process_packet(st, *prev, cam, round_id=round_id, reloc=reloc,
                                          steady=steady)
        # cold-chain stride: with no live consistency chain and no
        # relocalization pressure, every second keyframe takes the cheap
        # BoW-only program (a loop start is delayed by at most one keyframe)
        cold_stride = not reloc and not self._consistency_groups and (kf_id & 1) == 1
        t0 = self._clock()
        if cold_stride or (not multi_map and kf_id < self.cfg.recent_gap):
            _bow_program(self.vocab, self.bow_ids, self.bow_w, st.kf_desc, st.kf_feat_valid,
                         kf_id)
            self._clock("bow_only", t0)
            return st, corrected0 or c1
        K = st.kf_valid.shape[0]
        Kb = min(-(-(kf_id + 1) // self.ROW_BUCKET) * self.ROW_BUCKET, K)
        packet, groups = _kf_program(self.vocab, self.cfg, self.bow_ids, self.bow_w, st, kf_id, Kb)
        self._clock("detect", t0)
        self._pending = (kf_id, packet, groups)
        return st, corrected0 or c1

    def drain(self, st: MapState, cam: Camera, sync: bool = True):
        """Act on the in-flight verification and detection packet (idle
        service rounds and the end of the sequence). sync=True resolves a
        verification the drained packet dispatches at once; sync=False
        leaves it for the next round."""
        st, c0 = self._apply_verify(st, cam)
        if self._pending is None:
            return st, c0
        prev, self._pending = self._pending, None
        st, c1 = self._process_packet(st, *prev, cam, sync=sync)
        return st, c0 or c1

    def _process_packet(self, st: MapState, kf_id: int, packet, groups, cam: Camera,
                        sync: bool = False, round_id: int = -1, reloc: bool = False,
                        steady: bool = False):
        cfg = self.cfg
        if kf_id - self.last_loop_kf < cfg.recent_gap:
            return st, False
        nc = cfg.n_candidates
        t0 = self._clock()
        arr = np.asarray(self._sync(torch.cat([packet, groups.reshape(-1).to(F32)])),
                         dtype=np.float32)
        self._clock("packet_read", t0)
        cand_ids = arr[:nc].astype(int)
        cand_counts = arr[nc:2 * nc]
        n_valid = arr[2 * nc]
        cand_bow = arr[2 * nc + 1:3 * nc + 1]
        min_covis = arr[3 * nc + 1]
        grp = arr[3 * nc + 2:].reshape(nc, -1) > 0
        # match-count floor: below it even a true revisit has too little
        # overlap for the Sim3 and reprojection stages
        floor = max(cfg.rerank_min_frac * n_valid, cfg.min_sim3_matches)
        to_try = []
        for r in range(nc):
            if cand_counts[r] < floor or cand_ids[r] < 0:
                continue
            # min-score gate, loop detection only (a lost keyframe's
            # covisibles are themselves lost: no reliable reference)
            if (cfg.bow_min_score_gate and not reloc
                    and np.isfinite(min_covis) and cand_bow[r] < min_covis):
                continue
            self.stats = self.stats._replace(candidates_checked=self.stats.candidates_checked + 1)
            chain = self._consistency_chain(kf_id, grp[r])
            needed = cfg.reloc_consistency if reloc else cfg.consistency_needed
            if chain >= needed:
                to_try.append(int(cand_ids[r]))
        if to_try:
            self.stats = self.stats._replace(consistent=self.stats.consistent + 1)
        if not to_try:
            return st, False
        # one verification slot: a keyframe of this round whose verification
        # is still in flight keeps it (the next keyframe re-detects the region)
        if self._verify_pending is not None:
            return st, False
        self._verify_pending = (round_id, kf_id, to_try, reloc, steady,
                                *self._dispatch_verify(st, kf_id, to_try, cam))
        if sync:
            return self._apply_verify(st, cam, sync=True)
        return st, False

    def _dispatch_verify(self, st: MapState, kf_id: int, cands: list, cam: Camera):
        """Launch the verification, padded to n_candidates by repeating the
        first candidate; returns (nm, ninl, nrp, disp, S) on the device."""
        cfg = self.cfg
        dev = st.kf_q.device
        t0 = self._clock()
        n_fix = max(cfg.n_candidates, len(cands))
        cand_v = list(cands) + [cands[0]] * (n_fix - len(cands))
        gen = None
        samples = None
        if self.sampler is not None:
            samples = (lambda ok: self.sampler(kf_id, ok))
        else:
            gen = torch.Generator(device=dev)
            gen.manual_seed((7 << 32) | kf_id)
        out = _verify_program(st, kf_id, cand_v, cam, cfg.match_hamming_max, cfg.sim3_chi2,
                              cfg.reproj_radius, samples=samples, generator=gen)
        self._clock("verify", t0)
        return out

    def _apply_verify(self, st: MapState, cam: Camera, round_id: int = -1, sync: bool = False):
        """Act on the in-flight verification: gate its counts and, on a
        pass, merge and/or correct. A verification dispatched in the current
        service round (same round_id) stays in flight unless sync.
        Returns (MapState, corrected)."""
        if self._verify_pending is None:
            return st, False
        if not sync and round_id >= 0 and self._verify_pending[0] == round_id:
            return st, False
        (_, kf_id, cands, reloc, steady, nm, ninl, nrp, disp, S), self._verify_pending = (
            self._verify_pending, None)
        cfg = self.cfg
        if kf_id - self.last_loop_kf < cfg.recent_gap:
            return st, False  # a newer correction already covered this
        dev = st.kf_q.device
        t0 = self._clock()
        nc = nm.shape[0]
        maps = st.kf_map_id[torch.tensor(list(cands) + [kf_id], device=dev)]
        vals = self._sync(torch.cat([x.to(torch.float64) for x in (nm, ninl, nrp, disp, maps)]))
        self._clock("verify_read", t0)
        nm_h, ninl_h, nrp_h = vals[:nc], vals[nc:2 * nc], vals[2 * nc:3 * nc]
        disp_h = vals[3 * nc:4 * nc]
        map_h = vals[4 * nc:]
        for r, cand in enumerate(cands):
            if not (nm_h[r] >= cfg.min_sim3_matches and ninl_h[r] >= cfg.min_sim3_inliers
                    and nrp_h[r] >= cfg.reproj_min_inliers):
                continue
            # steady-state plausibility veto: multi-meter drift cannot build
            # up while tracking has been continuously healthy
            if steady and disp_h[r] > cfg.steady_max_seam:
                self._log.info("veto: steady-state correction with %.1f m seam (kf=%d cand=%d)",
                               float(disp_h[r]), kf_id, cand)
                continue
            S_rel = _take(S, r)
            self.stats = self.stats._replace(verified=self.stats.verified + 1)
            cross_map = int(map_h[r]) != int(map_h[-1])
            self.last_was_merge = cross_map
            t1 = self._clock()
            if cross_map:
                st = self._merge_maps(st, kf_id, cand, S_rel)
                self._clock("merge", t1)
            st = self._correct(st, kf_id, cand, S_rel, cam, reloc=reloc, merge=cross_map)
            self.stats = self.stats._replace(corrected=self.stats.corrected + 1,
                                             relocalized=self.stats.relocalized + int(reloc))
            self.last_loop_kf = kf_id
            self._consistency_groups.clear()
            return st, True
        return st, False

    # ------------------------------------------------------------------
    def _consistency_chain(self, kf_id: int, cand_group) -> int:
        """Per-group consistency chains: a candidate group extends the longest
        chain it overlaps among those extended at earlier keyframes; groups
        not extended within 3 keyframes are dropped."""
        group = set(np.nonzero(np.asarray(cand_group))[0].tolist())
        best_chain = 0
        for prev_group, chain, prev_kf in self._consistency_groups:
            if group & prev_group and prev_kf < kf_id:
                best_chain = max(best_chain, chain)
        chain = best_chain + 1
        self._consistency_groups.append((group, chain, kf_id))
        self._consistency_groups = [
            (g, c, k) for (g, c, k) in self._consistency_groups if kf_id - k <= 3
        ][-32:]
        return chain

    def _verify_all(self, st: MapState, kf_id: int, cands: list, cam: Camera):
        """Geometric verification of all candidates with one read. Returns
        {rank: Sim3} for every candidate that passed the three gates."""
        cfg = self.cfg
        nc = len(cands)
        nm, ninl, nrp, _disp, S = self._dispatch_verify(st, kf_id, cands, cam)
        n_fix = nm.shape[0]
        vals = self._sync(torch.cat([nm, ninl, nrp]))
        out = {}
        for r in range(nc):
            if (vals[r] >= cfg.min_sim3_matches and vals[n_fix + r] >= cfg.min_sim3_inliers
                    and vals[2 * n_fix + r] >= cfg.reproj_min_inliers):
                out[r] = _take(S, r)
        return out

    def _merge_maps(self, st: MapState, kf_id: int, cand: int, S_rel: Sim3) -> MapState:
        """Fold the current (newer) map into the candidate's (older) map:
        T = T_w(cand) * S_rel * T_w(cur)^-1 maps current-map world
        coordinates into the old map's frame; every current-map keyframe
        (culled rows too) and point is moved and relabelled, and the old map
        becomes the active one."""
        cur_map = st.kf_map_id[kf_id]
        old_map = st.kf_map_id[cand]
        one = torch.ones((), dtype=F32, device=st.kf_q.device)
        T_cand = Sim3(st.kf_q[cand], st.kf_p[cand], one)
        T_cur = Sim3(st.kf_q[kf_id], st.kf_p[kf_id], one)
        T_corr = T_cand.compose(S_rel).compose(T_cur.inverse())
        in_cur_kf = st.kf_map_id == cur_map
        in_cur_mp = st.mp_valid & (st.mp_map_id == cur_map)
        q_new = quat.normalize(quat.mul(T_corr.q[None], st.kf_q))
        p_new = quat.rotate(T_corr.q[None], st.kf_p) * T_corr.s + T_corr.t[None]
        v_new = quat.rotate(T_corr.q[None], st.kf_v)
        mp_new = T_corr.apply(st.mp_pos)
        nrm_new = quat.rotate(T_corr.q[None], st.mp_normal)
        kf_c, mp_c = in_cur_kf[:, None], in_cur_mp[:, None]
        return st._replace(
            kf_q=torch.where(kf_c, q_new, st.kf_q),
            kf_p=torch.where(kf_c, p_new, st.kf_p),
            kf_v=torch.where(kf_c, v_new, st.kf_v),
            kf_map_id=torch.where(in_cur_kf, old_map, st.kf_map_id),
            mp_pos=torch.where(mp_c, mp_new, st.mp_pos),
            mp_normal=torch.where(mp_c, nrm_new, st.mp_normal),
            mp_map_id=torch.where(in_cur_mp, old_map, st.mp_map_id),
            active_map=old_map.clone(),
        )

    def _correct(self, st: MapState, kf_id: int, cand: int, S_rel: Sim3, cam: Camera,
                 record: bool = True, reloc: bool = False, merge: bool = False) -> MapState:
        """Pose-graph correction over the essential graph, then the map
        points by their first keyframe's correction, seam fusion, and (for a
        seam of heavy_repair_min_seam or more) global BA; then the inertial
        refinement when gravity is known. record=False (warmup) keeps the
        call out of the loop-edge store."""
        from orbslam3_tpu_torch.map.mapping_ops import fuse_across_seam

        cfg = self.cfg
        dev = st.kf_q.device
        t_start = self._clock()
        rec = dict(kf_id=kf_id, cand=cand, merge=merge, reloc=reloc, host_reads=0)
        # stage times are host wall: the device's work lands in the stage
        # that next reads (the edge, the seam, the inertial refinement's gate)
        last = [t_start]

        def lap(stage: str):
            """End of a stage of this correction: its time, here and in timing."""
            now = self._clock(stage, last[0])
            rec[stage + "_ms"] = (now - last[0]) * 1e3
            last[0] = now

        def read(x):
            rec["host_reads"] += 1
            return self._sync(x)

        K = st.kf_valid.shape[0]
        # every row of this map takes part, culled rows included: they ride
        # along on their temporal edge and stay coherent as later anchors
        mapmask = st.kf_map_id == st.kf_map_id[kf_id]
        valid = st.kf_valid & mapmask
        idx = torch.arange(K, device=dev)
        one = torch.ones((), dtype=F32, device=dev)

        # rigid pre-correction of the current segment: kf_id and everything
        # newer start at the verified corrected pose, so the loop edge holds
        # at initialization and GN distributes the seam along the chain
        T_cand = Sim3(st.kf_q[cand], st.kf_p[cand], one)
        T_cur = Sim3(st.kf_q[kf_id], st.kf_p[kf_id], one)
        T_corr = T_cand.compose(S_rel).compose(T_cur.inverse())
        group = (mapmask & (idx >= kf_id))[:, None]
        q_pre = torch.where(group, quat.normalize(quat.mul(T_corr.q[None], st.kf_q)), st.kf_q)
        p_pre = torch.where(group, Sim3(T_corr.q[None], T_corr.t[None], T_corr.s[None]).apply(
            st.kf_p), st.kf_p)
        nodes = Sim3(q_pre, p_pre, torch.ones(K, dtype=F32, device=dev))

        # edges: temporal chain + top covisibility pairs + loop edges; edges
        # at keyframes inserted with few inliers are weak
        strong = st.kf_inliers >= cfg.weak_edge_inliers
        prev = st.kf_prev.long()
        t_i = prev.clamp(0, K - 1)
        t_j = idx
        t_ok = (prev >= 0) & valid & valid[t_i]
        w_t = torch.where(strong & strong[t_i], 1.0, cfg.weak_edge_weight).to(F32)

        nce = cfg.covis_edges_per_node
        w_cov, cov_j = topk_stable(
            torch.where(valid[:, None] & valid[None, :], st.covis, torch.zeros_like(st.covis)),
            nce)
        c_i = idx.repeat_interleave(nce)
        c_j = cov_j.reshape(-1)
        c_ok = (w_cov.reshape(-1) >= cfg.covis_edge_weight_min) & (c_i < c_j)
        w_c = torch.where(strong[c_i] & strong[c_j], 1.0, cfg.weak_edge_weight).to(F32)

        # past loop edges (fixed capacity), then the current one last; one
        # read of the new edge, with the pair's keyframe times for the record
        edge = np.asarray(read(torch.cat([S_rel.q, S_rel.t, S_rel.s.reshape(1),
                                          st.kf_time[torch.tensor([kf_id, cand], device=dev)]])),
                          np.float32)
        new_q, new_t, new_s = edge[0:4], edge[4:7], float(edge[7])
        rec["kf_time"], rec["cand_time"] = float(edge[8]), float(edge[9])
        E = LOOP_EDGE_CAP
        h_i = np.zeros(E, np.int64)
        h_j = np.zeros(E, np.int64)
        h_q = np.tile(np.array([1.0, 0, 0, 0], np.float32), (E, 1))
        h_t = np.zeros((E, 3), np.float32)
        h_s = np.ones(E, np.float32)
        h_ok = np.zeros(E, bool)
        for r, (ei, ej, eq, et, es) in enumerate(self._loop_edges[:E]):
            h_i[r], h_j[r], h_q[r], h_t[r], h_s[r], h_ok[r] = ei, ej, eq, et, es, True

        def dev_t(a, dtype=None):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dtype)

        l_i = dev_t(np.concatenate([h_i, [cand]]))
        l_j = dev_t(np.concatenate([h_j, [kf_id]]))
        # the new edge is forced valid: its candidate end joins the graph as
        # the fixed anchor even when culling removed the row after detection
        node_ok = valid.clone()
        node_ok[cand] = True
        l_ok = dev_t(np.concatenate([h_ok, [True]])) & node_ok[l_i] & node_ok[l_j]

        e_i = torch.cat([t_i, c_i, l_i])
        e_j = torch.cat([t_j, c_j, l_j])
        e_ok = torch.cat([t_ok, c_ok, l_ok])
        e_w = torch.cat([w_t, w_c, torch.full((E + 1,), cfg.loop_edge_weight, dtype=F32,
                                               device=dev)])
        # measurements: pre-correction relative poses, except the loop edges'
        # own Sim3 solves (S_ij = S_i^-1 S_j with i=cand, j=cur)
        nodes0 = Sim3(st.kf_q, st.kf_p, torch.ones(K, dtype=F32, device=dev))
        S_i = Sim3(*[a[e_i] for a in nodes0])
        S_j = Sim3(*[a[e_j] for a in nodes0])
        e_meas = S_i.inverse().compose(S_j)
        n_loop = E + 1
        loop_meas = (dev_t(np.concatenate([h_q, new_q[None]])),
                     dev_t(np.concatenate([h_t, new_t[None]])),
                     dev_t(np.concatenate([h_s, [new_s]]).astype(np.float32)))
        e_meas = Sim3(*[torch.cat([a[:-n_loop], v]) for a, v in zip(e_meas, loop_meas)])

        fixed = torch.zeros(K, dtype=torch.bool, device=dev)
        fixed[cand] = True
        fixed = fixed | ~node_ok
        prob = PoseGraphProblem(nodes=nodes, node_valid=node_ok, node_fixed=fixed,
                                e_i=e_i.to(I32), e_j=e_j.to(I32), e_meas=e_meas, e_weight=e_w,
                                e_valid=e_ok)
        lap("graph_setup")
        new_nodes, _costs = solve_pose_graph(prob, iters=cfg.pose_graph_iters)
        lap("pose_graph")

        kf_q = torch.where(node_ok[:, None], quat.normalize(new_nodes.q), st.kf_q)
        kf_p = torch.where(node_ok[:, None], new_nodes.t, st.kf_p)
        # culled same-map rows follow their nearest live temporal ancestor
        # rigidly (16 hops at most)
        anc = prev
        for _ in range(16):
            anc_safe = anc.clamp(0, K - 1)
            settled = (anc < 0) | st.kf_valid[anc_safe]
            anc = torch.where(settled, anc, prev[anc_safe])
        anc_safe = anc.clamp(0, K - 1)
        anc_ok = (anc >= 0) & st.kf_valid[anc_safe]
        dq_anc = quat.normalize(quat.mul(kf_q[anc_safe], quat.conj(st.kf_q[anc_safe])))
        q_trans = quat.normalize(quat.mul(dq_anc, st.kf_q))
        p_trans = quat.rotate(dq_anc, st.kf_p - st.kf_p[anc_safe]) + kf_p[anc_safe]
        move_culled = mapmask & ~st.kf_valid & anc_ok & (idx != cand)
        kf_q = torch.where(move_culled[:, None], q_trans, kf_q)
        kf_p = torch.where(move_culled[:, None], p_trans, kf_p)
        # velocities keep their body-frame value: v_w' = R_new R_old^T v_w
        dq = quat.normalize(quat.mul(kf_q, quat.conj(st.kf_q)))
        moved = (node_ok | move_culled)[:, None]
        kf_v = torch.where(moved, quat.rotate(dq, st.kf_v), st.kf_v)

        # map points: X' = T_new (T_old^-1 X) of their first keyframe
        ref = st.mp_first_kf.long().clamp(0, K - 1)
        q_old, p_old = st.kf_q[ref], st.kf_p[ref]
        X_body = quat.rotate(quat.conj(q_old), st.mp_pos - p_old)
        X_corr = quat.rotate(kf_q[ref], X_body) + kf_p[ref]
        mp_ok = (st.mp_valid & (st.mp_first_kf >= 0))[:, None]
        mp_pos = torch.where(mp_ok, X_corr, st.mp_pos)
        st = st._replace(kf_q=kf_q, kf_p=kf_p, kf_v=kf_v, mp_pos=mp_pos)

        if record:
            self._loop_edges.append((int(cand), int(kf_id), new_q.astype(np.float32),
                                     new_t.astype(np.float32), new_s))
            self._loop_edges = self._loop_edges[-LOOP_EDGE_CAP:]
        lap("apply_correction")

        # duplicate fusion across the welded seam, with tighter gates than
        # in-window fusion (the geometry still carries residual drift)
        st = fuse_across_seam(st, torch.tensor(kf_id, dtype=I32, device=dev),
                              torch.tensor(cand, dtype=I32, device=dev), cam,
                              radius=2.5, max_hamming=40)
        lap("seam_fusion")

        # how far the correction moved the current keyframe; read with the
        # anchor's validity (GBA's gauge anchor must be a live keyframe)
        seam_m, anchor_ok = read(torch.stack([
            torch.linalg.norm(kf_p[kf_id] - nodes0.t[kf_id]),
            st.kf_valid[cand].to(F32)]))
        rec["seam_m"] = seam_m
        heavy = seam_m >= cfg.heavy_repair_min_seam or not record
        lap("seam_read")
        rec["gba"] = None
        if cfg.run_global_ba and heavy:
            anchor = int(cand)
            if not anchor_ok:
                alive = np.nonzero(np.asarray(read(valid)))[0]
                anchor = int(alive[0]) if len(alive) else anchor
            st, rec["gba"] = self._global_ba(st, anchor, cam)
            lap("gba")
        rec["vi_refine"] = None
        if cfg.run_vi_refine and self.gravity_w is not None:
            st, rec["vi_refine"] = self._vi_refine(st, kf_id, cam, read)
            lap("vi_refine")
        rec["correct_ms"] = (self._clock("correct", t_start) - t_start) * 1e3
        self.corrections.append(rec)
        return st

    def _vi_refine(self, st: MapState, kf_id: int, cam: Camera, read):
        """Inertial smoothing of the recent temporal chain after a
        correction: 15-dof states with IMU, bias-walk and visual edges over
        the last vi_refine_window keyframes, anchored at the oldest end. The
        result is rejected if a rock-solid keyframe (>= 100 insert-time
        inliers) moved more than 1 m. Returns (MapState, accepted)."""
        from orbslam3_tpu_torch.models.local_mapper import apply_vi_ba_results, build_vi_ba_problem
        from orbslam3_tpu_torch.optim.vi_ba import solve_vi_ba

        cfg = self.cfg
        dev = st.kf_q.device
        gravity = torch.as_tensor(self.gravity_w, dtype=F32).to(dev)
        prob, ids, valid_w, pt_ids, pt_valid = build_vi_ba_problem(
            st, torch.tensor(kf_id, dtype=I32, device=dev), cfg.vi_refine_window,
            cfg.vi_refine_points, gravity, cfg.vi_refine_fixed)
        res = solve_vi_ba(prob, cam, iters=cfg.vi_refine_iters)
        vw = valid_w & prob.opt_cam
        W = ids.shape[0]
        inl = st.kf_inliers[ids.long().clamp(min=0)]
        tab = np.asarray(read(torch.cat([
            vw.to(torch.float64), inl.to(torch.float64),
            res.p.to(torch.float64).reshape(-1), prob.p.to(torch.float64).reshape(-1),
            torch.stack([res.cost0, res.cost1]).to(torch.float64)])))
        vw_h = tab[:W] > 0
        healthy = tab[W:2 * W] >= 100
        p_new = tab[2 * W:5 * W].reshape(W, 3).astype(np.float32)
        p_old = tab[5 * W:8 * W].reshape(W, 3).astype(np.float32)
        cost0, cost1 = tab[8 * W:]
        mask = vw_h & healthy
        move = np.linalg.norm(p_new - p_old, axis=1)
        if mask.any() and float(move[mask].max()) > 1.0:
            self._log.info("vi_refine rejected: healthy keyframes moved too far (max %.2f m)",
                           float(move[mask].max()))
            return st, False
        weak = vw_h & ~healthy
        self._log.info("vi_refine accepted: healthy max %.3f m, weak max %.3f m, cost %.3g -> %.3g",
                       float(move[mask].max()) if mask.any() else 0.0,
                       float(move[weak].max()) if weak.any() else 0.0, cost0, cost1)
        kf_q, kf_p, kf_v, kf_bg, kf_ba, mp_pos = apply_vi_ba_results(
            st, ids, vw, res.q, res.p, res.v, res.bg, res.ba, pt_ids, pt_valid, res.Xw)
        return st._replace(kf_q=kf_q, kf_p=kf_p, kf_v=kf_v, kf_bg=kf_bg, kf_ba=kf_ba,
                           mp_pos=mp_pos), True

    def _global_ba(self, st: MapState, anchor_kf: int, cam: Camera):
        """Whole-map BA after a correction. The table holds the smaller of
        the budget and the map's capacity. With a torch.distributed default
        group of W > 1 ranks (every rank running this closer on the same
        map) the points are split over the ranks (`distributed_global_ba`),
        the table padded to a multiple of W tiles of at most gba_tile points
        as the JAX package sizes it for W devices; otherwise the solve runs
        on the map's device (`global_ba`, the JAX sizing at one device).
        Returns (MapState, record): the table's slots, tiles and iterations,
        the ranks, and the points it holds (a device scalar: the correction
        reads nothing for it)."""
        import torch.distributed as dist

        from orbslam3_tpu_torch.parallel.distributed_ba import (
            distributed_global_ba,
            global_ba,
            make_point_table,
        )

        cfg = self.cfg
        n_dev = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
        M = st.mp_pos.shape[0]
        want = max(min(cfg.gba_max_points, M), 1)
        tile = max(min(cfg.gba_tile, -(-want // n_dev)), 1)
        unit = n_dev * tile
        P = -(-want // unit) * unit
        pts, ids = make_point_table(st, P, cfg.gba_obs)
        K = st.kf_valid.shape[0]
        opt = st.kf_valid & (torch.arange(K, device=st.kf_q.device) != anchor_kf)
        solve = distributed_global_ba if n_dev > 1 else global_ba
        q, p, Xw = solve(pts, st.kf_q, st.kf_p, opt, cam, iters=cfg.gba_iters, tile=tile)
        mp_pos = scatter_set(st.mp_pos, ids, Xw, valid=ids >= 0)
        # body-frame velocities under the refined orientations
        dq = quat.normalize(quat.mul(q, quat.conj(st.kf_q)))
        kf_v = torch.where(opt[:, None], quat.rotate(dq, st.kf_v), st.kf_v)
        return (st._replace(kf_q=q, kf_p=p, kf_v=kf_v, mp_pos=mp_pos),
                dict(slots=P, tiles=P // tile, iters=cfg.gba_iters, ranks=n_dev,
                     points=pts.pt_valid.sum()))
