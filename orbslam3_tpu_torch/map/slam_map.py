"""Structure-of-arrays map state and its mutation ops.

Port of the parts of orbslam3_tpu/map/slam_map.py the stereo and
stereo-inertial paths run (compaction, eviction and drop_map are not here).
Ids are row indices; `MapState` has the JAX package's field names, shapes
and dtypes, so the two can be compared field by field.

Functions are pure: each returns a new MapState and never writes into its
input's tensors (unchanged fields are shared).

Index semantics follow XLA's, explicitly, so no dynamic index can raise or
trip a device assert:
* gathers clamp their indices;
* scatters go through `scatter_set`/`index_add_`: masked or out-of-range
  lanes are dropped, and among lanes that write the same row the last one
  wins (XLA:CPU's order) — no write races on the card;
* duplicate-index additions use `index_add_`.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from orbslam3_tpu_torch.geometry import quat
from orbslam3_tpu_torch.imu.preintegration import PreintState
from orbslam3_tpu_torch.ops.fast import topk_stable

I32 = torch.int32
F32 = torch.float32


class MapCapacity(NamedTuple):
    max_kf: int = 256  # K
    n_feat: int = 1024  # N features per keyframe
    max_mp: int = 32768  # M
    max_obs: int = 16  # O observations tracked per map point


class MapState(NamedTuple):
    # --- keyframes (K rows)
    kf_q: torch.Tensor  # (K, 4) body->world rotation
    kf_p: torch.Tensor  # (K, 3) body position in world
    kf_v: torch.Tensor  # (K, 3) velocity
    kf_bg: torch.Tensor  # (K, 3) gyro bias
    kf_ba: torch.Tensor  # (K, 3) accel bias
    kf_time: torch.Tensor  # (K,)
    kf_valid: torch.Tensor  # (K,) bool
    kf_map_id: torch.Tensor  # (K,) int32 atlas map id
    kf_prev: torch.Tensor  # (K,) int32 temporal predecessor (-1 none)
    kf_inliers: torch.Tensor  # (K,) int32 pose-solve inliers at insert
    kf_uv: torch.Tensor  # (K, N, 2)
    kf_ur: torch.Tensor  # (K, N) right-image u (-1 = mono)
    kf_depth: torch.Tensor  # (K, N) stereo depth (-1 = none)
    kf_octave: torch.Tensor  # (K, N) int32
    kf_desc: torch.Tensor  # (K, N, 32) uint8
    kf_mp: torch.Tensor  # (K, N) int32 map point id (-1 = none)
    kf_feat_valid: torch.Tensor  # (K, N) bool
    kf_preint: PreintState  # batched (K, ...) preintegration kf_prev -> kf
    # --- map points (M rows)
    mp_pos: torch.Tensor  # (M, 3)
    mp_desc: torch.Tensor  # (M, 32) uint8
    mp_normal: torch.Tensor  # (M, 3) mean viewing direction
    mp_min_dist: torch.Tensor  # (M,)
    mp_max_dist: torch.Tensor  # (M,)
    mp_valid: torch.Tensor  # (M,) bool
    mp_map_id: torch.Tensor  # (M,) int32
    mp_first_kf: torch.Tensor  # (M,) int32
    mp_visible: torch.Tensor  # (M,) int32 frustum-visibility counter
    mp_found: torch.Tensor  # (M,) int32 tracking-inlier counter
    mp_obs_kf: torch.Tensor  # (M, O) int32 (-1 empty)
    mp_obs_feat: torch.Tensor  # (M, O) int32
    mp_obs_n: torch.Tensor  # (M,) int32
    # --- covisibility (K, K) shared-observation counts
    covis: torch.Tensor  # (K, K) int32
    # --- counters (0-d device tensors)
    n_kf: torch.Tensor
    n_mp: torch.Tensor
    active_map: torch.Tensor
    next_map_id: torch.Tensor
    n_obs_dropped: torch.Tensor


def empty_map(cap: MapCapacity = MapCapacity(), device=None) -> MapState:
    K, N, M, O = cap.max_kf, cap.n_feat, cap.max_mp, cap.max_obs

    def z(*shape, dtype=F32):
        return torch.zeros(shape, dtype=dtype, device=device)

    def full(shape, v, dtype):
        return torch.full(shape, v, dtype=dtype, device=device)

    def quat_rows():
        q = z(K, 4)
        q[:, 0] = 1.0
        return q

    preint = PreintState(
        dq=quat_rows(), dv=z(K, 3), dp=z(K, 3), dt=z(K), cov=z(K, 15, 15),
        J_r_bg=z(K, 3, 3), J_v_bg=z(K, 3, 3), J_v_ba=z(K, 3, 3), J_p_bg=z(K, 3, 3),
        J_p_ba=z(K, 3, 3), bias_g=z(K, 3), bias_a=z(K, 3),
    )
    return MapState(
        kf_q=quat_rows(), kf_p=z(K, 3), kf_v=z(K, 3), kf_bg=z(K, 3), kf_ba=z(K, 3),
        kf_time=z(K), kf_valid=z(K, dtype=torch.bool), kf_map_id=full((K,), -1, I32),
        kf_prev=full((K,), -1, I32), kf_inliers=z(K, dtype=I32), kf_uv=z(K, N, 2),
        kf_ur=full((K, N), -1.0, F32), kf_depth=full((K, N), -1.0, F32),
        kf_octave=z(K, N, dtype=I32), kf_desc=z(K, N, 32, dtype=torch.uint8),
        kf_mp=full((K, N), -1, I32), kf_feat_valid=z(K, N, dtype=torch.bool),
        kf_preint=preint,
        mp_pos=z(M, 3), mp_desc=z(M, 32, dtype=torch.uint8), mp_normal=z(M, 3),
        mp_min_dist=z(M), mp_max_dist=z(M), mp_valid=z(M, dtype=torch.bool),
        mp_map_id=full((M,), -1, I32), mp_first_kf=full((M,), -1, I32),
        mp_visible=full((M,), 1, I32), mp_found=full((M,), 1, I32),
        mp_obs_kf=full((M, O), -1, I32), mp_obs_feat=full((M, O), -1, I32),
        mp_obs_n=z(M, dtype=I32), covis=z(K, K, dtype=I32),
        n_kf=z(dtype=I32), n_mp=z(dtype=I32), active_map=z(dtype=I32),
        next_map_id=full((), 1, I32), n_obs_dropped=z(dtype=I32),
    )


# ---------------------------------------------------------------- helpers
def scatter_set(arr, idx, vals, valid=None):
    """Copy of `arr` with arr[idx[i]] = vals[i] along dim 0, XLA semantics:
    lanes with valid False or idx outside [0, len) are dropped, and where
    several lanes hit one row the last lane wins."""
    n = arr.shape[0]
    idx = idx.long()
    ok = (idx >= 0) & (idx < n)
    if valid is not None:
        ok = ok & valid
    safe = idx.clamp(0, n - 1)
    lane = torch.arange(idx.shape[0], device=idx.device)
    last = torch.full((n,), -1, dtype=torch.long, device=idx.device)
    last = last.scatter_reduce(0, safe, torch.where(ok, lane, torch.full_like(lane, -1)), "amax")
    keep = ok & (last[safe] == lane)
    # dropped lanes all write one spare row past the end, cut off afterwards
    out = torch.cat([arr, arr[:1]])
    out[torch.where(keep, safe, torch.full_like(safe, n))] = vals.to(arr.dtype)
    return out[:n]


def set_row(arr, k, val):
    """Copy of `arr` with row k (0-d tensor, clamped) replaced by val."""
    kk = k.long().clamp(0, arr.shape[0] - 1).reshape(1)
    return arr.index_copy(0, kk, val.to(arr.dtype).unsqueeze(0))


def add_at(arr, idx, vals):
    """Copy of `arr` with vals added at idx (duplicates accumulate)."""
    return arr.index_add(0, idx.long(), vals.to(arr.dtype))


def _scatter_add_covis(covis, kf_id, other_kfs, valid):
    """covis[kf_id, other] += 1 and symmetric, for masked `other_kfs`."""
    K = covis.shape[0]
    others = torch.where(valid, other_kfs, torch.zeros_like(other_kfs))
    row = add_at(torch.zeros(K, dtype=I32, device=covis.device), others, valid.to(I32))
    kk = kf_id.long().clamp(0, K - 1)
    row = row.index_fill(0, kk.reshape(1), 0)
    covis = covis.index_add(0, kk.reshape(1), row[None])
    return covis.index_add(1, kk.reshape(1), row[:, None])


def associate_batch(st: MapState, kf_id, feat_idx, mp_idx, valid):
    """Associate features of one keyframe with map points (batched).

    kf_id () int; feat_idx, mp_idx, valid (B,). Masked lanes are dropped."""
    M, O = st.mp_obs_kf.shape
    K = st.kf_mp.shape[0]
    kk = kf_id.long().clamp(0, K - 1)
    m_safe = torch.where(valid, mp_idx, torch.zeros_like(mp_idx)).long().clamp(0, M - 1)

    # 1. kf_mp[kf, feat] = mp
    row = scatter_set(st.kf_mp[kk], feat_idx, mp_idx, valid)
    kf_mp = set_row(st.kf_mp, kf_id, row)

    # 2. covisibility: +1 with every current observer of each mp
    obs_kfs = st.mp_obs_kf[m_safe]  # (B, O)
    obs_valid = (obs_kfs >= 0) & valid[:, None]
    covis = _scatter_add_covis(st.covis, kf_id, obs_kfs.reshape(-1), obs_valid.reshape(-1))

    # 3. append to obs lists at the first free slot (dropped if full)
    holes = obs_kfs < 0
    has_hole = holes.any(dim=1)
    slot = torch.argmax(holes.to(I32), dim=1)
    can = valid & has_hole
    flat = m_safe * O + slot
    kf_col = torch.full_like(mp_idx, 0) + kf_id.to(mp_idx.dtype)
    mp_obs_kf = scatter_set(st.mp_obs_kf.reshape(-1), flat, kf_col, can).reshape(M, O)
    mp_obs_feat = scatter_set(st.mp_obs_feat.reshape(-1), flat, feat_idx, can).reshape(M, O)
    mp_obs_n = add_at(st.mp_obs_n, m_safe, can.to(I32))
    dropped = torch.sum(valid & ~has_hole, dtype=I32)
    return st._replace(kf_mp=kf_mp, covis=covis, mp_obs_kf=mp_obs_kf,
                       mp_obs_feat=mp_obs_feat, mp_obs_n=mp_obs_n,
                       n_obs_dropped=st.n_obs_dropped + dropped)


def _spawn_rows(st: MapState, ids_safe, ok, pos, desc, normal, min_d, max_d, kf_id):
    """Write new map-point rows (the JAX package's `scat`: every lane
    writes, masked lanes their row's current value)."""

    def scat(arr, vals):
        old = arr[ids_safe]
        m = ok.reshape(ok.shape + (1,) * (vals.dim() - 1))
        return scatter_set(arr, ids_safe, torch.where(m, vals.to(arr.dtype), old))

    ones = torch.ones_like(ids_safe, dtype=I32)
    return st._replace(
        mp_pos=scat(st.mp_pos, pos),
        mp_desc=scat(st.mp_desc, desc),
        mp_normal=scat(st.mp_normal, normal),
        mp_min_dist=scat(st.mp_min_dist, min_d),
        mp_max_dist=scat(st.mp_max_dist, max_d),
        mp_valid=scat(st.mp_valid, ok),
        mp_map_id=scat(st.mp_map_id, ones * st.active_map),
        mp_first_kf=scat(st.mp_first_kf, ones * kf_id.to(I32)),
        mp_visible=scat(st.mp_visible, ones),
        mp_found=scat(st.mp_found, ones),
        n_mp=st.n_mp + torch.sum(ok, dtype=I32),
    )


def insert_keyframe(st: MapState, time, q_wb, p_w, vel, bias_g, bias_a, uv, u_right,
                    depth, octave, desc, points_body, feat_valid, matched_mp,
                    preint: PreintState, prev_kf, new_mp_budget: int = 384):
    """Insert a keyframe row at n_kf (the caller checks n_kf < K); associate
    tracked matches; spawn map points from unmatched stereo features,
    closest first, up to new_mp_budget. Returns (MapState, kf_id)."""
    N = uv.shape[0]
    dev = uv.device
    k = st.n_kf.clone()
    t = torch.as_tensor(time, dtype=F32, device=dev)
    st = st._replace(
        kf_q=set_row(st.kf_q, k, q_wb), kf_p=set_row(st.kf_p, k, p_w),
        kf_v=set_row(st.kf_v, k, vel), kf_bg=set_row(st.kf_bg, k, bias_g),
        kf_ba=set_row(st.kf_ba, k, bias_a), kf_time=set_row(st.kf_time, k, t),
        kf_valid=set_row(st.kf_valid, k, torch.ones((), dtype=torch.bool, device=dev)),
        kf_map_id=set_row(st.kf_map_id, k, st.active_map),
        kf_prev=set_row(st.kf_prev, k, torch.as_tensor(prev_kf, device=dev)),
        kf_uv=set_row(st.kf_uv, k, uv), kf_ur=set_row(st.kf_ur, k, u_right),
        kf_depth=set_row(st.kf_depth, k, depth), kf_octave=set_row(st.kf_octave, k, octave),
        kf_desc=set_row(st.kf_desc, k, desc), kf_feat_valid=set_row(st.kf_feat_valid, k, feat_valid),
        kf_preint=PreintState(*[set_row(a, k, v) for a, v in zip(st.kf_preint, preint)]),
        n_kf=st.n_kf + 1,
    )

    # 1. associate features the tracker already matched to existing MPs
    feat_all = torch.arange(N, device=dev, dtype=I32)
    st = associate_batch(st, k, feat_all, matched_mp, feat_valid & (matched_mp >= 0))

    # 2. spawn new map points from unmatched stereo features, near first
    can_new = feat_valid & (matched_mp < 0) & (depth > 0)
    prio = torch.where(can_new, -depth, torch.full_like(depth, float("-inf")))
    _, sel = topk_stable(prio, min(new_mp_budget, N))
    sel_ok = can_new[sel]
    M = st.mp_pos.shape[0]
    new_ids = st.n_mp + torch.cumsum(sel_ok.to(I32), 0, dtype=I32) - 1
    sel_ok = sel_ok & (new_ids < M)
    ids_safe = torch.where(sel_ok, new_ids, torch.zeros_like(new_ids))

    pw = quat.rotate(q_wb[None], points_body[sel]) + p_w[None]
    view = pw - p_w[None]
    dist = torch.linalg.norm(view, dim=-1).clamp(min=1e-6)
    normal = view / dist[:, None]
    from orbslam3_tpu_torch.frontend.stereo import pow12

    max_d = dist * pow12(octave[sel])
    min_d = max_d / (1.2 ** 7)
    st = _spawn_rows(st, ids_safe, sel_ok, pw, desc[sel], normal, min_d, max_d, k)
    st = associate_batch(st, k, sel.to(I32), ids_safe, sel_ok)
    return st, k


def cull_map_points(st: MapState, min_obs: int = 2, min_found_ratio: float = 0.25,
                    grace_kfs: int = 2):
    """Invalidate weak map points and disassociate them everywhere: a point
    older than grace_kfs keyframes needs >= min_obs observations and
    found/visible >= min_found_ratio."""
    age = st.n_kf - 1 - st.mp_first_kf
    ratio = st.mp_found.to(F32) / torch.clamp(st.mp_visible.to(F32), min=1.0)
    bad = st.mp_valid & (age >= grace_kfs) & ((st.mp_obs_n < min_obs) | (ratio < min_found_ratio))
    return _remove_map_points(st, bad)


def _remove_map_points(st: MapState, bad_mask, max_cull: int = 4096):
    """Mask off map points: clear kf_mp references, obs lists, covisibility
    (exact decrements for up to max_cull points per pass)."""
    M, O = st.mp_obs_kf.shape
    K = st.covis.shape[0]
    dev = bad_mask.device
    max_cull = min(max_cull, M)
    _, cull_ids = topk_stable(bad_mask.to(F32), max_cull)
    cull_ok = bad_mask[cull_ids]
    bad_mask = add_at(torch.zeros(M, dtype=I32, device=dev),
                      torch.where(cull_ok, cull_ids, torch.zeros_like(cull_ids)),
                      cull_ok.to(I32)) > 0

    ref = st.kf_mp
    ref_bad = (ref >= 0) & bad_mask[ref.long().clamp(0, M - 1)]
    kf_mp = torch.where(ref_bad, torch.full_like(ref, -1), ref)

    obs = st.mp_obs_kf[cull_ids]  # (C, O)
    obs_ok = (obs >= 0) & cull_ok[:, None]
    obs_safe = torch.where(obs_ok, obs, torch.zeros_like(obs)).long()
    C = cull_ids.shape[0]
    # H[c, k] = 1 iff culled point c is observed by keyframe k; H^T H counts,
    # per keyframe pair, the shared observations lost (exact in float32)
    Hm = torch.zeros((C, K), dtype=F32, device=dev)
    rows = torch.arange(C, device=dev)[:, None].expand(C, O)
    Hm = Hm.index_put((rows.reshape(-1), obs_safe.reshape(-1)), obs_ok.reshape(-1).to(F32),
                      accumulate=True)
    D = (Hm.T @ Hm).to(I32)
    D = D - torch.diag(torch.diagonal(D))
    covis = st.covis - D

    neg = torch.full_like(st.mp_obs_kf, -1)
    return st._replace(
        kf_mp=kf_mp, covis=covis, mp_valid=st.mp_valid & ~bad_mask,
        mp_obs_kf=torch.where(bad_mask[:, None], neg, st.mp_obs_kf),
        mp_obs_feat=torch.where(bad_mask[:, None], neg, st.mp_obs_feat),
        mp_obs_n=torch.where(bad_mask, torch.zeros_like(st.mp_obs_n), st.mp_obs_n),
    )


def local_window(st: MapState, kf_id, window: int):
    """Top-`window` covisible keyframes of kf_id (kf_id itself first).
    Returns (ids (window,), valid (window,))."""
    K = st.kf_valid.shape[0]
    kk = kf_id.long().clamp(0, K - 1)
    weights = (st.covis[kk] * st.kf_valid.to(I32)
               * (st.kf_map_id == st.kf_map_id[kk]).to(I32))
    weights = weights.index_fill(0, kk.reshape(1), 0)
    k_eff = min(window - 1, K)
    w, ids = topk_stable(weights, k_eff)
    pad = window - 1 - k_eff
    if pad:
        ids = torch.nn.functional.pad(ids, (0, pad))
        w = torch.nn.functional.pad(w, (0, pad))
    ids = torch.cat([kk.reshape(1), ids]).to(I32)
    valid = torch.cat([torch.ones(1, dtype=torch.bool, device=w.device), w > 0])
    return ids, valid


def local_window_temporal(st: MapState, kf_id, window: int, n_temporal: int):
    """Like local_window, but the first `n_temporal` neighbour slots are the
    kf_prev temporal-chain predecessors, the rest the covisibility top-k
    with the chain's rows masked out (no duplicates)."""
    n_temporal = min(n_temporal, window - 1)
    if n_temporal <= 0:
        return local_window(st, kf_id, window)
    K = st.kf_valid.shape[0]
    dev = st.kf_valid.device
    kk = kf_id.long().clamp(0, K - 1)
    same_map = st.kf_map_id == st.kf_map_id[kk]

    chain = []
    c = kf_id.to(I32)
    for _ in range(n_temporal):
        c = torch.where(c >= 0, st.kf_prev[c.long().clamp(0, K - 1)], torch.full_like(c, -1))
        chain.append(c)
    chain = torch.stack(chain)
    chain_safe = chain.long().clamp(0, K - 1)
    chain_ok = ((chain >= 0) & st.kf_valid[chain_safe] & same_map[chain_safe]
                & (chain != kf_id))
    # order-free scatter-max
    in_chain = torch.zeros(K, dtype=I32, device=dev).scatter_reduce(
        0, chain_safe, chain_ok.to(I32), "amax") > 0

    weights = st.covis[kk] * st.kf_valid.to(I32) * same_map.to(I32)
    weights = weights.index_fill(0, kk.reshape(1), 0)
    weights = torch.where(in_chain, torch.zeros_like(weights), weights)
    k_eff = max(min(window - 1 - n_temporal, K), 0)
    w, ids = topk_stable(weights, k_eff)
    pad = window - 1 - n_temporal - k_eff
    if pad:
        ids = torch.nn.functional.pad(ids, (0, pad))
        w = torch.nn.functional.pad(w, (0, pad))
    ids = torch.cat([kf_id.reshape(1).to(I32), chain_safe.to(I32), ids.to(I32)])
    valid = torch.cat([torch.ones(1, dtype=torch.bool, device=dev), chain_ok, w > 0])
    return ids, valid


def mp_slots_for_kfs(st: MapState, kf_ids, kf_valid, max_points: int):
    """Distinct map points observed by a set of keyframes:
    (mp_ids (P,), valid (P,)) with P = max_points, padded."""
    K = st.kf_mp.shape[0]
    M = st.mp_pos.shape[0]
    refs = st.kf_mp[kf_ids.long().clamp(0, K - 1)]  # (W, N)
    ok = (refs >= 0) & kf_valid[:, None]
    refs_safe = torch.where(ok, refs, torch.zeros_like(refs))
    seen = add_at(torch.zeros(M, dtype=I32, device=refs.device), refs_safe.reshape(-1),
                  ok.reshape(-1).to(I32)) > 0
    seen = seen & st.mp_valid
    v, ids = topk_stable(seen.to(F32), max_points)
    return ids.to(I32), v > 0


# ---------------------------------------------------------------- atlas ops
def reset_active_map(st: MapState):
    """Invalidate every keyframe/point of the active map."""
    kf_bad = st.kf_valid & (st.kf_map_id == st.active_map)
    mp_bad = st.mp_valid & (st.mp_map_id == st.active_map)
    covis = torch.where(kf_bad[:, None] | kf_bad[None, :], torch.zeros_like(st.covis), st.covis)
    neg = torch.full_like(st.mp_obs_kf, -1)
    return st._replace(
        kf_valid=st.kf_valid & ~kf_bad, mp_valid=st.mp_valid & ~mp_bad,
        mp_obs_kf=torch.where(mp_bad[:, None], neg, st.mp_obs_kf),
        mp_obs_feat=torch.where(mp_bad[:, None], neg, st.mp_obs_feat),
        mp_obs_n=torch.where(mp_bad, torch.zeros_like(st.mp_obs_n), st.mp_obs_n),
        kf_mp=torch.where(kf_bad[:, None], torch.full_like(st.kf_mp, -1), st.kf_mp),
        covis=covis,
    )


def create_new_map(st: MapState):
    """Archive the active map and start a fresh one."""
    return st._replace(active_map=st.next_map_id.clone(), next_map_id=st.next_map_id + 1)


def count_map_keyframes(st: MapState, map_id):
    return torch.sum(st.kf_valid & (st.kf_map_id == map_id), dtype=I32)


def spawn_map_points(st: MapState, kf_id, feat_idx, Xw, valid):
    """Allocate new map points at world positions Xw for features of kf_id.

    feat_idx, Xw, valid are (B,) aligned; returns (MapState, new_ids (B,),
    -1 where no point was made)."""
    from orbslam3_tpu_torch.frontend.stereo import pow12

    M = st.mp_pos.shape[0]
    K = st.kf_valid.shape[0]
    kk = kf_id.long().clamp(0, K - 1)
    new_ids = st.n_mp + torch.cumsum(valid.to(I32), 0, dtype=I32) - 1
    valid = valid & (new_ids < M)
    ids_safe = torch.where(valid, new_ids, torch.zeros_like(new_ids))
    f_safe = torch.where(valid, feat_idx, torch.zeros_like(feat_idx)).long()

    view = Xw - st.kf_p[kk][None]
    dist = torch.linalg.norm(view, dim=-1).clamp(min=1e-6)
    normal = view / dist[:, None]
    max_d = dist * pow12(st.kf_octave[kk][f_safe])
    min_d = max_d / (1.2 ** 7)
    st = _spawn_rows(st, ids_safe, valid, Xw, st.kf_desc[kk][f_safe], normal, min_d, max_d, kf_id)
    st = associate_batch(st, kf_id, f_safe.to(I32), ids_safe, valid)
    return st, torch.where(valid, ids_safe, torch.full_like(ids_safe, -1))
