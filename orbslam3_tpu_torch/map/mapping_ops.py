"""Local-mapping map maintenance: duplicate fusion, point statistics and
keyframe culling.

Port of orbslam3_tpu/map/mapping_ops.py:

* fuse_map_points / fuse_across_seam: project a keyframe's map points into
  each neighbour, dense (N x N) pixel + Hamming gating; duplicate pairs keep
  the more-observed point, free neighbour features gain an observation of
  the surviving point;
* update_point_stats: medoid descriptor, viewing normal and depth bounds of
  every point the keyframe observes;
* keyframe_redundancy, select_cull_candidate, select_pressure_evict_kf,
  remove_keyframe: redundancy keyframe culling with the IMU preintegration
  merged into the successor over the gap.

The JAX module's `.at[].max` / `.at[].min` scatters are order-free
scatter-reduces here; its drop-mode scatters go through `scatter_set`.
"""
from __future__ import annotations

import torch

from orbslam3_tpu_torch.frontend.camera import Camera
from orbslam3_tpu_torch.frontend.stereo import pow12
from orbslam3_tpu_torch.geometry import quat
from orbslam3_tpu_torch.imu import preintegration as pre
from orbslam3_tpu_torch.map.slam_map import (MapState, _remove_map_points, associate_batch,
                                             local_window, local_window_temporal, scatter_set,
                                             set_row)
from orbslam3_tpu_torch.ops.fast import topk_stable
from orbslam3_tpu_torch.ops.hamming import hamming_matrix

I32 = torch.int32
F32 = torch.float32


def _any_at(n: int, idx, flag):
    """(n,) bool: True at every idx[i] whose flag[i] is set (order-free)."""
    out = torch.zeros(n, dtype=I32, device=idx.device)
    return out.scatter_reduce(0, idx.long(), flag.to(I32), "amax") > 0


def fuse_map_points(st: MapState, kf_id, cam: Camera, window: int = 6, radius: float = 4.0,
                    max_hamming: int = 50, n_temporal: int = 2):
    """Fuse duplicate map points between kf_id and its neighbours: temporal
    chain first, then covisibility top-k. Returns the updated MapState."""
    ids, valid_w = local_window_temporal(st, kf_id, window, n_temporal)
    return _fuse_with_neighbors(st, kf_id, ids, valid_w, cam, radius, max_hamming)


def fuse_across_seam(st: MapState, kf_id, other_kf, cam: Camera, radius: float = 4.0,
                     max_hamming: int = 50):
    """Duplicate fusion across a loop-correction seam: fuse kf_id's points
    into `other_kf` and its covisible window, and other_kf's points back into
    kf_id's window (the welded regions overlap in space but share no
    covisibility yet)."""
    one = torch.ones(1, dtype=torch.bool, device=st.kf_valid.device)

    def other_window(center):
        ids, ok = local_window(st, center, 5)
        # the self slot holds the far end of the seam
        return torch.cat([center.reshape(1).to(I32), ids[1:]]), ok

    ids_b, ok_b = other_window(other_kf)
    st = _fuse_with_neighbors(st, kf_id, torch.cat([kf_id.reshape(1).to(I32), ids_b]),
                              torch.cat([one, ok_b]), cam, radius, max_hamming)
    ids_a, ok_a = other_window(kf_id)
    return _fuse_with_neighbors(st, other_kf, torch.cat([other_kf.reshape(1).to(I32), ids_a]),
                                torch.cat([one, ok_a]), cam, radius, max_hamming)


def _fuse_with_neighbors(st: MapState, kf_id, ids, valid_w, cam: Camera, radius, max_hamming):
    """Core fusion: project kf_id's points into the neighbours ids[1:]."""
    M = st.mp_pos.shape[0]
    K, N = st.kf_mp.shape
    dev = st.kf_valid.device
    window = ids.shape[0]
    kk = kf_id.long().clamp(0, K - 1)

    cur_mp = st.kf_mp[kk]  # (N,)
    cur_ok = (cur_mp >= 0) & st.kf_feat_valid[kk]
    cur_mp_safe = cur_mp.clamp(0, M - 1)
    cur_rows = cur_mp_safe.long()
    X = st.mp_pos[cur_rows]  # (N, 3)
    desc_mp = st.mp_desc[cur_rows]
    obs_n = st.mp_obs_n

    kills = torch.zeros(M, dtype=torch.bool, device=dev)
    assoc = []  # per neighbour (n_id, feature, surviving point, wanted), applied after removals
    BIG = 1e6
    for w in range(1, window):
        n_id = ids[w]
        nn = n_id.long().clamp(0, K - 1)
        qn, pn = cam.body_to_cam_pose(st.kf_q[nn], st.kf_p[nn])
        xc = quat.rotate(quat.conj(qn)[None], X - pn[None])
        proj = cam.project(xc)
        in_view = (xc[:, 2] > 0.2) & cam.in_view(proj, 5.0)

        duv = torch.linalg.norm(proj[:, None] - st.kf_uv[nn][None], dim=-1)  # (N, N)
        dd = hamming_matrix(desc_mp, st.kf_desc[nn]).to(F32)
        rad = radius * pow12(st.kf_octave[nn])  # (N,)
        ok = (cur_ok[:, None] & in_view[:, None] & st.kf_feat_valid[nn][None, :]
              & (duv <= rad[None, :]) & (dd <= max_hamming) & valid_w[w])
        cost = torch.where(ok, dd, torch.full_like(dd, BIG))
        j_best = torch.argmin(cost, dim=1)  # neighbour feature per current point
        matched = torch.gather(cost, 1, j_best[:, None])[:, 0] < BIG

        nb_mp = st.kf_mp[nn][j_best]  # the neighbour's point at that feature
        dup = matched & (nb_mp >= 0) & (nb_mp != cur_mp)
        nb_safe = nb_mp.clamp(0, M - 1)
        # keep the more-observed point
        keep_cur = obs_n[cur_rows] >= obs_n[nb_safe.long()]
        kill_id = torch.where(keep_cur, nb_safe, cur_mp_safe)
        keep_id = torch.where(keep_cur, cur_mp_safe, nb_safe)
        kills = kills | _any_at(M, torch.where(dup, kill_id, torch.zeros_like(kill_id)), dup)
        # a free neighbour feature takes the surviving / current point
        assoc.append((n_id, j_best, keep_id, matched & ((nb_mp < 0) | dup)))

    # never kill a point a pending association wants to keep
    for _, _, mp_a, ok_a in assoc:
        kills = kills & ~_any_at(M, torch.where(ok_a, mp_a, torch.zeros_like(mp_a)), ok_a)

    st = _remove_map_points(st, kills & st.mp_valid)

    order = torch.arange(N, dtype=I32, device=dev)
    for n_id, feat, mp_a, ok_a in assoc:
        nn = n_id.long().clamp(0, K - 1)
        # only features left unassigned after the removal; the target must be alive
        ok_all = ok_a & (st.kf_mp[nn][feat] < 0) & st.mp_valid[mp_a.long()]
        # one claim per feature slot within this batch: the lowest current index
        claim = torch.full((N,), 2**30, dtype=I32, device=dev).scatter_reduce(
            0, torch.where(ok_all, feat, torch.zeros_like(feat)),
            torch.where(ok_all, order, torch.full_like(order, 2**30)), "amin")
        ok_first = ok_all & (claim[feat] == order)
        st = associate_batch(st, n_id, feat.to(I32), mp_a, ok_first)
    return st


def update_point_stats(st: MapState, kf_id):
    """Refresh medoid descriptor, viewing normal and depth bounds of every
    map point observed by kf_id, in one masked batched pass: the descriptor
    is the observation minimizing the maximum Hamming distance to the
    others; the normal is the normalized sum of unit view rays from the
    observers' body centres; the depth bounds are [min / 1.2^7, max * 1.2^7]."""
    K, N = st.kf_mp.shape
    O = st.mp_obs_kf.shape[1]
    dev = st.kf_valid.device
    kk = kf_id.long().clamp(0, K - 1)
    refs = st.kf_mp[kk]  # (N,)
    ok = (refs >= 0) & st.kf_feat_valid[kk]
    mp = torch.where(ok, refs, torch.zeros_like(refs)).long()
    obs_kf = st.mp_obs_kf[mp]  # (N, O)
    obs_ok = (obs_kf >= 0) & ok[:, None]
    kfs = obs_kf.long().clamp(0, K - 1)
    fts = st.mp_obs_feat[mp].long().clamp(0, N - 1)
    descs = st.kf_desc[kfs, fts]  # (N, O, 32)

    # medoid: min over observations of the max pairwise Hamming distance
    # (the +-1 product of ops/hamming.py, batched over the points: exact)
    d = hamming_matrix(descs, descs)  # (N, O, O)
    pair_ok = obs_ok[:, :, None] & obs_ok[:, None, :]
    not_self = ~torch.eye(O, dtype=torch.bool, device=dev)[None]
    maxd = torch.max(torch.where(pair_ok & not_self, d, torch.zeros_like(d)), dim=2).values
    maxd = torch.where(obs_ok, maxd, torch.full_like(maxd, 1 << 20))
    best = torch.argmin(maxd, dim=1)
    new_desc = torch.gather(descs, 1, best[:, None, None].expand(N, 1, 32))[:, 0]  # (N, 32)

    # normal + depth bounds from the observers' positions
    pos = st.mp_pos[mp]
    dirv = pos[:, None] - st.kf_p[kfs]  # (N, O, 3)
    dist = torch.linalg.norm(dirv, dim=-1)
    ok_d = obs_ok & (dist > 1e-10)
    unit = dirv / torch.clamp(dist[..., None], min=1e-10)
    nsum = torch.sum(torch.where(ok_d[..., None], unit, torch.zeros_like(unit)), dim=1)
    nn = torch.linalg.norm(nsum, dim=-1)
    normal = torch.where((nn > 1e-10)[:, None], nsum / torch.clamp(nn, min=1e-10)[:, None],
                         st.mp_normal[mp])
    mind = torch.min(torch.where(ok_d, dist, torch.full_like(dist, float("inf"))), dim=1).values
    maxdist = torch.max(torch.where(ok_d, dist, torch.zeros_like(dist)), dim=1).values
    scale_range = 1.2**7

    write = ok & ok_d.any(dim=1) & st.mp_valid[mp]
    return st._replace(
        mp_desc=scatter_set(st.mp_desc, mp, new_desc, write),
        mp_normal=scatter_set(st.mp_normal, mp, normal, write),
        mp_min_dist=scatter_set(st.mp_min_dist, mp, mind / scale_range, write),
        mp_max_dist=scatter_set(st.mp_max_dist, mp, maxdist * scale_range, write),
    )


def _redundancy(st: MapState, refs, min_other_obs: int):
    """Fraction of the referenced map points (last axis) seen by at least
    min_other_obs other keyframes."""
    M = st.mp_pos.shape[0]
    rows = refs.long().clamp(0, M - 1)
    ok = (refs >= 0) & st.mp_valid[rows]
    redundant = ok & (st.mp_obs_n[rows] >= min_other_obs + 1)
    return torch.sum(redundant.to(F32), -1) / torch.clamp(torch.sum(ok.to(F32), -1), min=1.0)


def keyframe_redundancy(st: MapState, kf_id, min_other_obs: int = 3):
    """Fraction of kf_id's map points seen by >= min_other_obs other keyframes."""
    return _redundancy(st, st.kf_mp[kf_id.long().clamp(0, st.kf_mp.shape[0] - 1)], min_other_obs)


def select_cull_candidate(st: MapState, kf_id, thresh, max_gap, min_other_obs: int = 3):
    """Most-redundant covisible keyframe of kf_id, or -1 if none qualifies:
    redundancy above `thresh`, never the current, the root or the newest
    keyframe, and the preintegration gap its removal leaves (between its
    temporal neighbours) at most max_gap seconds."""
    K = st.kf_mp.shape[0]
    dev = st.kf_valid.device
    kk = kf_id.long().clamp(0, K - 1)
    red = _redundancy(st, st.kf_mp, min_other_obs)

    # per-keyframe successor time: scatter-min over the temporal chain
    prev = st.kf_prev
    has_prev = (prev >= 0) & st.kf_valid
    inf = torch.full((K,), float("inf"), dtype=F32, device=dev)
    succ_t = inf.scatter_reduce(0, torch.where(has_prev, prev, torch.zeros_like(prev)).long(),
                                torch.where(has_prev, st.kf_time, inf), "amin")
    gap = succ_t - st.kf_time[prev.long().clamp(0, K - 1)]

    idx = torch.arange(K, dtype=I32, device=dev)
    cand = (st.kf_valid & (st.kf_map_id == st.kf_map_id[kk]) & (st.covis[kk] > 0)
            & (idx != kf_id) & (prev >= 0) & torch.isfinite(succ_t) & (gap <= max_gap)
            & (red > thresh))
    best = torch.argmax(torch.where(cand, red, torch.full_like(red, -1.0))).to(I32)
    return torch.where(cand.any(), best, torch.full_like(best, -1))


def select_pressure_evict_kf(st: MapState, last_kf, n_protect: int = 6):
    """Keyframe to evict under capacity pressure, or -1: the most-connected
    keyframe of the active map (largest covisibility row sum) that is not
    the root, not the tracker's reference keyframe and not among the newest
    n_protect."""
    K = st.kf_valid.shape[0]
    dev = st.kf_valid.device
    idx = torch.arange(K, dtype=I32, device=dev)
    active = st.kf_valid & (st.kf_map_id == st.active_map)
    t = torch.where(active, st.kf_time, torch.full_like(st.kf_time, float("-inf")))
    thresh_t = topk_stable(t, min(n_protect, K))[0][-1]
    cand = active & (t < thresh_t) & (idx != last_kf) & (st.kf_prev >= 0)
    conn = torch.sum(st.covis, dim=1).to(F32)
    best = torch.argmax(torch.where(cand, conn, torch.full_like(conn, -1.0))).to(I32)
    return torch.where(cand.any(), best, torch.full_like(best, -1))


def remove_keyframe(st: MapState, kf_id, enable=None):
    """Remove a redundant keyframe: clear its observations, merge its
    successor's preintegration over the gap, repair the temporal chain.
    With `enable` (a 0-d bool tensor) every write is masked by it, so a
    caller whose candidate may not exist needs no branch on a device value."""
    K = st.kf_mp.shape[0]
    dev = st.kf_valid.device
    kk = kf_id.long().clamp(0, K - 1)
    on = torch.ones((), dtype=torch.bool, device=dev) if enable is None else enable
    row = (torch.arange(K, device=dev) == kk) & on  # (K,) this keyframe's row, if enabled

    # clear this keyframe's entries from every obs list (holes are allowed)
    hit = (st.mp_obs_kf == kf_id) & on  # (M, O)
    neg = torch.full_like(st.mp_obs_kf, -1)
    mp_obs_n = torch.clamp(st.mp_obs_n - torch.sum(hit, dim=1, dtype=I32), min=0)

    # successor = the keyframe whose kf_prev is kf_id (temporal chain)
    succ_mask = (st.kf_prev == kf_id) & st.kf_valid
    succ = torch.argmax(succ_mask.to(I32))
    has_succ = succ_mask.any() & on

    # merged preintegration: (prev -> kf_id) ++ (kf_id -> succ)
    pre_k = pre.PreintState(*[a[kk] for a in st.kf_preint])
    pre_s = pre.PreintState(*[a[succ] for a in st.kf_preint])
    merged = pre.merge(pre_k, pre_s)
    kf_preint = pre.PreintState(*[set_row(arr, succ, torch.where(has_succ, m, s_))
                                  for arr, m, s_ in zip(st.kf_preint, merged, pre_s)])
    kf_prev = set_row(st.kf_prev, succ, torch.where(has_succ, st.kf_prev[kk], st.kf_prev[succ]))

    return st._replace(
        kf_valid=st.kf_valid & ~row,
        kf_mp=torch.where(row[:, None], torch.full_like(st.kf_mp, -1), st.kf_mp),
        mp_obs_kf=torch.where(hit, neg, st.mp_obs_kf),
        mp_obs_feat=torch.where(hit, neg, st.mp_obs_feat),
        mp_obs_n=mp_obs_n, kf_preint=kf_preint, kf_prev=kf_prev,
        covis=torch.where(row[:, None] | row[None, :], torch.zeros_like(st.covis), st.covis),
    )
