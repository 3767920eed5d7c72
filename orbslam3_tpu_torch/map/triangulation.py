"""Multi-view triangulation of unmatched features (batched 2-view DLT).

Port of orbslam3_tpu/map/triangulation.py: match the new keyframe's
unassigned features against each neighbour (temporal chain plus best
covisible) under an epipolar gate, triangulate by a closed-form DLT, validate
depth / reprojection / parallax, and spawn map points observed by both
views. The JAX module vmaps the pair step over the neighbours; here it is a
Python loop over them. Stereo features already get depth at insertion; this
pass mainly recovers far-field features whose disparity is too small.
"""
from __future__ import annotations

import torch

from orbslam3_tpu_torch.frontend.camera import Camera
from orbslam3_tpu_torch.frontend.stereo import pow12
from orbslam3_tpu_torch.geometry import quat
from orbslam3_tpu_torch.map.slam_map import (MapState, associate_batch, local_window_temporal,
                                             spawn_map_points)
from orbslam3_tpu_torch.ops.fast import topk_stable
from orbslam3_tpu_torch.ops.hamming import hamming_matrix

I32 = torch.int32
F32 = torch.float32


def _intrinsics(cam: Camera):
    z, o = torch.zeros_like(cam.fx), torch.ones_like(cam.fx)
    return torch.stack([torch.stack([cam.fx, z, cam.cx]), torch.stack([z, cam.fy, cam.cy]),
                        torch.stack([z, z, o])])


def _projection_matrix(cam: Camera, q_wc, p_wc):
    """3x4 world->pixel projection for a camera pose (T_BC already applied)."""
    R = quat.to_matrix(quat.conj(q_wc))  # world -> cam rotation
    t = -R @ p_wc
    return _intrinsics(cam) @ torch.cat([R, t[:, None]], dim=1)


def _dlt(P1, P2, uv1, uv2):
    """Two-view DLT for (N, 2) pixel pairs by row-normalized inhomogeneous
    least squares: the homogeneous scale is fixed (X_w = 1), which leaves a
    3-unknown problem whose 3x3 normal equations are solved in closed form
    (adjugate). It differs from the null-vector form only near infinity,
    which the depth and parallax gates reject."""
    A = torch.stack([
        uv1[:, 0:1] * P1[2] - P1[0],
        uv1[:, 1:2] * P1[2] - P1[1],
        uv2[:, 0:1] * P2[2] - P2[0],
        uv2[:, 1:2] * P2[2] - P2[1],
    ], dim=1)  # (N, 4, 4)
    A = A / torch.linalg.norm(A, dim=2, keepdim=True).clamp(min=1e-9)
    B, d = A[:, :, :3], A[:, :, 3]
    M = B.transpose(1, 2) @ B
    b = -(B.transpose(1, 2) @ d[:, :, None])[:, :, 0]
    m = lambda i, j: M[:, i, j]  # noqa: E731
    c00 = m(1, 1) * m(2, 2) - m(1, 2) * m(2, 1)
    c01 = m(0, 2) * m(2, 1) - m(0, 1) * m(2, 2)
    c02 = m(0, 1) * m(1, 2) - m(0, 2) * m(1, 1)
    c10 = m(1, 2) * m(2, 0) - m(1, 0) * m(2, 2)
    c11 = m(0, 0) * m(2, 2) - m(0, 2) * m(2, 0)
    c12 = m(0, 2) * m(1, 0) - m(0, 0) * m(1, 2)
    c20 = m(1, 0) * m(2, 1) - m(1, 1) * m(2, 0)
    c21 = m(0, 1) * m(2, 0) - m(0, 0) * m(2, 1)
    c22 = m(0, 0) * m(1, 1) - m(0, 1) * m(1, 0)
    det = m(0, 0) * c00 + m(0, 1) * c10 + m(0, 2) * c20
    adj = torch.stack([torch.stack([c00, c01, c02], -1), torch.stack([c10, c11, c12], -1),
                       torch.stack([c20, c21, c22], -1)], -2)
    det = torch.where(torch.abs(det) > 1e-12, det, torch.full_like(det, 1e-12))
    return (adj @ b[:, :, None])[:, :, 0] / det[:, None]


def _hat(v):
    z = torch.zeros_like(v[0])
    return torch.stack([torch.stack([z, -v[2], v[1]]), torch.stack([v[2], z, -v[0]]),
                        torch.stack([-v[1], v[0], z])])


def _pair_triangulate(st: MapState, kk, q1, p1, n_id, pair_ok, cam: Camera, max_hamming,
                      epipolar_px, chi2_max, min_parallax_cos):
    """Match keyframe kk's free features against one neighbour and
    triangulate. (q1, p1) is kk's camera pose. Returns per current feature
    (good (N,), cost (N,), j_best (N,), X (N, 3)); no state is changed."""
    K, N = st.kf_mp.shape
    dev = q1.device
    nn = n_id.long().clamp(0, K - 1)
    q2, p2 = cam.body_to_cam_pose(st.kf_q[nn], st.kf_p[nn])
    baseline = torch.linalg.norm(p2 - p1)

    # candidates: features without a map point on both sides
    free1 = st.kf_feat_valid[kk] & (st.kf_mp[kk] < 0)
    free2 = st.kf_feat_valid[nn] & (st.kf_mp[nn] < 0)
    dd = hamming_matrix(st.kf_desc[kk], st.kf_desc[nn]).to(F32)

    # epipolar gate: distance of the neighbour's feature to the epipolar
    # line of the current feature (fundamental matrix from the relative pose)
    R1 = quat.to_matrix(quat.conj(q1))
    R2 = quat.to_matrix(quat.conj(q2))
    R12 = R2 @ R1.T  # cam1 -> cam2 rotation
    t12 = R2 @ (p1 - p2)  # cam1 origin in cam2
    Kinv = torch.linalg.inv_ex(_intrinsics(cam))[0]
    Fm = Kinv.T @ _hat(t12) @ R12 @ Kinv  # x2^T F x1 = 0

    ones1 = torch.ones((N, 1), dtype=F32, device=dev)
    uv1 = st.kf_uv[kk]
    x1h = torch.cat([uv1, ones1], dim=1)  # (N, 3)
    x2h = torch.cat([st.kf_uv[nn], ones1], dim=1)
    lines = x1h @ Fm.T  # (N, 3) epipolar lines in image 2
    num = torch.abs(x2h @ lines.T).T  # (N1, N2): |x2 . l1|
    denom = torch.sqrt(lines[:, 0] ** 2 + lines[:, 1] ** 2).clamp(min=1e-6)
    epi_dist = num / denom[:, None]

    ok = (free1[:, None] & free2[None, :] & (dd <= max_hamming)
          & (epi_dist <= epipolar_px * pow12(st.kf_octave[nn])[None, :])
          & pair_ok & (baseline > 0.05))
    BIG = 1e6
    cost = torch.where(ok, dd, torch.full_like(dd, BIG))
    j_best = torch.argmin(cost, dim=1)
    c_best = torch.gather(cost, 1, j_best[:, None])[:, 0]
    i_best = torch.argmin(cost, dim=0)
    mutual = i_best[j_best] == torch.arange(N, device=dev)
    matched = (c_best < BIG) & mutual

    uv2 = st.kf_uv[nn][j_best]
    X = _dlt(_projection_matrix(cam, q1, p1), _projection_matrix(cam, q2, p2), uv1, uv2)

    # validation: depth, reprojection, parallax (angle between the two rays)
    xc1 = quat.rotate(quat.conj(q1)[None], X - p1[None])
    xc2 = quat.rotate(quat.conj(q2)[None], X - p2[None])
    z1, z2 = xc1[:, 2], xc2[:, 2]
    e1 = torch.sum((cam.project(xc1) - uv1) ** 2, -1)
    e2 = torch.sum((cam.project(xc2) - uv2) ** 2, -1)
    r1 = xc1 / torch.linalg.norm(xc1, dim=-1, keepdim=True).clamp(min=1e-6)
    r2n = X - p2[None]
    r2n = r2n / torch.linalg.norm(r2n, dim=-1, keepdim=True).clamp(min=1e-6)
    cos_par = torch.sum(quat.rotate(q1[None], r1) * r2n, -1)

    good = (matched & (z1 > 0.2) & (z2 > 0.2) & (z1 < 80.0) & (e1 <= chi2_max)
            & (e2 <= chi2_max) & (cos_par < min_parallax_cos))
    return good, c_best, j_best, X


def triangulate_with_neighbor(st: MapState, kf_id, cam: Camera, max_new: int = 128,
                              max_hamming: int = 50, epipolar_px: float = 2.0,
                              chi2_max: float = 5.991, min_parallax_cos: float = 0.9998,
                              n_neighbors: int = 6, n_temporal: int = 2):
    """Triangulate new points between kf_id and its neighbours: the
    `n_temporal` kf_prev predecessors plus the top covisible keyframes. Each
    feature of kf_id takes its best-scoring neighbour match, and the merged
    budget of `max_new` spawns once. Returns (MapState, number spawned)."""
    K, N = st.kf_mp.shape
    dev = st.kf_valid.device
    W = n_neighbors
    ids, valid_w = local_window_temporal(st, kf_id, W + 1, n_temporal)
    n_ids, n_ok = ids[1:], valid_w[1:]
    kk = kf_id.long().clamp(0, K - 1)
    q1, p1 = cam.body_to_cam_pose(st.kf_q[kk], st.kf_p[kk])

    per = [_pair_triangulate(st, kk, q1, p1, n_ids[w], n_ok[w], cam, max_hamming, epipolar_px,
                             chi2_max, min_parallax_cos) for w in range(W)]
    good_w, cost_w, jbest_w, X_w = (torch.stack(x) for x in zip(*per))  # (W, N[, 3])

    # per feature: best neighbour = lowest descriptor cost among good ones
    cost_sel = torch.where(good_w, cost_w, torch.full_like(cost_w, float("inf")))
    best_w = torch.argmin(cost_sel, dim=0)  # (N,)
    any_good = good_w.any(dim=0)
    nI = torch.arange(N, device=dev)
    c_best = cost_sel[best_w, nI]
    X = X_w[best_w, nI]

    # spawn the top max_new (best descriptor distance first)
    prio = torch.where(any_good, -c_best, torch.full_like(c_best, float("-inf")))
    _, sel = topk_stable(prio, max_new)
    sel_ok = any_good[sel]

    st, new_ids = spawn_map_points(st, kf_id, sel.to(I32), X[sel], sel_ok)
    # associate each spawned point to its triangulation neighbour
    for w in range(W):
        mask = sel_ok & (best_w[sel] == w) & (new_ids >= 0)
        st = associate_batch(st, n_ids[w], jbest_w[w][sel].to(I32),
                             torch.where(mask, new_ids, torch.zeros_like(new_ids)), mask)
    return st, torch.sum(sel_ok, dtype=I32)
