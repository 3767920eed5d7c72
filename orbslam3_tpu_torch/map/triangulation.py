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


def _fma(a, b, c):
    """a * b + c rounded once to float32 (the product of two float32 values
    is exact in float64; the float64 sum rounds before the float32
    rounding, which moved no result on the inputs measured)."""
    return (a.double() * b.double() + c.double()).float()


def _projection_matrix(cam: Camera, q_wc, p_wc):
    """3x4 world->pixel projection K [R | -R p] for a camera pose (T_BC
    already applied), rounded as XLA:CPU computes the JAX package's: each
    rotation entry's a b +- c d as fma(a, b, +-(c d)), R p as a chain of
    fused multiply-adds, and the rows of K @ [R | t] as fma(c, X2, f X0)."""
    w, x, y, z = (q_wc * torch.tensor([1.0, -1.0, -1.0, -1.0], device=q_wc.device)).unbind(-1)
    R = torch.stack([
        torch.stack([1 - 2 * _fma(y, y, z * z), 2 * _fma(x, y, -(w * z)),
                     2 * _fma(x, z, w * y)]),
        torch.stack([2 * _fma(x, y, w * z), 1 - 2 * _fma(x, x, z * z),
                     2 * _fma(y, z, -(w * x))]),
        torch.stack([2 * _fma(x, z, -(w * y)), 2 * _fma(y, z, w * x),
                     1 - 2 * _fma(x, x, y * y)]),
    ])  # world -> cam rotation
    Rp = R[:, 0] * p_wc[0]
    for k in (1, 2):
        Rp = _fma(R[:, k], p_wc[k], Rp)
    X = torch.cat([R, -Rp[:, None]], dim=1)
    return torch.stack([_fma(cam.cx, X[2], cam.fx * X[0]), _fma(cam.cy, X[2], cam.fy * X[1]), X[2]])


def _dlt(P1, P2, uv1, uv2):
    """Two-view DLT for (N, 2) pixel pairs by row-normalized inhomogeneous
    least squares: the homogeneous scale is fixed (X_w = 1), which leaves a
    3-unknown problem whose 3x3 normal equations are solved in closed form
    (adjugate). It differs from the null-vector form only near infinity,
    which the depth and parallax gates reject.

    Every step rounds as the JAX package's compiled `_dlt` does on XLA:CPU,
    which contracts each multiply feeding an add into a fused multiply-add:
    the rows uv * P[2] - P[0]; the squared row norms, the B^T B and -B^T d
    sums and adj @ b as chains of fused multiply-adds in index order from a
    rounded first product; each cofactor x y - z w as fma(x, y, -(z w)); det
    as fma(M02, c20, fma(M00, c00, M01 c10)); the square root correctly
    rounded (torch's float32 CPU sqrt is not always)."""
    f32 = torch.float32

    def rows(uv, P):
        return [_fma(uv[:, 0:1], P[2], -P[0]), _fma(uv[:, 1:2], P[2], -P[1])]

    A = torch.stack(rows(uv1, P1) + rows(uv2, P2), dim=1)  # (N, 4, 4)
    s = (A[:, :, 0] * A[:, :, 0]).to(f32)
    for k in range(1, 4):
        s = _fma(A[:, :, k], A[:, :, k], s)
    A = A / torch.sqrt(s.double()).to(f32).clamp(min=1e-9)[:, :, None]
    B, d = A[:, :, :3], A[:, :, 3]
    M = B[:, 0, :, None] * B[:, 0, None, :]
    b = -B[:, 0] * d[:, 0:1]
    for k in range(1, 4):
        M = _fma(B[:, k, :, None], B[:, k, None, :], M)
        b = _fma(-B[:, k], d[:, k:k + 1], b)
    m = lambda i, j: M[:, i, j]  # noqa: E731

    def cof(x, y, z, w):
        return _fma(x, y, -(z * w))

    c00 = cof(m(1, 1), m(2, 2), m(1, 2), m(2, 1))
    c01 = cof(m(0, 2), m(2, 1), m(0, 1), m(2, 2))
    c02 = cof(m(0, 1), m(1, 2), m(0, 2), m(1, 1))
    c10 = cof(m(1, 2), m(2, 0), m(1, 0), m(2, 2))
    c11 = cof(m(0, 0), m(2, 2), m(0, 2), m(2, 0))
    c12 = cof(m(0, 2), m(1, 0), m(0, 0), m(1, 2))
    c20 = cof(m(1, 0), m(2, 1), m(1, 1), m(2, 0))
    c21 = cof(m(0, 1), m(2, 0), m(0, 0), m(2, 1))
    c22 = cof(m(0, 0), m(1, 1), m(0, 1), m(1, 0))
    det = _fma(m(0, 2), c20, _fma(m(0, 0), c00, m(0, 1) * c10))
    adj = torch.stack([torch.stack([c00, c01, c02], -1), torch.stack([c10, c11, c12], -1),
                       torch.stack([c20, c21, c22], -1)], -2)
    x = adj[:, :, 0] * b[:, 0:1]
    for k in (1, 2):
        x = _fma(adj[:, :, k], b[:, k:k + 1], x)
    det = torch.where(torch.abs(det) > 1e-12, det, torch.full_like(det, 1e-12))
    return x / det[:, None]


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
