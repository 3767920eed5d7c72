"""No-prior robust pose estimation: batched 3D-3D RANSAC.

Port of orbslam3_tpu/optim/robust_pose.py. The stereo front end backprojects
features to body-frame 3D, so the minimal problem is 3-point rigid alignment
(Horn 1987: the optimal quaternion is the top eigenvector of a 4x4 matrix).
All H hypotheses solve as one batched eigh of (H, 4, 4) matrices and score
as one (H, N) residual matrix: no data-dependent loop, fixed shapes. The
inlier gates are depth-aware and anisotropic (along the viewing ray stereo
noise grows as z^2/(fx*b), laterally as z/fx).

The random triples come from a `torch.Generator` or are passed in as
`draws`, so a caller can feed the draws another sampler made.
"""
from __future__ import annotations

import torch

from orbslam3_tpu_torch.geometry import quat
from orbslam3_tpu_torch.ops.fast import topk_stable


def _horn_quat(a, b, w):
    """Rotation quaternions q (b ~= R(q) a) from weighted correspondences.

    a, b: (..., K, 3) centered point sets; w: (..., K) weights. Returns the
    unit quaternions maximizing sum_i w_i b_i . (R a_i), with q[0] >= 0."""
    M = torch.einsum("...k,...ki,...kj->...ij", w, a, b)  # (..., 3, 3)
    m = lambda i, j: M[..., i, j]  # noqa: E731
    # Horn's N matrix; its top eigenvector is the optimal quaternion
    N = torch.stack([
        torch.stack([m(0, 0) + m(1, 1) + m(2, 2), m(1, 2) - m(2, 1),
                     m(2, 0) - m(0, 2), m(0, 1) - m(1, 0)], -1),
        torch.stack([m(1, 2) - m(2, 1), m(0, 0) - m(1, 1) - m(2, 2),
                     m(0, 1) + m(1, 0), m(2, 0) + m(0, 2)], -1),
        torch.stack([m(2, 0) - m(0, 2), m(0, 1) + m(1, 0),
                     -m(0, 0) + m(1, 1) - m(2, 2), m(1, 2) + m(2, 1)], -1),
        torch.stack([m(0, 1) - m(1, 0), m(2, 0) + m(0, 2),
                     m(1, 2) + m(2, 1), -m(0, 0) - m(1, 1) + m(2, 2)], -1),
    ], -2)
    _, vecs = torch.linalg.eigh(N)  # ascending eigenvalues
    q = vecs[..., :, -1]
    return quat.normalize(torch.where(q[..., :1] < 0, -q, q))


def _weighted_horn(Xw, Xb, w):
    """Full weighted rigid fit: (q_bw, t) with Xb ~= R(q_bw) Xw + t."""
    wsum = torch.clamp(torch.sum(w), min=1e-6)
    cw = torch.einsum("k,ki->i", w, Xw) / wsum
    cb = torch.einsum("k,ki->i", w, Xb) / wsum
    q_bw = _horn_quat(Xw - cw, Xb - cb, w)
    return q_bw, cb - quat.rotate(q_bw, cw)


def robust_pose_3d3d(Xw, Xb, valid, cam_bf, cam_fx, generator: torch.Generator = None,
                     draws=None, n_hyp: int = 128, px_tol: float = 4.0):
    """Batched-RANSAC body pose from 3D-3D correspondences.

    Xw (N, 3) matched map-point world positions; Xb (N, 3) stereo-
    backprojected body-frame positions of the features; valid (N,) bool
    (matched and has depth); cam_bf = fx * baseline, cam_fx the focal length.
    Give either `generator` (on Xw's device; the triples are drawn uniformly
    in [0, max(n_valid, 1))) or `draws` (H, 3) integer positions in the
    valid-first order, already in that range.
    Returns q_wb (4,), p_wb (3,), inlier_mask (N,), n_inliers (): the
    identity pose with 0 inliers when fewer than 3 valid correspondences
    exist."""
    N = Xw.shape[0]
    dev = Xw.device
    f32 = torch.float32
    nv = torch.sum(valid, dtype=torch.int32)

    # valid-first index order so uniform draws in [0, nv) hit real rows
    _, order = topk_stable(valid.to(f32), N)
    if draws is None:
        u = torch.rand((n_hyp, 3), generator=generator, device=dev, dtype=torch.float64)
        hi = torch.clamp(nv, min=1)
        draws = torch.minimum((u * hi).long(), hi.long() - 1)
    draws = draws.long()
    n_hyp = draws.shape[0]
    idx = order[draws]  # (H, 3)
    aw = Xw[idx]  # (H, 3, 3)
    ab = Xb[idx]

    # degenerate triples (collinear, or a row drawn twice) are solved anyway
    # and masked out of the scores
    distinct = ((draws[:, 0] != draws[:, 1]) & (draws[:, 1] != draws[:, 2])
                & (draws[:, 0] != draws[:, 2]))
    area = torch.linalg.norm(torch.linalg.cross(aw[:, 1] - aw[:, 0], aw[:, 2] - aw[:, 0]), dim=-1)
    hyp_ok = distinct & (area > 1e-4) & (nv >= 3)

    cw = torch.mean(aw, dim=1, keepdim=True)
    cb = torch.mean(ab, dim=1, keepdim=True)
    q_h = _horn_quat(aw - cw, ab - cb, torch.ones((n_hyp, 3), dtype=f32, device=dev))
    t_h = cb[:, 0] - quat.rotate(q_h, cw[:, 0])  # (H, 3)

    # dense scoring: (H, N) anisotropic residuals
    z = torch.clamp(Xb[..., 2], min=0.3)
    thr_par = torch.clamp(px_tol * z * z / cam_bf, min=0.02)  # along the ray (N,)
    thr_perp = torch.clamp(px_tol * z / cam_fx, min=0.01)  # lateral (N,)
    u = Xb / torch.clamp(torch.linalg.norm(Xb, dim=-1, keepdim=True), min=1e-6)

    def gate(d):  # d: (..., N, 3) residuals in the body frame
        e_par = torch.sum(d * u, dim=-1)
        e_perp = torch.linalg.norm(d - e_par[..., None] * u, dim=-1)
        return (torch.abs(e_par) <= thr_par) & (e_perp <= thr_perp)

    pred = quat.rotate(q_h[:, None], Xw[None]) + t_h[:, None]  # (H, N, 3)
    inl = gate(pred - Xb[None]) & valid[None]  # (H, N)
    scores = torch.where(hyp_ok, torch.sum(inl, dim=1, dtype=torch.int32),
                         torch.zeros((), dtype=torch.int32, device=dev))

    best = torch.argmax(scores)
    # refine: one weighted Horn over the best hypothesis's inliers, kept
    # only if it did not lose inliers
    q_ref, t_ref = _weighted_horn(Xw, Xb, inl[best].to(f32))
    inl_r = gate(quat.rotate(q_ref[None], Xw) + t_ref[None] - Xb) & valid
    n_r = torch.sum(inl_r, dtype=torch.int32)
    use_ref = n_r >= scores[best]
    q_bw = torch.where(use_ref, q_ref, q_h[best])
    t = torch.where(use_ref, t_ref, t_h[best])
    inliers = torch.where(use_ref, inl_r, inl[best])
    n_inl = torch.where(use_ref, n_r, scores[best])

    # body pose from the (b <- w) alignment: p_wb = -R^T t, q_wb = q^-1
    q_wb = quat.normalize(quat.conj(q_bw))
    p_wb = -quat.rotate(q_wb, t)
    found = scores[best] >= 3
    q_wb = torch.where(found, q_wb, quat.identity(device=dev))
    p_wb = torch.where(found, p_wb, torch.zeros(3, dtype=f32, device=dev))
    return q_wb, p_wb, inliers & found, torch.where(found, n_inl, torch.zeros_like(n_inl))
