"""Sim3 estimation: weighted Horn closed form + batched-hypothesis RANSAC.

Port of orbslam3_tpu/loop/sim3.py: Horn's absolute orientation (centroids,
SVD of the cross-covariance, reflection fix, t = cb - s R ca) inside a RANSAC
of a fixed batch of 3-point hypotheses and an argmax. All hypotheses solve as
one batched 3x3 SVD.

The 3-point samples come from a `torch.Generator` or are passed in as
`samples`, so a caller can feed the draws another sampler made.
"""
from __future__ import annotations

import torch

from orbslam3_tpu_torch.geometry import quat
from orbslam3_tpu_torch.geometry.sim3 import Sim3


def horn_weighted(pa, pb, w, fix_scale: bool = True) -> Sim3:
    """Closed-form S minimizing sum w_i ||pb_i - S(pa_i)||^2.

    pa, pb: (N, 3); w: (..., N) nonnegative weights, one fit per leading
    index. A rank-2 covariance (three sample points) still has one answer:
    the reflection fix takes up the free sign of the third singular vector."""
    wsum = torch.clamp(torch.sum(w, dim=-1, keepdim=True), min=1e-9)  # (..., 1)
    ca = (w @ pa) / wsum  # (..., 3)
    cb = (w @ pb) / wsum
    xa = pa - ca[..., None, :]  # (..., N, 3)
    xb = pb - cb[..., None, :]
    cov = (xb * w[..., None]).transpose(-1, -2) @ xa / wsum[..., None]  # sum w b a^T
    U, D, Vt = torch.linalg.svd(cov)
    det = torch.linalg.det(U) * torch.linalg.det(Vt)
    one = torch.ones_like(det)
    S = torch.stack([one, one, torch.where(det < 0, -one, one)], dim=-1)  # (..., 3) diagonal
    R = (U * S[..., None, :]) @ Vt
    if fix_scale:
        s = torch.ones_like(det)
    else:
        var_a = torch.sum(w[..., None] * xa * xa, dim=(-2, -1)) / wsum[..., 0]
        s = torch.sum(D * S, dim=-1) / torch.clamp(var_a, min=1e-9)
    t = cb - s[..., None] * (R @ ca[..., None])[..., 0]
    return Sim3(quat.from_matrix(R), t, s)


def draw_samples(valid, n_hyp: int, generator: torch.Generator = None):
    """(n_hyp, 3) indices drawn uniformly, with replacement, among the valid
    rows (among all rows when none is valid)."""
    p = torch.where(valid.any(), valid.to(torch.float32), torch.ones_like(valid, dtype=torch.float32))
    return torch.multinomial(p.expand(n_hyp, -1), 3, replacement=True, generator=generator)


def _ransac(pa, pb, valid, count, samples, fix_scale: bool):
    """Hypotheses from Horn on the 3-point `samples`, scored by `count`
    (Sim3 with leading dims (...) -> inlier mask (..., N)); the best one is
    refined on all its inliers and re-classified."""
    N = pa.shape[0]
    samples = samples.long()
    w = torch.zeros((samples.shape[0], N), dtype=pa.dtype, device=pa.device)
    w = w.scatter_add(1, samples, torch.ones_like(samples, dtype=pa.dtype))
    Ss = horn_weighted(pa, pb, w, fix_scale)
    inls = count(Ss) & valid
    counts = torch.sum(inls, dim=-1, dtype=torch.int32)
    best = torch.argmax(counts)
    S_best = Sim3(*[a[best] for a in Ss])
    inl_best = inls[best]

    S_ref = horn_weighted(pa, pb, inl_best.to(pa.dtype), fix_scale)
    inl_ref = count(S_ref) & valid
    better = torch.sum(inl_ref, dtype=torch.int32) >= counts[best]
    S_out = Sim3(*[torch.where(better, a, b) for a, b in zip(S_ref, S_best)])
    inl_out = torch.where(better, inl_ref, inl_best)
    return S_out, inl_out, torch.sum(inl_out, dtype=torch.int32)


def _over_points(S: Sim3) -> Sim3:
    """S with a points axis after its leading dims, to apply to (N, 3)."""
    return Sim3(S.q[..., None, :], S.t[..., None, :], S.s[..., None])


def sim3_ransac(pa, pb, valid, generator: torch.Generator = None, samples=None,
                n_hyp: int = 256, inlier_thr: float = 0.2, fix_scale: bool = True):
    """RANSAC Sim3 from 3D-3D correspondences (pa -> pb).

    Give either `generator` (on pa's device) or `samples` (n_hyp, 3) row
    indices. Returns (Sim3 best, inlier_mask (N,), n_inliers)."""
    if samples is None:
        samples = draw_samples(valid, n_hyp, generator)

    def count(S: Sim3):
        return torch.linalg.norm(_over_points(S).apply(pa) - pb, dim=-1) < inlier_thr

    return _ransac(pa, pb, valid, count, samples, fix_scale)


def sim3_ransac_reproj(pa, pb, uv_a, uv_b, sig_a, sig_b, valid, cam,
                       generator: torch.Generator = None, samples=None, n_hyp: int = 256,
                       chi2: float = 9.21, fix_scale: bool = True):
    """RANSAC Sim3 scored by two-way pixel reprojection.

    Hypotheses come from Horn on 3-point 3D samples, but inliers are
    classified in pixels: S(pa_i) must reproject within a chi^2 gate of the
    observed uv_b_i in keyframe B, and S^-1(pb_i) within the gate of uv_a_i
    in A. Stereo depth error grows as z^2/(f b) per pixel of disparity error,
    so any 3D threshold either rejects correct far matches or accepts
    everything nearby; pixel error is depth-robust.

    pa, pb: (N, 3) body-frame points in A resp. B; uv_a, uv_b: (N, 2)
    observed pixels of the matched features; sig_a, sig_b: (N,) pixel sigma
    (1.2^octave). Give either `generator` or `samples` (n_hyp, 3). Returns
    (Sim3 best, inlier_mask, n_inliers)."""
    if samples is None:
        samples = draw_samples(valid, n_hyp, generator)

    def count(S: Sim3):
        Sp = _over_points(S)
        uv_b_pred, zb = cam.project_body(Sp.apply(pa))
        uv_a_pred, za = cam.project_body(Sp.inverse().apply(pb))
        e_b = torch.sum((uv_b_pred - uv_b) ** 2, -1) / (sig_b * sig_b)
        e_a = torch.sum((uv_a_pred - uv_a) ** 2, -1) / (sig_a * sig_a)
        return (e_b < chi2) & (e_a < chi2) & (za > 0.0) & (zb > 0.0)

    return _ransac(pa, pb, valid, count, samples, fix_scale)
