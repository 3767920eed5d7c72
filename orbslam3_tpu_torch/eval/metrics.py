"""ATE / RPE trajectory metrics with Umeyama alignment (host-side numpy).

Copy of orbslam3_tpu/eval/metrics.py that does not import JAX.

Standard formulation (Sturm et al., TUM RGB-D benchmark): align estimate to
ground truth with the closed-form similarity/rigid transform, report RMSE of
translational residuals.
"""
from __future__ import annotations

import numpy as np

from orbslam3_tpu_torch.geometry.quat import to_matrix_np as _qmat_np


def umeyama_align(est: np.ndarray, gt: np.ndarray, with_scale: bool = False):
    """Least-squares rigid (or similarity) alignment est -> gt.

    Args:
      est, gt: (T, 3) trajectories
    Returns:
      (R (3,3), t (3,), s) minimizing ||gt - (s R est + t)||^2
    """
    mu_e = est.mean(0)
    mu_g = gt.mean(0)
    xe = est - mu_e
    xg = gt - mu_g
    cov = xg.T @ xe / len(est)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1.0
    R = U @ S @ Vt
    if with_scale:
        var_e = (xe**2).sum() / len(est)
        s = float(np.trace(np.diag(D) @ S) / var_e)
    else:
        s = 1.0
    t = mu_g - s * R @ mu_e
    return R, t, s


def ate_rmse(est: np.ndarray, gt: np.ndarray, with_scale: bool = False) -> float:
    """Absolute trajectory error RMSE [m] after alignment."""
    R, t, s = umeyama_align(est, gt, with_scale)
    aligned = (s * (R @ est.T)).T + t
    err = np.linalg.norm(aligned - gt, axis=-1)
    return float(np.sqrt((err**2).mean()))


def rpe_rmse(
    est_p: np.ndarray,
    gt_p: np.ndarray,
    est_q: np.ndarray | None = None,
    gt_q: np.ndarray | None = None,
    delta: int = 20,
):
    """Standard Sturm RPE over windows of `delta` frames.

    E_i = (Q_i^-1 Q_{i+d})^-1 (P_i^-1 P_{i+d}) with Q ground truth, P
    estimate; reports (trans_rmse [m], rot_rmse [rad]). With orientations
    absent, falls back to expressing both relative translations in the
    GROUND-TRUTH frame-i axes (captures lateral error, unlike the r1
    magnitude-difference proxy) and returns (trans_rmse, None).
    """
    T = min(len(est_p), len(gt_p))
    if T <= delta:
        # mirror the main path's contract: a rotation NUMBER only when both
        # orientation sets exist, None otherwise (0.0 would read as "zero
        # rotation error" for a degenerate/short run)
        has_rot = est_q is not None and gt_q is not None
        return 0.0, (0.0 if has_rot else None)
    i0 = np.arange(T - delta)
    i1 = i0 + delta

    Rg = _qmat_np(np.asarray(gt_q[:T], np.float64)) if gt_q is not None else None
    if est_q is not None and gt_q is not None:
        Re = _qmat_np(np.asarray(est_q[:T], np.float64))
        # relative motions in each frame-i's own axes
        dRe = np.einsum("nij,nik->njk", Re[i0], Re[i1])  # Re_i^T Re_j
        dte = np.einsum("nij,ni->nj", Re[i0], est_p[i1] - est_p[i0])  # Re_i^T dp
        dRg = np.einsum("nij,nik->njk", Rg[i0], Rg[i1])
        dtg = np.einsum("nij,ni->nj", Rg[i0], gt_p[i1] - gt_p[i0])
        # error transform: dg^-1 * de
        Rerr = np.einsum("nij,nik->njk", dRg, dRe)
        terr = np.einsum("nij,ni->nj", dRg, dte - dtg)
        trans = float(np.sqrt((np.linalg.norm(terr, axis=-1) ** 2).mean()))
        tr = np.clip((np.trace(Rerr, axis1=1, axis2=2) - 1) / 2, -1, 1)
        rot = float(np.sqrt((np.arccos(tr) ** 2).mean()))
        return trans, rot
    # position-only fallback: compare relative translation VECTORS in the
    # ground-truth local frame when available, else world axes
    de = est_p[i1] - est_p[i0]
    dg = gt_p[i1] - gt_p[i0]
    if Rg is not None:
        de = np.einsum("nij,ni->nj", Rg[i0], de)
        dg = np.einsum("nij,ni->nj", Rg[i0], dg)
    err = np.linalg.norm(de - dg, axis=-1)
    return float(np.sqrt((err**2).mean())), None
