"""The benchmark's arithmetic: rates, percentiles, trajectory alignment.

`umeyama_align` and `ate_rmse` are frozen copies of the program's
orbslam3_tpu_torch/eval/metrics.py (Sturm et al., TUM RGB-D benchmark);
nothing here imports the program.
"""
from __future__ import annotations

import numpy as np


def rate(count: int, seconds: float) -> float:
    """Work completed per second over the whole window."""
    return count / seconds


def percentile(values, q: float) -> float:
    """The q-th percentile (0-100) of every value, linear between the
    closest ranks (numpy's default): a tail over all samples."""
    return float(np.percentile(np.asarray(values, np.float64), q))


def umeyama_align(est: np.ndarray, gt: np.ndarray, with_scale: bool = False):
    """Least-squares rigid (or similarity) alignment est -> gt: (R, t, s)
    minimizing ||gt - (s R est + t)||^2 over (T, 3) trajectories."""
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


def aligned_errors(est: np.ndarray, gt: np.ndarray):
    """(per-position error [m] after rigid alignment, R, t)."""
    est = np.asarray(est, np.float64)
    gt = np.asarray(gt, np.float64)
    R, t, _ = umeyama_align(est, gt)
    err = np.linalg.norm((R @ est.T).T + t - gt, axis=-1)
    return err, R, t


def rmse(err) -> float:
    return float(np.sqrt(np.mean(np.square(err))))


def box_distance(pts: np.ndarray, half) -> np.ndarray:
    """Distance [m] of each (N, 3) point to the surface of the box
    |x| <= half centred at the origin (the synthetic room's walls)."""
    half = np.asarray(half, np.float64)
    a = np.abs(np.asarray(pts, np.float64))
    inside = np.all(a <= half, axis=1)
    d_in = np.min(half - a, axis=1)
    d_out = np.linalg.norm(np.maximum(a - half, 0.0), axis=1)
    return np.where(inside, d_in, d_out)


def quat_to_matrix(q) -> np.ndarray:
    """(..., 4) wxyz -> (..., 3, 3)."""
    q = np.asarray(q, np.float64)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        np.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ], -2)


def angle_deg(a, b) -> float:
    """Angle between two 3-vectors, in degrees."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    c = np.dot(a, b) / max(np.linalg.norm(a) * np.linalg.norm(b), 1e-12)
    return float(np.degrees(np.arccos(np.clip(c, -1.0, 1.0))))
