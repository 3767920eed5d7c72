"""SO(3): rotation-vector exp/log, hat, right Jacobians (Forster convention).

Port of orbslam3_tpu/geometry/so3.py. Branch-free: every small-angle case
is a torch.where over safe operands, so the functions run under
torch.func.vmap/jacfwd.
"""
from __future__ import annotations

import torch

_EPS = 1e-6


def _eye_like(W):
    return torch.eye(3, dtype=W.dtype, device=W.device).expand(W.shape)


def hat(w):
    """Skew-symmetric matrix of w (..., 3) -> (..., 3, 3)."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([z, -wz, wy], dim=-1),
            torch.stack([wz, z, -wx], dim=-1),
            torch.stack([-wy, wx, z], dim=-1),
        ],
        dim=-2,
    )


def vee(W):
    """Inverse of hat: (..., 3, 3) -> (..., 3)."""
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], dim=-1)


def _theta(w):
    """Safe angle + mask. Returns (theta, theta_sq, is_small)."""
    theta_sq = torch.sum(w * w, dim=-1)
    is_small = theta_sq < _EPS * _EPS
    theta = torch.sqrt(torch.where(is_small, torch.ones_like(theta_sq), theta_sq))
    theta = torch.where(is_small, torch.zeros_like(theta), theta)
    return theta, theta_sq, is_small


def _safe(is_small, x):
    return torch.where(is_small, torch.ones_like(x), x)


def exp_matrix(w):
    """Rodrigues: rotation vector (..., 3) -> rotation matrix (..., 3, 3)."""
    theta, theta_sq, is_small = _theta(w)
    W = hat(w)
    W2 = W @ W
    st = torch.where(is_small, 1.0 - theta_sq / 6.0, torch.sin(theta) / _safe(is_small, theta))
    ct = torch.where(is_small, 0.5 - theta_sq / 24.0,
                     (1.0 - torch.cos(theta)) / _safe(is_small, theta_sq))
    return _eye_like(W) + st[..., None, None] * W + ct[..., None, None] * W2


def matrix_to_quat(R):
    """Rotation matrix (..., 3, 3) -> unit quaternion (..., 4) wxyz (Shepperd,
    all four pivots computed and the largest selected per element)."""
    r00, r11, r22 = R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]
    tr = r00 + r11 + r22

    def safe_sqrt(x):
        return torch.sqrt(torch.clamp(x, min=1e-12))

    s0 = safe_sqrt(1.0 + tr) * 2.0
    q0 = torch.stack([0.25 * s0, (R[..., 2, 1] - R[..., 1, 2]) / s0,
                      (R[..., 0, 2] - R[..., 2, 0]) / s0, (R[..., 1, 0] - R[..., 0, 1]) / s0], -1)
    s1 = safe_sqrt(1.0 + r00 - r11 - r22) * 2.0
    q1 = torch.stack([(R[..., 2, 1] - R[..., 1, 2]) / s1, 0.25 * s1,
                      (R[..., 0, 1] + R[..., 1, 0]) / s1, (R[..., 0, 2] + R[..., 2, 0]) / s1], -1)
    s2 = safe_sqrt(1.0 - r00 + r11 - r22) * 2.0
    q2 = torch.stack([(R[..., 0, 2] - R[..., 2, 0]) / s2, (R[..., 0, 1] + R[..., 1, 0]) / s2,
                      0.25 * s2, (R[..., 1, 2] + R[..., 2, 1]) / s2], -1)
    s3 = safe_sqrt(1.0 - r00 - r11 + r22) * 2.0
    q3 = torch.stack([(R[..., 1, 0] - R[..., 0, 1]) / s3, (R[..., 0, 2] + R[..., 2, 0]) / s3,
                      (R[..., 1, 2] + R[..., 2, 1]) / s3, 0.25 * s3], -1)
    pivots = torch.stack([tr, r00, r11, r22], dim=-1)
    idx = torch.argmax(pivots, dim=-1)
    cands = torch.stack([q0, q1, q2, q3], dim=-2)  # (..., 4cand, 4)
    q = torch.gather(cands, -2, idx[..., None, None].expand(idx.shape + (1, 4)))[..., 0, :]
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True).clamp(min=1e-12)
    return torch.where(q[..., :1] < 0, -q, q)


def log_matrix(R):
    """Rotation matrix (..., 3, 3) -> rotation vector (..., 3)."""
    q = matrix_to_quat(R)
    w = q[..., 0]
    vn_sq = torch.sum(q[..., 1:] ** 2, dim=-1)
    is_small = vn_sq < 1e-14
    vn = torch.sqrt(_safe(is_small, vn_sq))
    vn = torch.where(is_small, torch.zeros_like(vn), vn)
    theta = 2.0 * torch.atan2(vn, w)
    k = torch.where(is_small, torch.full_like(theta, 2.0), theta / _safe(is_small, vn))
    return k[..., None] * q[..., 1:]


def right_jacobian(w):
    """Right Jacobian of SO(3) (Forster eq. 8): Exp(w + dw) ~ Exp(w) Exp(Jr dw)."""
    theta, theta_sq, is_small = _theta(w)
    W = hat(w)
    W2 = W @ W
    t3 = torch.where(is_small, torch.ones_like(theta), theta_sq * theta)
    a = torch.where(is_small, 0.5 - theta_sq / 24.0,
                    (1.0 - torch.cos(theta)) / _safe(is_small, theta_sq))
    b = torch.where(is_small, 1.0 / 6.0 - theta_sq / 120.0, (theta - torch.sin(theta)) / t3)
    return _eye_like(W) - a[..., None, None] * W + b[..., None, None] * W2


def right_jacobian_inv(w):
    """Inverse right Jacobian of SO(3)."""
    theta, theta_sq, is_small = _theta(w)
    W = hat(w)
    W2 = W @ W
    half_theta = 0.5 * theta
    cot_term = torch.where(
        is_small,
        1.0 / 12.0 + theta_sq / 720.0,
        torch.reciprocal(_safe(is_small, theta_sq))
        * (1.0 - half_theta * torch.cos(half_theta)
           / torch.where(is_small, torch.ones_like(half_theta), torch.sin(half_theta))),
    )
    return _eye_like(W) + 0.5 * W + cot_term[..., None, None] * W2
