"""Unit quaternions (wxyz) as flat tensors — the rotation storage format.

Port of orbslam3_tpu/geometry/quat.py. All ops broadcast over leading dims.
The *_np helpers are the host-side float64 numpy variants.
"""
from __future__ import annotations

import numpy as np
import torch

from orbslam3_tpu_torch.geometry import so3

_EPS = 1e-8


def identity(shape=(), dtype=torch.float32, device=None):
    q = torch.zeros(tuple(shape) + (4,), dtype=dtype, device=device)
    q[..., 0] = 1.0
    return q


def normalize(q):
    return q / torch.linalg.norm(q, dim=-1, keepdim=True).clamp(min=_EPS)


def mul(q1, q2):
    """Hamilton product (wxyz)."""
    w1, x1, y1, z1 = q1[..., 0], q1[..., 1], q1[..., 2], q1[..., 3]
    w2, x2, y2, z2 = q2[..., 0], q2[..., 1], q2[..., 2], q2[..., 3]
    return torch.stack(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ],
        dim=-1,
    )


def conj(q):
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def _cross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def rotate(q, v):
    """Rotate vectors v (..., 3) by quaternions q (..., 4)."""
    qv = q[..., 1:]
    w = q[..., :1]
    t = 2.0 * _cross(qv, v)
    return v + w * t + _cross(qv, t)


def from_axis_angle(w):
    """Rotation vector (..., 3) -> quaternion (..., 4)."""
    theta_sq = torch.sum(w * w, dim=-1, keepdim=True)
    is_small = theta_sq < 1e-12
    theta = torch.sqrt(torch.where(is_small, torch.ones_like(theta_sq), theta_sq))
    theta = torch.where(is_small, torch.zeros_like(theta), theta)
    half = 0.5 * theta
    k = torch.where(is_small, 0.5 - theta_sq / 48.0,
                    torch.sin(half) / torch.where(is_small, torch.ones_like(theta), theta))
    return torch.cat([torch.cos(half), k * w], dim=-1)


def to_axis_angle(q):
    """Quaternion (..., 4) -> rotation vector (..., 3).

    Scalars per quaternion are kept as (..., 1): torch.func.jacfwd gives a
    0-d float32 tensor times a Python scalar a float64 tangent."""
    q = torch.where(q[..., :1] < 0, -q, q)  # shortest arc
    w = torch.clamp(q[..., :1], -1.0, 1.0)
    vn_sq = torch.sum(q[..., 1:] ** 2, dim=-1, keepdim=True)
    is_small = vn_sq < 1e-14
    vn = torch.sqrt(torch.where(is_small, torch.ones_like(vn_sq), vn_sq))
    vn = torch.where(is_small, torch.zeros_like(vn), vn)
    theta = 2.0 * torch.atan2(vn, w)
    k = torch.where(is_small, 2.0 / torch.where(w == 0, torch.ones_like(w), w),
                    theta / torch.where(is_small, torch.ones_like(vn), vn))
    return k * q[..., 1:]


def to_matrix(q):
    """Quaternion (..., 4) -> rotation matrix (..., 3, 3)."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r00 = 1 - 2 * (y * y + z * z)
    r01 = 2 * (x * y - w * z)
    r02 = 2 * (x * z + w * y)
    r10 = 2 * (x * y + w * z)
    r11 = 1 - 2 * (x * x + z * z)
    r12 = 2 * (y * z - w * x)
    r20 = 2 * (x * z - w * y)
    r21 = 2 * (y * z + w * x)
    r22 = 1 - 2 * (x * x + y * y)
    return torch.stack(
        [
            torch.stack([r00, r01, r02], dim=-1),
            torch.stack([r10, r11, r12], dim=-1),
            torch.stack([r20, r21, r22], dim=-1),
        ],
        dim=-2,
    )


def from_matrix(R):
    """Rotation matrix (..., 3, 3) -> quaternion (..., 4) via Shepperd."""
    return so3.matrix_to_quat(R)


# ---------------------------------------------------------------------------
# Pure-numpy host-side variants (float64): synthetic data and evaluation.


def to_matrix_np(q):
    """(..., 4) wxyz -> (..., 3, 3) rotation matrices, pure numpy."""
    q = np.asarray(q)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    R = np.empty(q.shape[:-1] + (3, 3), q.dtype)
    R[..., 0, 0] = 1 - 2 * (y * y + z * z)
    R[..., 0, 1] = 2 * (x * y - w * z)
    R[..., 0, 2] = 2 * (x * z + w * y)
    R[..., 1, 0] = 2 * (x * y + w * z)
    R[..., 1, 1] = 1 - 2 * (x * x + z * z)
    R[..., 1, 2] = 2 * (y * z - w * x)
    R[..., 2, 0] = 2 * (x * z - w * y)
    R[..., 2, 1] = 2 * (y * z + w * x)
    R[..., 2, 2] = 1 - 2 * (x * x + y * y)
    return R


def from_matrix_np(R):
    """Single (3, 3) rotation matrix -> unit quaternion (4,) wxyz (Shepperd,
    largest-pivot branch)."""
    R = np.asarray(R, np.float64)
    w2 = 1.0 + R[0, 0] + R[1, 1] + R[2, 2]
    x2 = 1.0 + R[0, 0] - R[1, 1] - R[2, 2]
    y2 = 1.0 - R[0, 0] + R[1, 1] - R[2, 2]
    z2 = 1.0 - R[0, 0] - R[1, 1] + R[2, 2]
    m = max(w2, x2, y2, z2)
    if m == w2:
        w = 0.5 * np.sqrt(w2)
        q = [w, (R[2, 1] - R[1, 2]) / (4 * w), (R[0, 2] - R[2, 0]) / (4 * w),
             (R[1, 0] - R[0, 1]) / (4 * w)]
    elif m == x2:
        x = 0.5 * np.sqrt(x2)
        q = [(R[2, 1] - R[1, 2]) / (4 * x), x, (R[0, 1] + R[1, 0]) / (4 * x),
             (R[0, 2] + R[2, 0]) / (4 * x)]
    elif m == y2:
        y = 0.5 * np.sqrt(y2)
        q = [(R[0, 2] - R[2, 0]) / (4 * y), (R[0, 1] + R[1, 0]) / (4 * y), y,
             (R[1, 2] + R[2, 1]) / (4 * y)]
    else:
        z = 0.5 * np.sqrt(z2)
        q = [(R[1, 0] - R[0, 1]) / (4 * z), (R[0, 2] + R[2, 0]) / (4 * z),
             (R[1, 2] + R[2, 1]) / (4 * z), z]
    q = np.asarray(q, np.float64)
    return q / np.linalg.norm(q)
