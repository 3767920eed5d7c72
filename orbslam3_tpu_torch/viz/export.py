"""Offline trajectory / map export.

Copy of orbslam3_tpu/viz/export.py: TUM-format trajectories (consumable by
evo / rpg-eval tooling) and PLY point clouds, from host arrays and the
port's MapState.
"""
from __future__ import annotations

import numpy as np
import torch


def _host(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def save_trajectory_tum(path: str, ts, ps, qs):
    """TUM format: `t x y z qx qy qz qw` per line (quaternion xyzw order)."""
    with open(path, "w") as f:
        for t, p, q in zip(ts, ps, qs):
            w, x, y, z = q
            f.write(
                f"{t:.6f} {p[0]:.6f} {p[1]:.6f} {p[2]:.6f} "
                f"{x:.6f} {y:.6f} {z:.6f} {w:.6f}\n"
            )


def save_map_ply(path: str, map_state):
    """Dump valid map points (and keyframe positions as red vertices)."""
    mp = _host(map_state.mp_pos)[_host(map_state.mp_valid)]
    kf = _host(map_state.kf_p)[_host(map_state.kf_valid)]
    n = len(mp) + len(kf)
    with open(path, "w") as f:
        f.write(
            "ply\nformat ascii 1.0\n"
            f"element vertex {n}\n"
            "property float x\nproperty float y\nproperty float z\n"
            "property uchar red\nproperty uchar green\nproperty uchar blue\n"
            "end_header\n"
        )
        for p in mp:
            f.write(f"{p[0]:.4f} {p[1]:.4f} {p[2]:.4f} 200 200 200\n")
        for p in kf:
            f.write(f"{p[0]:.4f} {p[1]:.4f} {p[2]:.4f} 255 40 40\n")
