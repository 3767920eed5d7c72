"""Pinhole stereo camera model + body-camera extrinsics.

Port of orbslam3_tpu/frontend/camera.py. The intrinsics are 0-d float32
tensors on the camera's device, so every expression that mixes them with
config constants rounds as the JAX package's float32 scalars do.
`q_bc is None` is the identity extrinsic (body == left camera).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class Camera(NamedTuple):
    fx: torch.Tensor
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor
    bf: torch.Tensor  # baseline * fx  [px * m]
    width: int = 752
    height: int = 480
    # T_BC: camera pose in the body frame (X_body = R(q_bc) X_cam + p_bc).
    q_bc: Optional[torch.Tensor] = None  # (4,) wxyz
    p_bc: Optional[torch.Tensor] = None  # (3,)

    @staticmethod
    def create(fx, fy, cx, cy, baseline, width=752, height=480,
               q_bc=None, p_bc=None, device=None) -> "Camera":
        def f(x):
            return torch.tensor(float(x), dtype=torch.float32, device=device)

        if p_bc is not None and q_bc is None:
            q_bc = (1.0, 0.0, 0.0, 0.0)
        if q_bc is not None:
            q_bc = torch.as_tensor(q_bc, dtype=torch.float32).to(device)
            p_bc = (torch.zeros(3, dtype=torch.float32, device=device) if p_bc is None
                    else torch.as_tensor(p_bc, dtype=torch.float32).to(device))
        return Camera(f(fx), f(fy), f(cx), f(cy), f(baseline * fx), width, height,
                      q_bc, p_bc)

    def to(self, device) -> "Camera":
        mv = (lambda x: None if x is None else x.to(device))
        return self._replace(fx=mv(self.fx), fy=mv(self.fy), cx=mv(self.cx),
                             cy=mv(self.cy), bf=mv(self.bf), q_bc=mv(self.q_bc),
                             p_bc=mv(self.p_bc))

    # ---- extrinsics -------------------------------------------------
    def body_to_cam_pose(self, q_wb, p_wb):
        """World camera pose (q_wc, p_wc) for a world body pose."""
        if self.q_bc is None:
            return q_wb, p_wb
        from orbslam3_tpu_torch.geometry import quat

        q_wc = quat.normalize(quat.mul(q_wb, self.q_bc))
        p_wc = p_wb + quat.rotate(q_wb, self.p_bc.expand(p_wb.shape))
        return q_wc, p_wc

    def cam_pts_to_body(self, xc):
        """Camera-frame points (..., 3) -> body-frame points."""
        if self.q_bc is None:
            return xc
        from orbslam3_tpu_torch.geometry import quat

        return quat.rotate(self.q_bc.expand(xc.shape[:-1] + (4,)), xc) + self.p_bc

    @property
    def baseline(self):
        return self.bf / self.fx

    def project(self, xc):
        """Camera-frame points (..., 3) -> pixel (..., 2); no validity check."""
        z = xc[..., 2]
        z_safe = torch.where(torch.abs(z) > 1e-6, z, torch.full_like(z, 1e-6))
        u = self.fx * xc[..., 0] / z_safe + self.cx
        v = self.fy * xc[..., 1] / z_safe + self.cy
        return torch.stack([u, v], dim=-1)

    def unproject(self, uv, z):
        """Pixels (..., 2) + depth (...,) -> camera-frame points (..., 3)."""
        x = (uv[..., 0] - self.cx) / self.fx * z
        y = (uv[..., 1] - self.cy) / self.fy * z
        return torch.stack([x, y, z], dim=-1)

    def in_view(self, uv, margin=0.0):
        u, v = uv[..., 0], uv[..., 1]
        return (u >= margin) & (u < self.width - margin) & (v >= margin) & (v < self.height - margin)
