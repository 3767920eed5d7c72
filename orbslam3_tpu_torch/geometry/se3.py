"""SE(3) poses as (quat wxyz, translation) pairs, batched over leading dims.

Port of orbslam3_tpu/geometry/se3.py: compose, inverse, transform, matrix
converters and the exp/log maps the solvers use. Branch-free like quat/so3,
so everything runs under torch.func.vmap/jacfwd.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from orbslam3_tpu_torch.geometry import quat, so3


class SE3(NamedTuple):
    """Rigid transform: x_out = R(q) @ x + t. Batched over leading dims."""

    q: torch.Tensor  # (..., 4) wxyz unit quaternion
    t: torch.Tensor  # (..., 3)

    @staticmethod
    def identity(shape=(), dtype=torch.float32, device=None) -> "SE3":
        return SE3(quat.identity(shape, dtype, device),
                   torch.zeros(tuple(shape) + (3,), dtype=dtype, device=device))

    def compose(self, other: "SE3") -> "SE3":
        """self o other: apply `other` first."""
        return SE3(quat.normalize(quat.mul(self.q, other.q)),
                   quat.rotate(self.q, other.t) + self.t)

    def inverse(self) -> "SE3":
        qi = quat.conj(self.q)
        return SE3(qi, -quat.rotate(qi, self.t))

    def apply(self, x):
        """Transform points x (..., 3)."""
        return quat.rotate(self.q, x) + self.t

    def rotation_matrix(self):
        return quat.to_matrix(self.q)

    def matrix(self):
        """(..., 4, 4) homogeneous matrix."""
        top = torch.cat([quat.to_matrix(self.q), self.t[..., None]], dim=-1)
        bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=top.dtype,
                              device=top.device).expand(top.shape[:-2] + (1, 4))
        return torch.cat([top, bottom], dim=-2)

    @staticmethod
    def from_matrix(T) -> "SE3":
        return SE3(quat.from_matrix(T[..., :3, :3]), T[..., :3, 3])

    def retract(self, xi) -> "SE3":
        """Right-multiplicative update with xi = (..., 6) = [rho, phi]:
        T' = T * (Exp(phi), rho), the solvers' local parameterization."""
        return self.compose(SE3(quat.from_axis_angle(xi[..., 3:6]), xi[..., 0:3]))

    def local(self, other: "SE3"):
        """xi such that other ~ self.retract(xi) (first order)."""
        d = self.inverse().compose(other)
        return torch.cat([d.t, quat.to_axis_angle(d.q)], dim=-1)

    @staticmethod
    def exp(xi) -> "SE3":
        """se(3) exp with xi = [rho, phi] (..., 6)."""
        phi = xi[..., 3:6]
        V = _left_jacobian_V(phi)
        return SE3(quat.from_axis_angle(phi), (V @ xi[..., 0:3, None])[..., 0])

    def log(self):
        """(..., 6) = [rho, phi]."""
        phi = quat.to_axis_angle(self.q)
        Vinv = torch.linalg.inv(_left_jacobian_V(phi))
        return torch.cat([(Vinv @ self.t[..., None])[..., 0], phi], dim=-1)


def _left_jacobian_V(phi):
    """SO(3) left Jacobian (the V matrix of SE(3) exp)."""
    # per-transform scalars stay (..., 1): see geometry/sim3.py on 0-d tensors under jacfwd
    theta_sq = torch.sum(phi * phi, dim=-1, keepdim=True)
    is_small = theta_sq < 1e-12
    one = torch.ones_like(theta_sq)
    theta = torch.sqrt(torch.where(is_small, one, theta_sq))
    theta = torch.where(is_small, torch.zeros_like(theta), theta)
    W = so3.hat(phi)
    W2 = W @ W
    a = torch.where(is_small, 0.5 - theta_sq / 24.0,
                    (1.0 - torch.cos(theta)) / torch.where(is_small, one, theta_sq))
    t3 = torch.where(is_small, one, theta_sq * theta)
    b = torch.where(is_small, 1.0 / 6.0 - theta_sq / 120.0, (theta - torch.sin(theta)) / t3)
    eye = torch.eye(3, dtype=phi.dtype, device=phi.device).expand(W.shape)
    return eye + a[..., None] * W + b[..., None] * W2
