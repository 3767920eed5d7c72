"""Sim(3) similarity transforms for loop closing / pose-graph optimization.

Port of orbslam3_tpu/geometry/sim3.py (compose, inverse, transform, 7-D
log/exp/retract). x_out = s * R(q) @ x + t.

The scale `s` has shape (...,): 0-d for a single transform. Every
expression that combines it with a Python scalar goes through a (..., 1)
view, because torch.func.jacfwd gives a 0-d float32 tensor times a Python
scalar a float64 tangent.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from orbslam3_tpu_torch.geometry import quat, so3
from orbslam3_tpu_torch.geometry.se3 import SE3


class Sim3(NamedTuple):
    q: torch.Tensor  # (..., 4)
    t: torch.Tensor  # (..., 3)
    s: torch.Tensor  # (...,) scale

    @staticmethod
    def identity(shape=(), dtype=torch.float32, device=None) -> "Sim3":
        return Sim3(quat.identity(shape, dtype, device),
                    torch.zeros(tuple(shape) + (3,), dtype=dtype, device=device),
                    torch.ones(tuple(shape), dtype=dtype, device=device))

    @staticmethod
    def from_se3(T: SE3, s=None) -> "Sim3":
        scale = (torch.ones(T.q.shape[:-1], dtype=T.q.dtype, device=T.q.device) if s is None
                 else torch.as_tensor(s, dtype=T.q.dtype, device=T.q.device))
        return Sim3(T.q, T.t, scale)

    def to_se3(self) -> SE3:
        """Drop the scale (used when applying corrections to keyframe poses)."""
        return SE3(self.q, self.t)

    def apply(self, x):
        return self.s[..., None] * quat.rotate(self.q, x) + self.t

    def compose(self, other: "Sim3") -> "Sim3":
        return Sim3(quat.normalize(quat.mul(self.q, other.q)),
                    self.s[..., None] * quat.rotate(self.q, other.t) + self.t,
                    self.s * other.s)

    def inverse(self) -> "Sim3":
        qi = quat.conj(self.q)
        si = torch.reciprocal(self.s[..., None])
        return Sim3(qi, -si * quat.rotate(qi, self.t), si[..., 0])

    def log(self):
        """(..., 7) = [nu(3), phi(3), sigma(1)] with sigma = log s."""
        phi = quat.to_axis_angle(self.q)
        sigma = torch.log(self.s[..., None])
        W = _sim3_W(phi, sigma)
        nu = (torch.linalg.inv(W) @ self.t[..., None])[..., 0]
        return torch.cat([nu, phi, sigma], dim=-1)

    @staticmethod
    def exp(xi) -> "Sim3":
        nu, phi, sigma = xi[..., 0:3], xi[..., 3:6], xi[..., 6:7]
        W = _sim3_W(phi, sigma)
        return Sim3(quat.from_axis_angle(phi), (W @ nu[..., None])[..., 0],
                    torch.exp(sigma)[..., 0])

    def retract(self, xi) -> "Sim3":
        return self.compose(Sim3.exp(xi))


def _sim3_W(phi, sigma):
    """The W matrix of the Sim(3) exponential (Strasdat's thesis, eq. 5.73);
    phi (..., 3), sigma (..., 1).

    W = C*I + A*hat(phi) + B*hat(phi)^2 with, in the generic-theta branch,
        s = e^sigma, a = s*sin(theta), b = s*cos(theta), c = theta^2 + sigma^2
        C = (s - 1)/sigma
        A = (a*sigma + (1 - b)*theta) / (theta * c)
        B = (C - ((b - 1)*sigma + a*theta)/c) / theta^2
    and Taylor fallbacks at small theta / small sigma, selected by
    torch.where over safe operands."""
    theta_sq = torch.sum(phi * phi, dim=-1, keepdim=True)
    one = torch.ones_like(theta_sq)
    small_t = theta_sq < 1e-10
    theta = torch.sqrt(torch.where(small_t, one, theta_sq))
    theta = torch.where(small_t, torch.zeros_like(theta), theta)
    small_s = torch.abs(sigma) < 1e-5
    s = torch.exp(sigma)
    sig_safe = torch.where(small_s, one, sigma)
    sig2 = sigma * sigma

    # C = (s - 1)/sigma, Taylor: 1 + sigma/2 + sigma^2/6
    C = torch.where(small_s, 1.0 + sigma / 2.0 + sig2 / 6.0, (s - 1.0) / sig_safe)

    th_safe = torch.where(small_t, one, theta)
    c_safe = torch.where(small_t, one, theta_sq + sig2)
    a = s * torch.sin(theta)
    b = s * torch.cos(theta)
    A_g = (a * sigma + (1.0 - b) * theta) / (th_safe * c_safe)
    B_g = (C - ((b - 1.0) * sigma + a * theta) / c_safe) / torch.where(small_t, one, theta_sq)

    # small-theta limits (exact in sigma, theta -> 0)
    A_s = torch.where(small_s, 0.5 + sigma / 3.0 + sig2 / 8.0,
                      ((sigma - 1.0) * s + 1.0) / torch.where(small_s, one, sig2))
    B_s = torch.where(small_s, 1.0 / 6.0 + sigma / 8.0,
                      ((0.5 * sig2 - sigma + 1.0) * s - 1.0)
                      / torch.where(small_s, one, sig2 * sig_safe))
    A = torch.where(small_t, A_s, A_g)
    B = torch.where(small_t, B_s, B_g)

    W = so3.hat(phi)
    W2 = W @ W
    eye = torch.eye(3, dtype=phi.dtype, device=phi.device).expand(W.shape)
    return C[..., None] * eye + A[..., None] * W + B[..., None] * W2
