"""Visual-inertial initialization: joint gravity / velocity / bias solve.

Port of orbslam3_tpu/optim/imu_init.py: dense Gauss-Newton over
x = [v_0..v_{W-1} (3W), bg (3), ba (3), g_w (3)] with exact forward-mode
Jacobians (torch.func.jacfwd over the whole residual function, which vmaps
over the W-1 edges inside) and preintegration-covariance whitening, in three
stages: (A) gyro bias from the rotation residuals alone, (B) the linear
solve for velocities, accelerometer bias and a free gravity vector, (C) a
polish with a soft ||g|| = 9.81 constraint. Each lax.scan is a Python loop.
Runs on the device of its inputs.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import jacfwd, vmap

from orbslam3_tpu_torch.geometry import quat
from orbslam3_tpu_torch.imu import preintegration as pre


class ImuInitResult(NamedTuple):
    vels: torch.Tensor  # (W, 3)
    bias_g: torch.Tensor  # (3,)
    bias_a: torch.Tensor  # (3,)
    gravity_w: torch.Tensor  # (3,)
    cost0: torch.Tensor
    cost1: torch.Tensor


def _gn_step(fn, x, damp: float):
    """x - (J^T J + damp I)^-1 J^T r for r = fn(x)."""
    J, r = jacfwd(lambda y: (fn(y),) * 2, has_aux=True)(x)
    H = J.T @ J + torch.eye(x.shape[0], dtype=x.dtype, device=x.device) * damp
    return x - torch.linalg.solve_ex(H, (J.T @ r)[:, None])[0][:, 0]


def inertial_init(qs, ps, preints: pre.PreintState, edge_valid, iters: int = 20,
                  w_bg_prior: float = 1e2, w_ba_prior: float = 1e3, w_gnorm: float = 1e3,
                  sigma_pose_rot: float = 5e-3, sigma_pose_vel: float = 0.05,
                  sigma_pose_pos: float = 0.02, prior_scale=1.0) -> ImuInitResult:
    """Solve for velocities, biases and world gravity from keyframe poses.

    qs, ps: (W, 4), (W, 3) keyframe poses from visual odometry; preints:
    PreintState with leading dim W-1, edge i connects keyframe i -> i+1;
    edge_valid: (W-1,) bool; prior_scale scales the bias priors (1.0 for the
    first initialization, smaller in the later refinements)."""
    W = qs.shape[0]
    dev = qs.device
    f32 = torch.float32
    ev = edge_valid.to(f32)[:, None]
    prior_scale = torch.clamp(torch.as_tensor(prior_scale, dtype=f32, device=dev), min=1e-2)

    # whitening from the preintegration covariance plus a floor for the
    # uncertainty of the visual poses themselves
    pose_cov = torch.diag(torch.tensor([sigma_pose_rot**2] * 3 + [sigma_pose_vel**2] * 3
                                       + [sigma_pose_pos**2] * 3, dtype=f32, device=dev))
    cov9 = preints.cov[:, 0:9, 0:9]
    cov9 = 0.5 * (cov9 + cov9.transpose(-1, -2)) + pose_cov
    info = torch.linalg.inv_ex(cov9)[0]
    Ls = torch.linalg.cholesky_ex(info + torch.eye(9, device=dev) * 1e-8)[0]  # (E, 9, 9)
    q_i, q_j, p_i, p_j = qs[:-1], qs[1:], ps[:-1], ps[1:]
    zero3 = torch.zeros(3, dtype=f32, device=dev)

    def unpack(x):
        return (x[: 3 * W].reshape(W, 3), x[3 * W: 3 * W + 3], x[3 * W + 3: 3 * W + 6],
                x[3 * W + 6: 3 * W + 9])

    # ---- stage A: gyro bias from rotation residuals only
    def rot_residuals(bg):
        def edge_rot(st, qi, qj):
            dq, _, _ = pre.bias_corrected_delta(st, bg, zero3)
            return quat.to_axis_angle(quat.mul(quat.conj(dq), quat.mul(quat.conj(qi), qj)))

        return (vmap(edge_rot)(preints, q_i, q_j) * ev).reshape(-1)

    bg0 = zero3
    for _ in range(5):
        bg0 = _gn_step(rot_residuals, bg0, 1e-6)

    # ---- stage B: with bg fixed and no gravity-norm constraint the v/p
    # residuals are linear in (v, ba, g): a Gauss-Newton step lands on the
    # global least-squares optimum
    x0 = torch.zeros(3 * W + 9, dtype=f32, device=dev)
    x0[3 * W: 3 * W + 3] = bg0

    def residuals_nonorm(x):
        v, bg, ba, g = unpack(x)

        def edge_res(st, L, qi, vi, pi, qj, vj, pj):
            return L.T @ pre.imu_residual(st, qi, vi, pi, qj, vj, pj, bg, ba, gravity_w=g)

        r_edges = vmap(edge_res)(preints, Ls, q_i, v[:-1], p_i, q_j, v[1:], p_j) * ev
        r_priors = torch.cat([(bg - bg0) * w_bg_prior, ba * w_ba_prior]) * prior_scale
        return torch.cat([r_edges.reshape(-1), r_priors])

    x1 = x0
    for _ in range(3):
        x1 = _gn_step(residuals_nonorm, x1, 1e-5)

    # ---- stage C: norm-constrained polish from the linear solution
    def residuals(x):
        # the norm stays 1-d: under jacfwd a 0-d float32 tensor combined with a
        # Python scalar gets a float64 tangent
        g_norm = torch.linalg.norm(x[3 * W + 6: 3 * W + 9].reshape(1, 3), dim=-1)
        return torch.cat([residuals_nonorm(x), (g_norm - 9.81) * w_gnorm])

    cost0 = torch.sum(residuals(x0) ** 2)
    x = x1
    for _ in range(iters):
        x = _gn_step(residuals, x, 1e-4)
    cost1 = torch.sum(residuals(x) ** 2)
    v, bg, ba, g = unpack(x)
    return ImuInitResult(v, bg, ba, g, cost0, cost1)
