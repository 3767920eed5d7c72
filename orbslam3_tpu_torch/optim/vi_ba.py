"""Visual-inertial local bundle adjustment (15-dof keyframe states).

Port of orbslam3_tpu/optim/vi_ba.py: a temporal window of keyframes, each
with pose 6 + velocity 3 + gyro/accel bias 6; visual edges, 9-D
preintegration edges and bias random-walk edges between consecutive slots;
points eliminated by a Schur complement; cost-guarded steps with adaptive
damping. The IMU edge stored on slot c preintegrates c-1 -> c.

What differs from the JAX module, with the same numbers to float32
rounding:

* the visual Jacobian is taken w.r.t. the 6 pose entries only. The other 9
  columns of the JAX module's 15-column Jacobian are exact zeros, so the
  visual part of the reduced system is the (6C, 6C) Schur complement of
  optim/local_ba.py::VisualEdges, embedded into the (15C, 15C) system;
* the bias random-walk edge is linear, so its Jacobians are written down
  (-+ sqrt(weight) on the bias columns) instead of differentiated;
* the IMU and bias blocks go into the reduced system through one-hot
  selection matrices and an einsum instead of scatter-adds, so slot 0,
  which is both "c-1" of edge 1 and "c-1" of the masked edge 0, sums both
  and no sum depends on the order in which lanes arrive.

Every sum runs in an order that is the same from run to run (see
optim/local_ba.py): the accept/reject test turns a last-bit difference
into a whole damped step.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import jacfwd, vmap

from orbslam3_tpu_torch.frontend.camera import Camera
from orbslam3_tpu_torch.imu import preintegration as pre
from orbslam3_tpu_torch.optim.local_ba import VisualEdges
from orbslam3_tpu_torch.optim.pose_only import _retract

D = 15  # per-keyframe state dim


class VIBAProblem(NamedTuple):
    q: torch.Tensor  # (C, 4)
    p: torch.Tensor  # (C, 3)
    v: torch.Tensor  # (C, 3)
    bg: torch.Tensor  # (C, 3)
    ba: torch.Tensor  # (C, 3)
    opt_cam: torch.Tensor  # (C,)
    cam_valid: torch.Tensor  # (C,)
    Xw: torch.Tensor  # (P, 3)
    pt_valid: torch.Tensor  # (P,)
    obs_uv: torch.Tensor  # (C, N, 2)
    obs_ur: torch.Tensor  # (C, N)
    obs_oct: torch.Tensor  # (C, N)
    obs_pt: torch.Tensor  # (C, N)
    preint: pre.PreintState  # batched (C,) — edge c-1 -> c
    imu_edge_valid: torch.Tensor  # (C,)
    gravity_w: torch.Tensor  # (3,)


class VIBAResult(NamedTuple):
    q: torch.Tensor
    p: torch.Tensor
    v: torch.Tensor
    bg: torch.Tensor
    ba: torch.Tensor
    Xw: torch.Tensor
    cost0: torch.Tensor
    cost1: torch.Tensor


def _apply_delta(q, p, v, bg, ba, dx):
    """dx: (..., 15) = [pose 6, dv 3, dbg 3, dba 3]."""
    q2, p2 = _retract(q, p, dx[..., 0:6])
    return q2, p2, v + dx[..., 6:9], bg + dx[..., 9:12], ba + dx[..., 12:15]


def _edge_whitening(preint: pre.PreintState):
    """(C, 9, 9) Cholesky factors L of each edge's information matrix (with
    the reference-state floor of optim/pose_only.py); L.T whitens."""
    dev = preint.cov.device
    floor = torch.tensor([5e-3**2] * 3 + [0.05**2] * 3 + [0.02**2] * 3,
                         dtype=torch.float32, device=dev)
    cov9 = preint.cov[:, 0:9, 0:9]
    cov9 = 0.5 * (cov9 + cov9.transpose(-1, -2)) + torch.diag(floor)
    info = torch.linalg.inv_ex(cov9)[0]
    return torch.linalg.cholesky_ex(info + torch.eye(9, device=dev) * 1e-8)[0]


def _edge_blocks(sel, J, res):
    """Normal-equation blocks of C two-ended edges. sel (C, 2, C) holds, for
    each edge, the one-hot slot rows of its two ends; J (C, 2, R, D) the
    residual's Jacobians w.r.t. the two ends; res (C, R). Returns
    (sum_c J_c^T J_c scattered to (C, D, C, D), sum_c J_c^T r_c as (C, D)):
    every edge that touches a slot adds to it, two ends of one edge on the
    same slot included."""
    JS = torch.einsum("csa,csri->cari", sel, J)  # edge c's Jacobian row over all slots
    return torch.einsum("cari,cbrj->aibj", JS, JS), torch.einsum("cari,cr->ai", JS, res)


def solve_vi_ba(prob: VIBAProblem, cam: Camera, iters: int = 8, init_damping: float = 1e-4,
                bias_walk_weight: float = 1e2) -> VIBAResult:
    C = prob.obs_pt.shape[0]
    dev = prob.q.device
    f32 = torch.float32
    ve = VisualEdges(prob, cam)
    cutoff_mults = ve.cutoff_mults(iters)

    Ls = _edge_whitening(prob.preint)
    cs = torch.arange(C, device=dev)
    i_idx = (cs - 1).clamp(0, C - 1)
    imu_ok = prob.imu_edge_valid & (cs >= 1) & prob.cam_valid & torch.roll(prob.cam_valid, 1)
    imu_okf = imu_ok.to(f32)
    sqrt_bw = float(bias_walk_weight) ** 0.5
    zero15 = torch.zeros(D, dtype=f32, device=dev)

    # ---- IMU edge c: whitened 9-D preintegration residual between slots c-1 and c
    def imu_edge(xi_i, xi_j, st, L, qi, pi, vi, bgi, bai, qj, pj, vj, bgj, baj):
        qi, pi, vi, bgi, bai = _apply_delta(qi, pi, vi, bgi, bai, xi_i)
        qj, pj, vj, _, _ = _apply_delta(qj, pj, vj, bgj, baj, xi_j)
        # the edge uses the bias of the older keyframe
        r9 = pre.imu_residual(st, qi, vi, pi, qj, vj, pj, bgi, bai, gravity_w=prob.gravity_w)
        r = L.T @ r9
        return r, r

    imu_jac = vmap(jacfwd(imu_edge, argnums=(0, 1), has_aux=True),
                   in_dims=(None, None) + (0,) * 12)
    imu_res = vmap(lambda *a: imu_edge(*a)[0], in_dims=(None, None) + (0,) * 12)

    def imu_args(q, p, v, bg, ba):
        return (zero15, zero15, prob.preint, Ls, q[i_idx], p[i_idx], v[i_idx], bg[i_idx],
                ba[i_idx], q, p, v, bg, ba)

    def bias_res(bg, ba):
        return torch.cat([bg - bg[i_idx], ba - ba[i_idx]], dim=-1) * sqrt_bw

    def edge_costs(ri, rb):
        return (torch.sum(torch.sum(ri * ri, -1) * imu_okf)
                + torch.sum(torch.sum(rb * rb, -1) * imu_okf))

    def state_cost(q, p, v, bg, ba, Xw, cutoff_mult):
        return (ve.cost(q, p, Xw, cutoff_mult)
                + edge_costs(imu_res(*imu_args(q, p, v, bg, ba)), bias_res(bg, ba)))

    # ---- constants of the assembly
    opt_f = prob.opt_cam.to(f32)
    free = (prob.opt_cam & prob.cam_valid).to(f32)
    freeD = free.repeat_interleave(D)
    eyeCD = torch.eye(C * D, dtype=f32, device=dev)
    # sel[c, 0] is the one-hot row of slot c-1 (clamped), sel[c, 1] that of slot c
    eyeC = torch.eye(C, dtype=f32, device=dev)
    sel = torch.stack([eyeC[i_idx], eyeC], dim=1)  # (C, 2, C)
    w_side = torch.stack([imu_okf * opt_f[i_idx], imu_okf * opt_f], dim=1)  # (C, 2)
    # bias random-walk Jacobians: d r / d xi_i = -sqrt(w) on columns 9:15, +sqrt(w) for xi_j
    Jb1 = torch.zeros((6, D), dtype=f32, device=dev)
    Jb1[:, 9:15] = torch.eye(6, dtype=f32, device=dev) * sqrt_bw
    Jb = torch.stack([-Jb1, Jb1])[None] * w_side[:, :, None, None]  # (C, 2, 6, 15)

    q, p, v, bg, ba, Xw = prob.q, prob.p, prob.v, prob.bg, prob.ba, prob.Xw
    damping = torch.tensor(init_damping, dtype=f32, device=dev)
    cost0 = state_cost(q, p, v, bg, ba, Xw, torch.tensor(16.0, dtype=f32, device=dev))
    cost = cost0
    for it in range(iters):
        cutoff_mult = cutoff_mults[it]

        # ---- visual edges: the (6C, 6C) reduced system, embedded into (15C, 15C)
        S6, b6, old_cost_vis, point_step = ve.reduced_system(q, p, Xw, damping, cutoff_mult)
        S = torch.zeros((C, D, C, D), dtype=f32, device=dev)
        S[:, 0:6, :, 0:6] = S6.reshape(C, 6, C, 6)
        b = torch.zeros((C, D), dtype=f32, device=dev)
        b[:, 0:6] = b6.reshape(C, 6)

        # ---- IMU + bias edges straight into S (cam-cam blocks)
        (Ji, Jj), ri = imu_jac(*imu_args(q, p, v, bg, ba))  # (C, 9, 15) each, (C, 9)
        rb = bias_res(bg, ba)
        Jimu = torch.stack([Ji, Jj], dim=1) * w_side[:, :, None, None]  # (C, 2, 9, 15)
        for J, res in ((Jimu, ri), (Jb, rb)):
            S_add, b_add = _edge_blocks(sel, J, res)
            S = S + S_add
            b = b + b_add
        S = S.reshape(C * D, C * D)
        b = b.reshape(C * D)

        # ---- gauge + solve
        S = S * freeD[:, None] * freeD[None, :] + torch.diag(1.0 - freeD)
        S = S + eyeCD * damping
        dscale = torch.sqrt(torch.clamp(torch.diagonal(S), min=1e-8))
        S_n = S / dscale[:, None] / dscale[None, :]
        dxc = -torch.linalg.solve_ex(S_n, (b / dscale)[:, None])[0][:, 0] / dscale
        dxc = dxc.reshape(C, D)
        dxp = point_step(dxc[:, 0:6].reshape(C * 6))

        q2, p2, v2, bg2, ba2 = _apply_delta(q, p, v, bg, ba, dxc)
        Xw2 = torch.where(ve.upd_pt, Xw + dxp, Xw)

        old_cost = old_cost_vis + edge_costs(ri, rb)
        new_cost = state_cost(q2, p2, v2, bg2, ba2, Xw2, cutoff_mult)
        accept = new_cost < old_cost
        q, p, v, bg, ba, Xw = (torch.where(accept, n, o) for n, o in
                               ((q2, q), (p2, p), (v2, v), (bg2, bg), (ba2, ba), (Xw2, Xw)))
        damping = torch.where(accept, torch.clamp(damping * 0.5, min=1e-6), damping * 4.0)
        cost = torch.where(accept, new_cost, old_cost)

    return VIBAResult(q, p, v, bg, ba, Xw, cost0, cost)
