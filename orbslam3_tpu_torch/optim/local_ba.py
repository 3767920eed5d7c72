"""Local bundle adjustment with a Schur-complement reduced camera system.

Port of orbslam3_tpu/optim/local_ba.py: per-edge residuals and exact
forward-mode Jacobians over a fixed (C cams x N feats) edge grid; Hessian
blocks by scatter-add (duplicate edges accumulate); Schur reduction; a
Jacobi-preconditioned solve of the (6C, 6C) system; point back-substitution;
cost-guarded step acceptance with adaptive damping. The sums of the
scatter-adds run in another order than XLA's, so results agree with the
JAX package to float32 rounding, not bit for bit.

Every sum here runs in an order that is the same from run to run. The
accept/reject test on the cost turns a last-bit difference into a whole
damped step, so racing atomic adds (index_add on a CUDA tensor) made two
runs on the same frames end millimetres apart after one BA and diverge
over a sequence. Camera blocks are sums over each camera's contiguous run
of edges; point blocks go through `_scatter_sum`.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import jacfwd, vmap

from orbslam3_tpu_torch.frontend.camera import Camera
from orbslam3_tpu_torch.optim import robust
from orbslam3_tpu_torch.optim.pose_only import _retract, _visual_residual


class BAProblem(NamedTuple):
    """Fixed-shape local BA problem (C cams, P points, E = C*N edges)."""

    q: torch.Tensor  # (C, 4) body->world
    p: torch.Tensor  # (C, 3)
    opt_cam: torch.Tensor  # (C,) bool — False = fixed (anchor / boundary)
    cam_valid: torch.Tensor  # (C,) bool
    Xw: torch.Tensor  # (P, 3)
    pt_valid: torch.Tensor  # (P,) bool
    obs_uv: torch.Tensor  # (C, N, 2)
    obs_ur: torch.Tensor  # (C, N)
    obs_oct: torch.Tensor  # (C, N) int32
    obs_pt: torch.Tensor  # (C, N) int32 point slot (-1 = no edge)


class BAResult(NamedTuple):
    q: torch.Tensor
    p: torch.Tensor
    Xw: torch.Tensor
    cost0: torch.Tensor
    cost1: torch.Tensor
    inlier_edges: torch.Tensor  # (C, N) bool


def _scatter_sum(n: int, idx, vals):
    """(n, ...) sums of the rows of `vals` by `idx` (duplicates accumulate),
    in a fixed order: on a CUDA tensor index_put with accumulate sorts the
    indices and adds each run in turn instead of racing atomic adds; on the
    CPU index_add adds serially (and index_put would race threads)."""
    out = torch.zeros((n,) + vals.shape[1:], dtype=vals.dtype, device=vals.device)
    if vals.is_cuda:
        return out.index_put_((idx,), vals, accumulate=True)
    return out.index_add_(0, idx, vals)


def _edge_residual(xi_c, dxp, q0, p0, X0, uv, ur, cam):
    q, p = _retract(q0, p0, xi_c)
    return _visual_residual(torch.zeros_like(xi_c), q, p, cam, X0 + dxp, uv, ur)


def solve_local_ba(prob: BAProblem, cam: Camera, iters: int = 10,
                   init_damping: float = 1e-4) -> BAResult:
    C, N = prob.obs_pt.shape
    P = prob.Xw.shape[0]
    E = C * N
    dev = prob.q.device
    f32 = torch.float32

    e_cam = torch.arange(C, device=dev).repeat_interleave(N)
    e_pt = prob.obs_pt.reshape(-1).long()
    e_uv = prob.obs_uv.reshape(E, 2)
    e_ur = prob.obs_ur.reshape(E)
    e_oct = prob.obs_oct.reshape(E)
    e_valid = (e_pt >= 0) & prob.cam_valid[e_cam] & prob.pt_valid[e_pt.clamp(0, P - 1)]
    e_pt_safe = torch.where(e_valid, e_pt, torch.zeros_like(e_pt))
    e_validf = e_valid.to(f32)
    s2inv = robust.octave_sigma2_inv(e_oct)
    delta2 = robust.chi2_gate(e_ur)
    zero6 = torch.zeros(6, dtype=f32, device=dev)
    zero3 = torch.zeros(3, dtype=f32, device=dev)

    res_v = vmap(lambda a, b, q0, p0, X0, uv, ur: _edge_residual(a, b, q0, p0, X0, uv, ur, cam),
                 in_dims=(None, None, 0, 0, 0, 0, 0))

    def both(a, b, q0, p0, X0, uv, ur):
        r = _edge_residual(a, b, q0, p0, X0, uv, ur, cam)
        return r, r

    jac_v = vmap(jacfwd(both, argnums=(0, 1), has_aux=True), in_dims=(None, None, 0, 0, 0, 0, 0))

    def residuals(q, p, Xw):
        return res_v(zero6, zero3, q[e_cam], p[e_cam], Xw[e_pt_safe], e_uv, e_ur)

    cutoff_mults = torch.clamp(
        1e4 * 0.3 ** torch.arange(iters, dtype=f32, device=dev), min=16.0)

    def hub_cost(chi2, hub_cap):
        """Truncated Huber cost: constant beyond the cutoff, so outliers
        cannot steer the accept/reject test."""
        hub = torch.where(chi2 <= delta2, chi2,
                          2.0 * torch.sqrt(delta2 * torch.clamp(chi2, min=1e-12)) - delta2)
        return torch.sum(torch.minimum(hub, hub_cap) * e_validf)

    def cost_of(q, p, Xw, cutoff_mult):
        r = residuals(q, p, Xw)
        hub_cap = 2.0 * torch.sqrt(delta2 * cutoff_mult * delta2) - delta2
        return hub_cost(torch.sum(r * r, -1) * s2inv, hub_cap)

    free = (prob.opt_cam & prob.cam_valid).to(f32)
    free6 = free.repeat_interleave(6)
    opt_e = prob.opt_cam[e_cam].to(f32)[:, None, None]
    eye3 = torch.eye(3, dtype=f32, device=dev)
    eyeC = torch.eye(C * 6, dtype=f32, device=dev)
    cam_ar = torch.arange(C, device=dev)
    pt_has_obs = _scatter_sum(P, e_pt_safe, e_validf) > 0
    upd_pt = (prob.pt_valid & pt_has_obs)[:, None]

    q, p, Xw = prob.q, prob.p, prob.Xw
    damping = torch.tensor(init_damping, dtype=f32, device=dev)
    cost = cost_of(q, p, Xw, torch.tensor(16.0, dtype=f32, device=dev))
    cost0 = cost
    for it in range(iters):
        cutoff_mult = cutoff_mults[it]
        cutoff2 = cutoff_mult * delta2
        qe, pe, Xe = q[e_cam], p[e_cam], Xw[e_pt_safe]
        (Jc, Jp), r = jac_v(zero6, zero3, qe, pe, Xe, e_uv, e_ur)  # (E,3,6), (E,3,3)
        chi2 = torch.sum(r * r, -1) * s2inv
        old_cost = hub_cost(chi2, 2.0 * torch.sqrt(delta2 * cutoff2) - delta2)
        w = (robust.huber_weight(chi2, delta2) * (chi2 <= cutoff2).to(f32) * s2inv * e_validf)
        Jc = Jc * opt_e
        Jc_w = Jc * w[:, None, None]
        Jp_w = Jp * w[:, None, None]

        # edge e belongs to camera e // N
        Hcc = torch.einsum("eij,eik->ejk", Jc_w, Jc).reshape(C, N, 6, 6).sum(1)
        bc = torch.einsum("eij,ei->ej", Jc_w, r).reshape(C, N, 6).sum(1)
        Hpp = _scatter_sum(P, e_pt_safe, torch.einsum("eij,eik->ejk", Jp_w, Jp))
        bp = _scatter_sum(P, e_pt_safe, torch.einsum("eij,ei->ej", Jp_w, r))
        Wcp = torch.einsum("eij,eik->ejk", Jc_w, Jp)  # (E, 6, 3)
        Wstack = _scatter_sum(P * C, e_pt_safe * C + e_cam, Wcp).reshape(P, C * 6, 3)

        lam = damping
        tr = (Hpp[:, 0, 0] + Hpp[:, 1, 1] + Hpp[:, 2, 2]) / 3.0
        Hpp_d = Hpp + eye3[None] * (lam + torch.clamp(lam, min=1e-5) * tr + 1e-6)[:, None, None]
        Hpp_inv = torch.linalg.inv_ex(Hpp_d)[0]
        Hpp_inv = torch.where(pt_has_obs[:, None, None], Hpp_inv, torch.zeros_like(Hpp_inv))

        Hcc_full = torch.zeros((C, 6, C, 6), dtype=f32, device=dev)
        Hcc_full[cam_ar, :, cam_ar, :] = Hcc
        Hcc_full = Hcc_full.reshape(C * 6, C * 6)
        WH = Wstack @ Hpp_inv  # (P, 6C, 3)
        WHW = WH.permute(1, 0, 2).reshape(C * 6, P * 3) @ \
            Wstack.permute(1, 0, 2).reshape(C * 6, P * 3).T
        S = Hcc_full - WHW
        b_red = bc.reshape(C * 6) - torch.einsum("pik,pk->i", WH, bp)

        S = S * free6[:, None] * free6[None, :] + torch.diag(1.0 - free6)
        S = S + eyeC * lam
        b_red = b_red * free6
        d = torch.sqrt(torch.clamp(torch.diagonal(S), min=1e-8))
        S_n = S / d[:, None] / d[None, :]
        dxc = -torch.linalg.solve_ex(S_n, (b_red / d)[:, None])[0][:, 0] / d

        Wt_dxc = torch.einsum("pik,i->pk", Wstack, dxc)
        dxp = -torch.einsum("pkl,pl->pk", Hpp_inv, bp + Wt_dxc)

        q_new, p_new = _retract(q, p, dxc.reshape(C, 6))
        Xw_new = torch.where(upd_pt, Xw + dxp, Xw)
        new_cost = cost_of(q_new, p_new, Xw_new, cutoff_mult)
        accept = new_cost < old_cost
        q = torch.where(accept, q_new, q)
        p = torch.where(accept, p_new, p)
        Xw = torch.where(accept, Xw_new, Xw)
        damping = torch.where(accept, torch.clamp(damping * 0.5, min=1e-6), damping * 4.0)
        cost = torch.where(accept, new_cost, old_cost)

    r = residuals(q, p, Xw)
    chi2 = torch.sum(r * r, -1) * s2inv
    inl = (chi2 <= delta2) & e_valid
    return BAResult(q, p, Xw, cost0, cost, inl.reshape(C, N))
