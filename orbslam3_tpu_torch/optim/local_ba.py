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

`VisualEdges` holds the visual half (residuals, cost, the reduced camera
system); optim/vi_ba.py builds its 15-dof system on the same object.
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


class VisualEdges:
    """The visual edges of a window problem (BAProblem or VIBAProblem: C
    cameras x N features, P points) and what both solvers build from them:
    residuals, the truncated Huber cost, and the camera system reduced over
    the points by a Schur complement. Every sum runs in a fixed order."""

    def __init__(self, prob, cam: Camera):
        C, N = prob.obs_pt.shape
        P = prob.Xw.shape[0]
        E = C * N
        dev = prob.q.device
        f32 = torch.float32
        self.C, self.N, self.P = C, N, P
        self.e_cam = torch.arange(C, device=dev).repeat_interleave(N)
        e_pt = prob.obs_pt.reshape(-1).long()
        self.e_uv = prob.obs_uv.reshape(E, 2)
        self.e_ur = prob.obs_ur.reshape(E)
        self.e_valid = ((e_pt >= 0) & prob.cam_valid[self.e_cam]
                        & prob.pt_valid[e_pt.clamp(0, P - 1)])
        self.e_pt_safe = torch.where(self.e_valid, e_pt, torch.zeros_like(e_pt))
        self.e_validf = self.e_valid.to(f32)
        self.s2inv = robust.octave_sigma2_inv(prob.obs_oct.reshape(E))
        self.delta2 = robust.chi2_gate(self.e_ur)
        self.zero6 = torch.zeros(6, dtype=f32, device=dev)
        self.zero3 = torch.zeros(3, dtype=f32, device=dev)
        self.opt_e = prob.opt_cam[self.e_cam].to(f32)[:, None, None]
        self.eye3 = torch.eye(3, dtype=f32, device=dev)
        self.cam_ar = torch.arange(C, device=dev)
        self.pt_has_obs = _scatter_sum(P, self.e_pt_safe, self.e_validf) > 0
        self.upd_pt = (prob.pt_valid & self.pt_has_obs)[:, None]

        self._res = vmap(
            lambda a, b, q0, p0, X0, uv, ur: _edge_residual(a, b, q0, p0, X0, uv, ur, cam),
            in_dims=(None, None, 0, 0, 0, 0, 0))

        def both(a, b, q0, p0, X0, uv, ur):
            r = _edge_residual(a, b, q0, p0, X0, uv, ur, cam)
            return r, r

        self._jac = vmap(jacfwd(both, argnums=(0, 1), has_aux=True),
                         in_dims=(None, None, 0, 0, 0, 0, 0))

    def cutoff_mults(self, iters: int):
        return torch.clamp(1e4 * 0.3 ** torch.arange(iters, dtype=torch.float32,
                                                     device=self.zero6.device), min=16.0)

    def residuals(self, q, p, Xw):
        return self._res(self.zero6, self.zero3, q[self.e_cam], p[self.e_cam], Xw[self.e_pt_safe],
                         self.e_uv, self.e_ur)

    def chi2(self, r):
        return torch.sum(r * r, -1) * self.s2inv

    def hub_cost(self, chi2, hub_cap):
        """Truncated Huber cost: constant beyond the cutoff, so outliers
        cannot steer the accept/reject test."""
        d2 = self.delta2
        hub = torch.where(chi2 <= d2, chi2,
                          2.0 * torch.sqrt(d2 * torch.clamp(chi2, min=1e-12)) - d2)
        return torch.sum(torch.minimum(hub, hub_cap) * self.e_validf)

    def cost(self, q, p, Xw, cutoff_mult):
        d2 = self.delta2
        return self.hub_cost(self.chi2(self.residuals(q, p, Xw)),
                             2.0 * torch.sqrt(d2 * cutoff_mult * d2) - d2)

    def reduced_system(self, q, p, Xw, damping, cutoff_mult):
        """One linearization at (q, p, Xw). Returns (S (6C, 6C), b (6C,),
        the cost at this state under this cutoff, and a function mapping the
        camera step dxc (6C,) to the point step (P, 3))."""
        C, N, P = self.C, self.N, self.P
        f32 = torch.float32
        cutoff2 = cutoff_mult * self.delta2
        (Jc, Jp), r = self._jac(self.zero6, self.zero3, q[self.e_cam], p[self.e_cam],
                                Xw[self.e_pt_safe], self.e_uv, self.e_ur)  # (E,3,6), (E,3,3)
        chi2 = self.chi2(r)
        old_cost = self.hub_cost(chi2, 2.0 * torch.sqrt(self.delta2 * cutoff2) - self.delta2)
        w = (robust.huber_weight(chi2, self.delta2) * (chi2 <= cutoff2).to(f32) * self.s2inv
             * self.e_validf)
        Jc = Jc * self.opt_e
        Jc_w = Jc * w[:, None, None]
        Jp_w = Jp * w[:, None, None]

        # edge e belongs to camera e // N
        Hcc = torch.einsum("eij,eik->ejk", Jc_w, Jc).reshape(C, N, 6, 6).sum(1)
        bc = torch.einsum("eij,ei->ej", Jc_w, r).reshape(C, N, 6).sum(1)
        Hpp = _scatter_sum(P, self.e_pt_safe, torch.einsum("eij,eik->ejk", Jp_w, Jp))
        bp = _scatter_sum(P, self.e_pt_safe, torch.einsum("eij,ei->ej", Jp_w, r))
        Wcp = torch.einsum("eij,eik->ejk", Jc_w, Jp)  # (E, 6, 3)
        Wstack = _scatter_sum(P * C, self.e_pt_safe * C + self.e_cam, Wcp).reshape(P, C * 6, 3)

        # scale-relative damping keeps rank-deficient point blocks invertible in float32
        lam = damping
        tr = (Hpp[:, 0, 0] + Hpp[:, 1, 1] + Hpp[:, 2, 2]) / 3.0
        Hpp_d = Hpp + self.eye3[None] * (lam + torch.clamp(lam, min=1e-5) * tr
                                         + 1e-6)[:, None, None]
        Hpp_inv = torch.linalg.inv_ex(Hpp_d)[0]
        Hpp_inv = torch.where(self.pt_has_obs[:, None, None], Hpp_inv, torch.zeros_like(Hpp_inv))

        Hcc_full = torch.zeros((C, 6, C, 6), dtype=f32, device=q.device)
        Hcc_full[self.cam_ar, :, self.cam_ar, :] = Hcc
        Hcc_full = Hcc_full.reshape(C * 6, C * 6)
        WH = Wstack @ Hpp_inv  # (P, 6C, 3)
        WHW = WH.permute(1, 0, 2).reshape(C * 6, P * 3) @ \
            Wstack.permute(1, 0, 2).reshape(C * 6, P * 3).T
        S = Hcc_full - WHW
        b_red = bc.reshape(C * 6) - torch.einsum("pik,pk->i", WH, bp)

        def point_step(dxc):
            Wt_dxc = torch.einsum("pik,i->pk", Wstack, dxc)
            return -torch.einsum("pkl,pl->pk", Hpp_inv, bp + Wt_dxc)

        return S, b_red, old_cost, point_step


def solve_local_ba(prob: BAProblem, cam: Camera, iters: int = 10,
                   init_damping: float = 1e-4) -> BAResult:
    C, N = prob.obs_pt.shape
    dev = prob.q.device
    f32 = torch.float32
    ve = VisualEdges(prob, cam)
    cutoff_mults = ve.cutoff_mults(iters)

    free = (prob.opt_cam & prob.cam_valid).to(f32)
    free6 = free.repeat_interleave(6)
    eyeC = torch.eye(C * 6, dtype=f32, device=dev)

    q, p, Xw = prob.q, prob.p, prob.Xw
    damping = torch.tensor(init_damping, dtype=f32, device=dev)
    cost = ve.cost(q, p, Xw, torch.tensor(16.0, dtype=f32, device=dev))
    cost0 = cost
    for it in range(iters):
        cutoff_mult = cutoff_mults[it]
        S, b_red, old_cost, point_step = ve.reduced_system(q, p, Xw, damping, cutoff_mult)

        S = S * free6[:, None] * free6[None, :] + torch.diag(1.0 - free6)
        S = S + eyeC * damping
        b_red = b_red * free6
        d = torch.sqrt(torch.clamp(torch.diagonal(S), min=1e-8))
        S_n = S / d[:, None] / d[None, :]
        dxc = -torch.linalg.solve_ex(S_n, (b_red / d)[:, None])[0][:, 0] / d
        dxp = point_step(dxc)

        q_new, p_new = _retract(q, p, dxc.reshape(C, 6))
        Xw_new = torch.where(ve.upd_pt, Xw + dxp, Xw)
        new_cost = ve.cost(q_new, p_new, Xw_new, cutoff_mult)
        accept = new_cost < old_cost
        q = torch.where(accept, q_new, q)
        p = torch.where(accept, p_new, p)
        Xw = torch.where(accept, Xw_new, Xw)
        damping = torch.where(accept, torch.clamp(damping * 0.5, min=1e-6), damping * 4.0)
        cost = torch.where(accept, new_cost, old_cost)

    inl = (ve.chi2(ve.residuals(q, p, Xw)) <= ve.delta2) & ve.e_valid
    return BAResult(q, p, Xw, cost0, cost, inl.reshape(C, N))
