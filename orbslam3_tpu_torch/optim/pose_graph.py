"""Essential-graph Sim3 pose-graph optimization.

Port of orbslam3_tpu/optim/pose_graph.py: Sim3 nodes, spanning-tree,
covisibility and loop edges, gauge anchors fixed, exact forward-mode
Jacobians of the 7-D edge residual.

Fixed-shape formulation: edges come as padded index/measurement arrays. The
edges' Jacobians are written into one dense (7E, 7K) matrix (each edge owns
its 7 rows, so no two writes meet) and the (7K, 7K) normal system is one
matrix product of it: several edges per node sum inside the product, in its
fixed order, never through atomic adds, so two runs give the same bits. One
solve per loop closure; K <= 256 keyframes is a 1792^2 dense system.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import jacfwd, vmap

from orbslam3_tpu_torch.geometry.sim3 import Sim3


class PoseGraphProblem(NamedTuple):
    nodes: Sim3  # batched (K,) initial node poses (world-from-body)
    node_valid: torch.Tensor  # (K,)
    node_fixed: torch.Tensor  # (K,) gauge anchors (at least one)
    e_i: torch.Tensor  # (E,) int32 edge endpoints
    e_j: torch.Tensor  # (E,)
    e_meas: Sim3  # batched (E,) measured S_ij = S_i^-1 S_j
    e_weight: torch.Tensor  # (E,) information weight
    e_valid: torch.Tensor  # (E,)


def edge_residual(S_i: Sim3, S_j: Sim3, S_meas: Sim3):
    """7-D residual log(S_meas^-1 * (S_i^-1 * S_j))."""
    rel = S_i.inverse().compose(S_j)
    return S_meas.inverse().compose(rel).log()


def _edge_r_wrt(dxi, dxj, qi, ti, si, qj, tj, sj, qm, tm, sm):
    """One edge's residual after retracting its two ends by dxi, dxj."""
    return edge_residual(Sim3(qi, ti, si).retract(dxi), Sim3(qj, tj, sj).retract(dxj),
                         Sim3(qm, tm, sm))


def solve_pose_graph(prob: PoseGraphProblem, iters: int = 12, fix_scale: bool = True,
                     scale_prior: float = 1e3):
    """Gauss-Newton over Sim3 node corrections. Returns (optimized batched
    Sim3 nodes, (iters,) cost before each step)."""
    K = prob.node_valid.shape[0]
    E = prob.e_i.shape[0]
    D = 7
    dev = prob.node_valid.device
    f32 = torch.float32
    e_i, e_j = prob.e_i.long(), prob.e_j.long()
    es = torch.arange(E, device=dev)
    free = (prob.node_valid & ~prob.node_fixed).to(f32)
    freeD = free.repeat_interleave(D)
    w = prob.e_weight * prob.e_valid.to(f32)
    zero = torch.zeros((E, D), dtype=f32, device=dev)
    eyeKD = torch.eye(K * D, dtype=f32, device=dev)
    sidx = torch.arange(K, device=dev) * D + 6
    residual_and_jacobians = vmap(lambda *a: (_edge_r_wrt(*a), jacfwd(_edge_r_wrt, (0, 1))(*a)))

    nodes = prob.nodes
    costs = []
    for _ in range(iters):
        ends = [a[e] for e in (e_i, e_j) for a in nodes]
        r, (Ji, Jj) = residual_and_jacobians(zero, zero, *ends, *prob.e_meas)  # (E,7), (E,7,7) x2

        # the whole graph's Jacobian: edge e's rows hold Ji at node e_i's
        # columns and Jj at node e_j's (summed where both ends are one node)
        Ja = torch.zeros((E, D, K, D), dtype=f32, device=dev)
        Jb = torch.zeros_like(Ja)
        Ja[es, :, e_i, :] = Ji
        Jb[es, :, e_j, :] = Jj
        J = (Ja + Jb).reshape(E * D, K * D)
        Jw = J * w.repeat_interleave(D)[:, None]
        H = Jw.T @ J
        b = Jw.T @ r.reshape(E * D)
        if fix_scale:
            # strong prior keeping sigma (the 7th coordinate) at zero
            H[sidx, sidx] += scale_prior

        H = H * freeD[:, None] * freeD[None, :] + torch.diag(1.0 - freeD)
        H = H + eyeKD * 1e-5
        b = b * freeD
        d = torch.sqrt(torch.clamp(torch.diagonal(H), min=1e-9))
        dx = -(torch.linalg.solve(H / d[:, None] / d[None, :], b / d) / d)
        # fixed and invalid nodes stay where they are
        nodes = nodes.retract(dx.reshape(K, D) * free[:, None])
        costs.append(torch.sum(r * r * w[:, None]))
    return nodes, torch.stack(costs)
