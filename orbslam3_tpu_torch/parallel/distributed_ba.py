"""Whole-map (global) bundle adjustment, on one device or over the ranks
of a torch.distributed process group.

Port of orbslam3_tpu/parallel/distributed_ba.py: the point-major
observation table (`make_point_table`) and the Gauss-Newton solve with the
camera system reduced over the points by a Schur complement. The points
are cut into tiles of `tile` points and the tiles' camera systems are
summed in turn, which is the same sum (the Schur complement is additive
over points). `global_ba` runs every tile on one device;
`distributed_global_ba` gives each rank a contiguous slice of the points,
as the JAX package's mesh axis does, and sums the ranks' systems with one
all_reduce a step where the JAX package has its psum.

Every sum runs in an order that is the same from run to run, and none
through atomic adds: the camera blocks are one-hot matrix products (each
observation's row of a (tile x O, K) one-hot matrix picks its keyframe), a
point's blocks are sums over its own O observations, the reduced system is
the product of the dense (tile, 6K, 3) stack with itself as in the JAX
package, and the tiles add up in order. (A sort-and-segment scatter of the
camera blocks was tried first: it serialises the runs of equal keyframe
indices, thousands long, and took 0.8 s of the card a step at K = 96.)

`make_point_table` runs on the state's device (stable sorts and a
segmented rank), where the JAX package regroups on the host: no device
read.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import jacfwd, vmap

from orbslam3_tpu_torch.frontend.camera import Camera
from orbslam3_tpu_torch.optim import robust
from orbslam3_tpu_torch.optim.pose_only import _retract, _visual_residual

I32 = torch.int32
F32 = torch.float32


class GlobalBAPoints(NamedTuple):
    """Point-major observation table (P points x O observations)."""

    Xw: torch.Tensor  # (P, 3)
    pt_valid: torch.Tensor  # (P,)
    obs_kf: torch.Tensor  # (P, O) int32 keyframe index (-1 empty)
    obs_uv: torch.Tensor  # (P, O, 2)
    obs_ur: torch.Tensor  # (P, O)
    obs_oct: torch.Tensor  # (P, O) int32


def make_point_table(st, max_points: int, max_obs: int):
    """(K, N) keyframe-major -> (P, O) point-major. Returns (GlobalBAPoints,
    ids (P,) int64: the map-point row of each slot, ascending, -1 past the
    last). Over budget, the most-observed points are kept (equal counts: the
    lower row); a point seen more than O times keeps every stride-th view,
    evenly spaced over its observers in keyframe order."""
    kf_mp = st.kf_mp
    K, N = kf_mp.shape
    M = st.mp_valid.shape[0]
    dev = kf_mp.device
    P_, O = max_points, max_obs
    big = torch.iinfo(torch.int64).max

    obs = ((kf_mp >= 0) & st.kf_valid[:, None]).reshape(-1)
    mp_flat = kf_mp.reshape(-1).long()
    # observation counts (integers: exact in any order of summation)
    obs_cnt = torch.zeros(M + 1, dtype=torch.int64, device=dev).index_add_(
        0, torch.where(obs, mp_flat, torch.full_like(mp_flat, M)),
        torch.ones_like(mp_flat))[:M]
    key = torch.where(st.mp_valid, -obs_cnt, torch.full_like(obs_cnt, big))
    sel = torch.sort(key, stable=True).indices[:min(P_, M)]
    sel = torch.where(st.mp_valid[sel], sel, torch.full_like(sel, big))
    ids = torch.sort(sel).values
    ids = torch.where(ids < big, ids, torch.full_like(ids, -1))
    if P_ > M:
        ids = torch.cat([ids, torch.full((P_ - M,), -1, dtype=ids.dtype, device=dev)])
    slot_of = torch.full((M + 1,), -1, dtype=torch.int64, device=dev)
    slot_of[torch.where(ids >= 0, ids, torch.full_like(ids, M))] = torch.arange(P_, device=dev)
    slot_of = slot_of[:M]

    # regroup: every (keyframe, feature) observation sorted by its point's
    # slot (stably, so keyframe order within a point), ranked within its run
    slots = torch.where(obs, slot_of[mp_flat.clamp(0, M - 1)], torch.full_like(mp_flat, -1))
    key = torch.where(slots >= 0, slots, torch.full_like(slots, P_))
    s, order = torch.sort(key, stable=True)
    first = torch.searchsorted(s, s)
    rank = torch.arange(s.shape[0], device=dev) - first
    group_sz = torch.searchsorted(s, s, right=True) - first
    stride = torch.clamp((group_sz + O - 1) // O, min=1)
    ok = (rank % stride == 0) & (rank // stride < O) & (s < P_)
    rank = rank // stride
    kf_idx, feat_idx = order // N, order % N
    tgt = torch.where(ok, s * O + rank, torch.full_like(s, P_ * O))

    def put(fill, vals, dtype):
        out = torch.full((P_ * O + 1,) + tuple(vals.shape[1:]), fill, dtype=dtype, device=dev)
        out[tgt] = vals.to(dtype)
        return out[:P_ * O]

    obs_kf = put(-1, kf_idx, I32).reshape(P_, O)
    obs_uv = put(0.0, st.kf_uv[kf_idx, feat_idx], F32).reshape(P_, O, 2)
    obs_ur = put(-1.0, st.kf_ur[kf_idx, feat_idx], F32).reshape(P_, O)
    obs_oct = put(0, st.kf_octave[kf_idx, feat_idx], I32).reshape(P_, O)
    counts = (obs_kf >= 0).sum(1)

    has = ids >= 0
    Xw = torch.where(has[:, None], st.mp_pos[ids.clamp(min=0)],
                     torch.zeros((), dtype=F32, device=dev))
    return GlobalBAPoints(Xw=Xw, pt_valid=has & (counts >= 2), obs_kf=obs_kf, obs_uv=obs_uv,
                          obs_ur=obs_ur, obs_oct=obs_oct), ids


def _edges(pts: GlobalBAPoints):
    """The table's observations flattened point-major: (keyframe index
    clamped to a row, validity, point slot, uv, ur, octave)."""
    P_, O = pts.obs_kf.shape
    e_kf = pts.obs_kf.reshape(-1).long()
    e_valid = (e_kf >= 0) & pts.pt_valid.repeat_interleave(O)
    e_kf_safe = torch.where(e_valid, e_kf, torch.zeros_like(e_kf))
    e_pt = torch.arange(P_, device=e_kf.device).repeat_interleave(O)
    return (e_kf_safe, e_valid, e_pt, pts.obs_uv.reshape(-1, 2), pts.obs_ur.reshape(-1),
            pts.obs_oct.reshape(-1))


def global_ba(pts: GlobalBAPoints, q, p, opt_cam, cam: Camera, iters: int = 10,
              damping: float = 1e-4, tile: int = 0):
    """Gauss-Newton over all keyframe poses and points of the table.

    q, p: (K, 4), (K, 3) keyframe poses; opt_cam: (K,) bool, False keeps a
    pose fixed (gauge anchor). tile: points per tile of the Schur reduction
    (0 = one tile); it must divide the table's P. Each step is accepted only
    if it lowers the robust cost, with the damping halved on acceptance and
    quadrupled on rejection. Returns (q, p, Xw)."""
    return _gauss_newton(pts, q, p, opt_cam, cam, iters, damping, tile,
                         lambda Sb: Sb, lambda c: c)


def distributed_global_ba(pts: GlobalBAPoints, q, p, opt_cam, cam: Camera, iters: int = 10,
                          damping: float = 1e-4, tile: int = 0, group=None):
    """`global_ba` with the points split over the ranks of a torch.distributed
    process group (`group`, the default group when None), as the JAX package
    shards them over a mesh axis.

    Every rank passes the whole table and the same poses; rank r of W takes
    the contiguous slice of points P/W*r : P/W*(r+1) and builds its tiles'
    part of the camera system. One all_reduce (sum) of the system (S and b
    in one buffer, 6K*6K + 6K floats) a Gauss-Newton step and one of the
    scalar cost a cost evaluation make every rank solve the same system and
    take the same cost-guarded decision. P must divide by W * tile (tile 0:
    one tile a rank). Returns (q, p, Xw) with the whole Xw, gathered from
    every rank's slice. On one rank the result is `global_ba`'s, bit for bit.

    NCCL needs one card a rank; gloo takes CPU tensors and CUDA tensors
    (two gloo ranks can share one card). Raises when no process group is
    initialized: there is no fallback to `global_ba`."""
    import torch.distributed as dist

    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError("distributed_global_ba needs an initialized torch.distributed "
                           "process group (global_ba runs the same solve on one device)")
    W = dist.get_world_size(group)
    r = dist.get_rank(group)
    P_ = pts.obs_kf.shape[0]
    per = P_ // W
    if per * W != P_ or (tile > 0 and per % tile):
        raise ValueError(f"{P_} points do not split into {W} ranks of whole tiles of {tile}")
    local = GlobalBAPoints(*[a[r * per:(r + 1) * per] for a in pts])

    def all_sum(x):
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
        return x

    q, p, Xw = _gauss_newton(local, q, p, opt_cam, cam, iters, damping, tile, all_sum, all_sum)
    parts = [torch.empty_like(Xw) for _ in range(W)]
    dist.all_gather(parts, Xw.contiguous(), group=group)
    return q, p, torch.cat(parts)


def _gauss_newton(pts: GlobalBAPoints, q, p, opt_cam, cam: Camera, iters: int, damping: float,
                  tile: int, reduce_system, reduce_cost):
    """The solve of `global_ba` on this process's points. `reduce_system`
    maps this process's part of the camera system (S and b flattened into
    one buffer) to the whole system's, and `reduce_cost` its part of a cost
    to the whole cost: the identity on one device, a sum over the ranks in
    `distributed_global_ba`."""
    K = q.shape[0]
    P_, O = pts.obs_kf.shape
    T = tile if 0 < tile < P_ else P_
    assert P_ % T == 0, (P_, T)
    dev = q.device
    zero6 = torch.zeros(6, dtype=F32, device=dev)
    zero3 = torch.zeros(3, dtype=F32, device=dev)
    eye3 = torch.eye(3, dtype=F32, device=dev)
    kf_ar = torch.arange(K, device=dev)
    tiles = [slice(i * T, (i + 1) * T) for i in range(P_ // T)]
    tile_pts = [GlobalBAPoints(*[a[sl] for a in pts]) for sl in tiles]
    tile_edges = [_edges(tp) for tp in tile_pts]

    def both(xi, dxp, qc, pc, X, uv, ur):
        r = _visual_residual(xi, qc, pc, cam, X + dxp, uv, ur)
        return r, r

    res_jac = vmap(jacfwd(both, argnums=(0, 1), has_aux=True),
                   in_dims=(None, None, 0, 0, 0, 0, 0))
    res_v = vmap(lambda qc, pc, X, uv, ur: _visual_residual(zero6, qc, pc, cam, X, uv, ur))
    all_edges = _edges(pts)

    def cost_fn(q, p, Xw):
        return reduce_cost(local_cost(q, p, Xw))

    def local_cost(q, p, Xw):
        e_kf, e_valid, e_pt, e_uv, e_ur, e_oct = all_edges
        r = res_v(q[e_kf], p[e_kf], Xw[e_pt], e_uv, e_ur)
        chi2 = torch.sum(r * r, -1) * robust.octave_sigma2_inv(e_oct)
        d2 = robust.chi2_gate(e_ur)
        hub = torch.where(chi2 <= d2, chi2,
                          2.0 * torch.sqrt(d2 * torch.clamp(chi2, min=1e-12)) - d2)
        cap = 2.0 * torch.sqrt(16.0 * d2 * d2) - d2
        return torch.sum(torch.minimum(hub, cap) * e_valid.to(F32))

    def tile_system(q, p, Xw_t, tp, edges, lam):
        """One tile's part of the reduced camera system, and what the
        back-substitution needs of it."""
        e_kf, e_valid, e_pt, e_uv, e_ur, e_oct = edges
        (Jc, Jp), r = res_jac(zero6, zero3, q[e_kf], p[e_kf], Xw_t[e_pt], e_uv, e_ur)
        s2inv = robust.octave_sigma2_inv(e_oct)
        d2 = robust.chi2_gate(e_ur)
        chi2 = torch.sum(r * r, -1) * s2inv
        w = (robust.huber_weight(chi2, d2) * (chi2 <= 16.0 * d2).to(F32) * s2inv
             * e_valid.to(F32))
        Jc = Jc * opt_cam[e_kf].to(F32)[:, None, None]
        Jc_w = Jc * w[:, None, None]
        Jp_w = Jp * w[:, None, None]
        # (E, K) one-hot of each observation's keyframe (invalid rows are 0)
        onehot = (e_kf[:, None] == kf_ar[None, :]).to(F32) * e_valid.to(F32)[:, None]
        Hcc = (onehot.T @ torch.einsum("eij,eik->ejk", Jc_w, Jc).reshape(-1, 36)).reshape(K, 6, 6)
        bc = onehot.T @ torch.einsum("eij,ei->ej", Jc_w, r)
        Hpp = torch.einsum("eij,eik->ejk", Jp_w, Jp).reshape(T, O, 3, 3).sum(1)
        bp = torch.einsum("eij,ei->ej", Jp_w, r).reshape(T, O, 3).sum(1)
        Wcp = torch.einsum("eij,eik->ejk", Jc_w, Jp).reshape(T, O, 6, 3)
        # each point's (6K, 3) column of W: its observations' blocks at their
        # keyframes' rows (two observations from one keyframe add up)
        Wstack = torch.einsum("tok,toij->tkij", onehot.reshape(T, O, K), Wcp).reshape(T, 6 * K, 3)
        pt_has = e_valid.reshape(T, O).any(1)
        # scale-relative damping keeps rank-deficient point blocks invertible in float32
        tr = (Hpp[:, 0, 0] + Hpp[:, 1, 1] + Hpp[:, 2, 2]) / 3.0
        Hpp_inv = torch.linalg.inv_ex(
            Hpp + eye3[None] * (lam + torch.clamp(lam, min=1e-5) * tr + 1e-6)[:, None, None])[0]
        Hpp_inv = torch.where(pt_has[:, None, None], Hpp_inv, torch.zeros_like(Hpp_inv))
        WH = Wstack @ Hpp_inv  # (T, 6K, 3)
        WHW = WH.permute(1, 0, 2).reshape(6 * K, 3 * T) @ \
            Wstack.permute(1, 0, 2).reshape(6 * K, 3 * T).T
        Hcc_full = torch.zeros((K, 6, K, 6), dtype=F32, device=dev)
        Hcc_full[kf_ar, :, kf_ar, :] = Hcc
        S_t = Hcc_full.reshape(6 * K, 6 * K) - WHW
        b_t = bc.reshape(6 * K) - torch.einsum("tik,tk->i", WH, bp)
        return S_t, b_t, (Hpp_inv, bp, Wcp, e_kf.reshape(T, O), pt_has)

    free6 = opt_cam.to(F32).repeat_interleave(6)
    eye = torch.eye(6 * K, dtype=F32, device=dev)
    Xw = pts.Xw
    lam = torch.tensor(damping, dtype=F32, device=dev)
    cost = cost_fn(q, p, Xw)
    for _ in range(iters):
        S = torch.zeros((6 * K, 6 * K), dtype=F32, device=dev)
        b = torch.zeros(6 * K, dtype=F32, device=dev)
        keep = []
        for sl, tp, edges in zip(tiles, tile_pts, tile_edges):
            S_t, b_t, kept = tile_system(q, p, Xw[sl], tp, edges, lam)
            S = S + S_t
            b = b + b_t
            keep.append(kept)
        Sb = reduce_system(torch.cat([S.reshape(-1), b]))
        S, b = Sb[:36 * K * K].reshape(6 * K, 6 * K), Sb[36 * K * K:]
        S = S * free6[:, None] * free6[None, :] + torch.diag(1.0 - free6)
        # diagonal-relative damping (LM): rank-deficient camera blocks have
        # large diagonals, where an absolute floor is invisible in float32
        S = S + torch.diag(lam * torch.diagonal(S)) + eye * lam
        d = torch.sqrt(torch.clamp(torch.diagonal(S), min=1e-8))
        dxc = -torch.linalg.solve_ex(S / d[:, None] / d[None, :], (b / d)[:, None])[0][:, 0] / d
        dxc6 = dxc.reshape(K, 6)
        dxp, has = [], []
        for Hpp_inv, bp, Wcp, kf_to, pt_has in keep:
            Wt_dxc = torch.einsum("toik,toi->tk", Wcp, dxc6[kf_to])
            dxp.append(-torch.einsum("pkl,pl->pk", Hpp_inv, bp + Wt_dxc))
            has.append(pt_has)
        dxp, has = torch.cat(dxp), torch.cat(has)
        q2, p2 = _retract(q, p, dxc6)
        X2 = torch.where((pts.pt_valid & has)[:, None], Xw + dxp, Xw)
        # cost-guarded acceptance: an unguarded step from a rank-deficient
        # system can diverge
        new_cost = cost_fn(q2, p2, X2)
        ok = new_cost < cost
        q, p, Xw = (torch.where(ok, b_, a_) for a_, b_ in ((q, q2), (p, p2), (Xw, X2)))
        lam = torch.where(ok, torch.clamp(lam * 0.5, min=1e-6), lam * 4.0)
        cost = torch.where(ok, new_cost, cost)
    return q, p, Xw
