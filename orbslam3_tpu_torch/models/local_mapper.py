"""Local mapping: gather a window's BA problem and scatter its results back
(port of build_ba_problem/apply_ba_results, local_ba_step and
build_vi_ba_problem/apply_vi_ba_results from
orbslam3_tpu/models/local_mapper.py). The visual problem takes the
covisibility window, the visual-inertial one the kf_prev temporal chain."""
from __future__ import annotations

import torch

from orbslam3_tpu_torch.imu.preintegration import PreintState
from orbslam3_tpu_torch.map.slam_map import (MapState, local_window, mp_slots_for_kfs,
                                             scatter_set)
from orbslam3_tpu_torch.ops.fast import topk_stable
from orbslam3_tpu_torch.frontend.camera import Camera
from orbslam3_tpu_torch.optim.local_ba import BAProblem, solve_local_ba
from orbslam3_tpu_torch.optim.vi_ba import VIBAProblem

I32 = torch.int32


def _point_slots(st: MapState, pt_ids, pt_valid):
    """(M,) map-point row -> problem slot, -1 elsewhere (invalid slots dropped)."""
    M = st.mp_pos.shape[0]
    dev = pt_ids.device
    return scatter_set(torch.full((M,), -1, dtype=I32, device=dev), pt_ids,
                       torch.arange(pt_ids.shape[0], dtype=I32, device=dev), pt_valid)


def _fixed_observers(st: MapState, kk, ids_w, valid_w, fixed: int):
    """Up to `fixed` keyframes outside the window that share the most
    observations with it: (ids (fixed,), valid (fixed,))."""
    K = st.kf_valid.shape[0]
    dev = ids_w.device
    ids_w_safe = torch.where(valid_w, ids_w, torch.zeros_like(ids_w)).long()
    rows = st.covis[ids_w_safe]
    covis_sum = torch.sum(torch.where(valid_w[:, None], rows, torch.zeros_like(rows)),
                          dim=0, dtype=I32)
    in_window = scatter_set(torch.zeros(K, dtype=torch.bool, device=dev), ids_w,
                            torch.ones_like(valid_w), valid_w)
    score = torch.where(st.kf_valid & ~in_window & (st.kf_map_id == st.kf_map_id[kk]),
                        covis_sum, torch.zeros_like(covis_sum))
    fx_score, fx_ids = topk_stable(score, fixed)
    return fx_ids.to(I32), fx_score > 0


def build_ba_problem(st: MapState, kf_id, window: int, max_points: int, fixed: int = 8):
    """Gather the local BA problem around kf_id: kf_id + top covisible
    keyframes (optimized, oldest fixed as the gauge anchor) plus up to
    `fixed` out-of-window observer keyframes (opt_cam False) that pin the
    local points. Returns (prob, ids, valid, pt_ids, pt_valid)."""
    ids_w, valid_w = local_window(st, kf_id, window)
    M = st.mp_pos.shape[0]
    K = st.kf_valid.shape[0]
    dev = ids_w.device
    fixed = min(fixed, K)

    pt_ids, pt_valid = mp_slots_for_kfs(st, ids_w, valid_w, max_points)
    inv = _point_slots(st, pt_ids, pt_valid)

    BIGI = torch.tensor(2**30, dtype=I32, device=dev)
    oldest = torch.min(torch.where(valid_w, ids_w, BIGI))
    kk = kf_id.long().clamp(0, K - 1)

    if fixed > 0:
        fx_ids, fx_valid = _fixed_observers(st, kk, ids_w, valid_w, fixed)
        ids = torch.cat([ids_w, fx_ids])
        valid = torch.cat([valid_w, fx_valid])
        opt_cam = torch.cat([valid_w & (ids_w != oldest),
                             torch.zeros(fixed, dtype=torch.bool, device=dev)])
    else:
        ids, valid = ids_w, valid_w
        opt_cam = valid_w & (ids_w != oldest)

    ids_safe = torch.where(valid, ids, torch.zeros_like(ids)).long()
    refs = st.kf_mp[ids_safe]  # (C, N)
    obs_pt = torch.where(refs >= 0, inv[refs.long().clamp(0, M - 1)], torch.full_like(refs, -1))
    pt_rows = pt_ids.long()
    prob = BAProblem(
        q=st.kf_q[ids_safe], p=st.kf_p[ids_safe], opt_cam=opt_cam, cam_valid=valid,
        Xw=st.mp_pos[pt_rows], pt_valid=pt_valid, obs_uv=st.kf_uv[ids_safe],
        obs_ur=st.kf_ur[ids_safe], obs_oct=st.kf_octave[ids_safe], obs_pt=obs_pt,
    )
    return prob, ids, valid, pt_ids, pt_valid


def _scatter_kf_rows(arr, ids, kf_valid, vals):
    """Every lane writes (masked lanes their row's current value); the last
    lane to write a row wins, as in XLA."""
    ids_safe = torch.where(kf_valid, ids, torch.zeros_like(ids)).long()
    return scatter_set(arr, ids_safe, torch.where(kf_valid[:, None], vals, arr[ids_safe]))


def apply_ba_results(st: MapState, ids, kf_valid, q, p, pt_ids, pt_valid, Xw):
    """Scatter optimized poses/points back. Returns (kf_q, kf_p, mp_pos)."""
    return (_scatter_kf_rows(st.kf_q, ids, kf_valid, q),
            _scatter_kf_rows(st.kf_p, ids, kf_valid, p),
            _scatter_kf_rows(st.mp_pos, pt_ids, pt_valid, Xw))


def local_ba_step(st: MapState, cam: Camera, kf_id, window: int = 8, max_points: int = 2048,
                  iters: int = 8, fixed: int = 8):
    """One local BA pass around kf_id: gather, solve, scatter the optimized
    poses (the window's free keyframes) and points back. Returns
    (MapState, BAResult)."""
    prob, ids, valid, pt_ids, pt_valid = build_ba_problem(st, kf_id, window, max_points, fixed)
    res = solve_local_ba(prob, cam, iters=iters)
    kf_q, kf_p, mp_pos = apply_ba_results(st, ids, valid & prob.opt_cam, res.q, res.p, pt_ids,
                                          pt_valid, res.Xw)
    return st._replace(kf_q=kf_q, kf_p=kf_p, mp_pos=mp_pos), res


def build_vi_ba_problem(st: MapState, kf_id, window: int, max_points: int, gravity_w,
                        fixed: int = 0):
    """Gather the temporal-window VI-BA problem ending at kf_id: the window
    walks the kf_prev chain (oldest first, the oldest valid slot is the
    fixed anchor); `fixed` appends out-of-window observer keyframes with
    opt_cam False and no IMU edge. The IMU edge of slot i connects
    ids[i-1] -> ids[i]: the preintegration stored on ids[i] is exactly that
    when the chain is unbroken. Returns (prob, ids, valid, pt_ids, pt_valid)."""
    K = st.kf_valid.shape[0]
    M = st.mp_pos.shape[0]
    dev = st.kf_valid.device
    fixed = min(fixed, K)

    chain = []
    cur = kf_id.to(I32)
    for _ in range(window):
        chain.append(cur)
        cur = torch.where(cur >= 0, st.kf_prev[cur.long().clamp(0, K - 1)],
                          torch.full_like(cur, -1))
    ids_w = torch.stack(chain[::-1])  # oldest..newest
    valid_w = ids_w >= 0
    ids_w_safe = torch.where(valid_w, ids_w, torch.zeros_like(ids_w))

    pt_ids, pt_valid = mp_slots_for_kfs(st, ids_w_safe, valid_w, max_points)
    inv = _point_slots(st, pt_ids, pt_valid)

    first_valid = torch.argmax(valid_w.to(I32))  # first True in oldest..newest order
    opt_w = valid_w & (torch.arange(window, device=dev) != first_valid)

    no_edge = torch.zeros(1 + fixed, dtype=torch.bool, device=dev)
    if fixed > 0:
        fx_ids, fx_valid = _fixed_observers(st, kf_id.long().clamp(0, K - 1), ids_w, valid_w, fixed)
        ids = torch.cat([ids_w, fx_ids])
        valid = torch.cat([valid_w, fx_valid])
        opt_cam = torch.cat([opt_w, no_edge[1:]])
    else:
        ids, valid, opt_cam = ids_w, valid_w, opt_w
    ids_safe = torch.where(valid, ids, torch.zeros_like(ids)).long()

    refs = st.kf_mp[ids_safe]
    obs_pt = torch.where(refs >= 0, inv[refs.long().clamp(0, M - 1)], torch.full_like(refs, -1))

    chain_ok = torch.cat([no_edge[:1], st.kf_prev[ids_w_safe[1:].long()] == ids_w[:-1],
                          no_edge[1:]])
    preints = PreintState(*[a[ids_safe] for a in st.kf_preint])
    imu_edge_valid = valid & chain_ok & (preints.dt > 1e-4)

    prob = VIBAProblem(
        q=st.kf_q[ids_safe], p=st.kf_p[ids_safe], v=st.kf_v[ids_safe], bg=st.kf_bg[ids_safe],
        ba=st.kf_ba[ids_safe], opt_cam=opt_cam, cam_valid=valid, Xw=st.mp_pos[pt_ids.long()],
        pt_valid=pt_valid, obs_uv=st.kf_uv[ids_safe], obs_ur=st.kf_ur[ids_safe],
        obs_oct=st.kf_octave[ids_safe], obs_pt=obs_pt, preint=preints,
        imu_edge_valid=imu_edge_valid, gravity_w=gravity_w,
    )
    return prob, ids, valid, pt_ids, pt_valid


def apply_vi_ba_results(st: MapState, ids, kf_valid, q, p, v, bg, ba, pt_ids, pt_valid, Xw):
    """Scatter optimized keyframe states and points back. Returns (kf_q,
    kf_p, kf_v, kf_bg, kf_ba, mp_pos)."""
    kf_q, kf_p, mp_pos = apply_ba_results(st, ids, kf_valid, q, p, pt_ids, pt_valid, Xw)
    return (kf_q, kf_p, _scatter_kf_rows(st.kf_v, ids, kf_valid, v),
            _scatter_kf_rows(st.kf_bg, ids, kf_valid, bg),
            _scatter_kf_rows(st.kf_ba, ids, kf_valid, ba), mp_pos)
