"""Local mapping, visual half: gather the covisibility-window BA problem
and scatter its results back (port of build_ba_problem/apply_ba_results
from orbslam3_tpu/models/local_mapper.py)."""
from __future__ import annotations

import torch

from orbslam3_tpu_torch.map.slam_map import (MapState, local_window, mp_slots_for_kfs,
                                             scatter_set)
from orbslam3_tpu_torch.ops.fast import topk_stable
from orbslam3_tpu_torch.optim.local_ba import BAProblem

I32 = torch.int32


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
    P = max_points
    # map-point row -> problem slot (invalid slots dropped)
    inv = scatter_set(torch.full((M,), -1, dtype=I32, device=dev), pt_ids,
                      torch.arange(P, dtype=I32, device=dev), pt_valid)

    BIGI = torch.tensor(2**30, dtype=I32, device=dev)
    oldest = torch.min(torch.where(valid_w, ids_w, BIGI))
    kk = kf_id.long().clamp(0, K - 1)

    if fixed > 0:
        ids_w_safe = torch.where(valid_w, ids_w, torch.zeros_like(ids_w)).long()
        covis_sum = torch.sum(torch.where(valid_w[:, None], st.covis[ids_w_safe],
                                          torch.zeros_like(st.covis[ids_w_safe])), dim=0, dtype=I32)
        in_window = scatter_set(torch.zeros(K, dtype=torch.bool, device=dev), ids_w,
                                torch.ones_like(valid_w), valid_w)
        score = torch.where(st.kf_valid & ~in_window & (st.kf_map_id == st.kf_map_id[kk]),
                            covis_sum, torch.zeros_like(covis_sum))
        fx_score, fx_ids = topk_stable(score, fixed)
        fx_valid = fx_score > 0
        ids = torch.cat([ids_w, fx_ids.to(I32)])
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


def apply_ba_results(st: MapState, ids, kf_valid, q, p, pt_ids, pt_valid, Xw):
    """Scatter optimized poses/points back. Returns (kf_q, kf_p, mp_pos).
    Every lane writes (masked lanes their row's current value); the last
    lane to write a row wins, as in XLA."""
    ids_safe = torch.where(kf_valid, ids, torch.zeros_like(ids)).long()
    kv = kf_valid[:, None]
    kf_q = scatter_set(st.kf_q, ids_safe, torch.where(kv, q, st.kf_q[ids_safe]))
    kf_p = scatter_set(st.kf_p, ids_safe, torch.where(kv, p, st.kf_p[ids_safe]))
    pt_safe = torch.where(pt_valid, pt_ids, torch.zeros_like(pt_ids)).long()
    mp_pos = scatter_set(st.mp_pos, pt_safe,
                         torch.where(pt_valid[:, None], Xw, st.mp_pos[pt_safe]))
    return kf_q, kf_p, mp_pos
