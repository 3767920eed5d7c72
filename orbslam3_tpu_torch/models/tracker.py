"""Frame tracking: local-map projection matching + point counters.

Port of orbslam3_tpu/models/tracker.py (`TrackConfig`, `match_local_map`,
`update_point_counters`)."""
from __future__ import annotations

from typing import NamedTuple

import torch

from orbslam3_tpu_torch.frontend.camera import Camera
from orbslam3_tpu_torch.frontend.stereo import pow12
from orbslam3_tpu_torch.geometry import quat
from orbslam3_tpu_torch.map.slam_map import MapState, add_at
from orbslam3_tpu_torch.ops.fast import topk_stable
from orbslam3_tpu_torch.ops.hamming import hamming_matrix


class TrackConfig(NamedTuple):
    p_local: int = 4096  # local map points considered per frame
    match_radius: float = 12.0  # base search radius [px], scaled by octave
    max_hamming: int = 64
    view_cos_min: float = 0.4  # viewing-angle gate vs stored normal
    frustum_margin: float = 10.0


def match_local_map(st: MapState, cam: Camera, uv, desc, octave, feat_valid, q_pred, p_pred,
                    cfg: TrackConfig = TrackConfig()):
    """Project map points into the predicted frame and match descriptors.

    Returns (matched_mp (N,) int32 (-1 none), mp_w (N, 3), visible_ids (P,),
    visible_ok (P,))."""
    M = st.mp_pos.shape[0]
    N = uv.shape[0]
    in_map = st.mp_valid & (st.mp_map_id == st.active_map)
    q_wc, p_wc = cam.body_to_cam_pose(q_pred, p_pred)
    rel = st.mp_pos - p_wc[None]
    xc = quat.rotate(quat.conj(q_wc)[None], rel)
    z = xc[:, 2]
    proj = cam.project(xc)
    dist = torch.linalg.norm(rel, dim=-1)
    view_dir = rel / dist[:, None].clamp(min=1e-6)
    view_cos = torch.sum(view_dir * st.mp_normal, -1)
    in_frustum = (in_map & (z > 0.2) & cam.in_view(proj, cfg.frustum_margin)
                  & (dist >= 0.7 * st.mp_min_dist) & (dist <= 1.4 * st.mp_max_dist)
                  & (view_cos >= cfg.view_cos_min))

    # over-budget selection ranks by tracking quality found/visible (new
    # points get a 0.5 prior)
    fr = st.mp_found.to(torch.float32) / torch.clamp(st.mp_visible.to(torch.float32), min=1.0)
    quality = torch.where(st.mp_visible > 1, fr, torch.full_like(fr, 0.5))
    _, sel = topk_stable(torch.where(in_frustum, 1.0 + quality, torch.zeros_like(quality)),
                         cfg.p_local)
    sel_ok = in_frustum[sel]

    d_desc = hamming_matrix(st.mp_desc[sel], desc).to(torch.float32)  # (P, N)
    duv = torch.linalg.norm(proj[sel][:, None] - uv[None], dim=-1)  # (P, N)
    radius = cfg.match_radius * pow12(octave)
    ok = (sel_ok[:, None] & feat_valid[None, :] & (duv <= radius[None, :])
          & (d_desc <= cfg.max_hamming))
    BIG = 1e6
    cost = torch.where(ok, d_desc, torch.full_like(d_desc, BIG))

    best_p = torch.argmin(cost, dim=0)  # (N,) first minimum
    best_val = torch.gather(cost, 0, best_p[None])[0]
    best_n = torch.argmin(cost, dim=1)  # (P,)
    mutual = best_n[best_p] == torch.arange(N, device=uv.device)
    good = (best_val < BIG) & mutual
    matched = torch.where(good, sel[best_p], torch.full_like(best_p, -1)).to(torch.int32)
    mp_w = st.mp_pos[matched.long().clamp(0, M - 1)]
    return matched, mp_w, sel.to(torch.int32), sel_ok


def update_point_counters(mp_visible, mp_found, visible_ids, visible_ok, matched_mp, inlier):
    """visible += 1 for frustum hits; found += 1 for tracking inliers."""
    vis = add_at(mp_visible, torch.where(visible_ok, visible_ids, torch.zeros_like(visible_ids)),
                 visible_ok.to(torch.int32))
    ok = (matched_mp >= 0) & inlier
    fnd = add_at(mp_found, torch.where(ok, matched_mp, torch.zeros_like(matched_mp)),
                 ok.to(torch.int32))
    return vis, fnd
