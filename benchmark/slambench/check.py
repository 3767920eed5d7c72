"""What decides `correct`: the program's outputs against the world's ground
truth and against the plain front end (slambench/reference/frontend.py).

Nothing here imports the program. The check reads what the timed path
produced (each frame's pose as the caller read it, each frame's tracker
mode, the keyframe rows and map points the run left, the gravity the IMU
initialization estimated) and the inputs the benchmark made (the frames
and the world). Numbers, each held to the limit that
benchmark/cells/<cell>.json gives it (a reading above its limit fails):

* fe_mismatch: share of feature slots of sampled keyframes (inserted in
  the window) whose position, level, descriptor, validity or right-image u
  differ from the plain front end's on the same images (front end);
* ate_m: RMSE of every tracked position up to the window's end after a
  rigid alignment to the ground truth (tracking and the keyframe branch's
  corrections);
* pose_err_max_m: the largest aligned position error of a window frame
  (each answer on its own);
* lost_share: share of window frames whose tracker mode is not OK;
* map_wall_med_m: median distance of the map's points to the room's walls,
  in the world frame through the first frame's true pose (the program's
  map frame is the first frame's body, where it starts at identity)
  (keyframe branch: triangulation, fusion, local BA);
* gravity_err_deg: angle between the IMU initialization's gravity, in the
  map's frame, and the true gravity seen from the first frame's body (IMU
  initialization), 180 where the IMU never initialized;
* kf_ate_m: RMSE of the final map's valid keyframe positions against the
  ground truth at their times, after a rigid alignment as ate_m's (loop
  closing: a correction missed, or a wrong one welded, leaves the drift in
  the keyframes), inf with fewer than 3 keyframes.

gravity_err_deg and kf_ate_m are computed only where the cell's limits
name them.
"""
from __future__ import annotations

import numpy as np
import torch

from slambench import stats
from slambench.reference import frontend as ref


def _gt(world, frames):
    times = world.frame_times()
    ps, qs = zip(*(world.gt_pose(times[i])[::-1] for i in frames))
    return np.stack(ps).astype(np.float64), np.stack(qs).astype(np.float64)


def kf_ate(world, rows) -> float:
    """kf_ate_m of one session's final keyframe rows."""
    valid = np.asarray(rows["kf_valid"], bool)
    if valid.sum() < 3:
        return float("inf")
    gt = np.stack([world.gt_pose(float(t))[1] for t in rows["kf_time"][valid]])
    err, _, _ = stats.aligned_errors(rows["kf_p"][valid].astype(np.float64),
                                     gt.astype(np.float64))
    return stats.rmse(err)


def _orb_cfgs(config):
    slam = config["slam"]
    orb = ref.OrbConfig(**{k: v for k, v in slam["orb"].items() if k in ref.OrbConfig._fields})
    return orb, ref.StereoConfig(**slam["stereo"])


def frontend_mismatch(config, sessions, outs, window, rng, n_kf, device):
    """(mismatched slots, compared slots) over up to n_kf keyframes a run,
    drawn from the seed among the rows inserted at window frames (the
    newest rows where the window inserted none)."""
    orb, st = _orb_cfgs(config)
    cam = config["camera"]
    bf = cam["baseline"] * cam["fx"]
    rows = []  # (session, row, frame) of every keyframe the map holds
    for s, o in enumerate(outs["sessions"]):
        r = o["rows"]
        for k in np.nonzero(r["kf_valid"])[0]:
            rows.append((s, k, int(round(float(r["kf_time"][k]) * cam["cam_hz"]))))
    cands = [x for x in rows if (x[0], x[2]) in window]
    if not cands:  # a window without a keyframe: the newest ones before it
        cands = sorted(rows, key=lambda x: -x[2])[:n_kf]
    if not cands:
        return 0, 0
    pick = rng.choice(len(cands), size=min(n_kf, len(cands)), replace=False)
    bad = total = 0
    for j in sorted(pick):
        s, k, f = cands[j]
        r = outs["sessions"][s]["rows"]
        img = sessions[s].frames[f]
        L = torch.from_numpy(np.ascontiguousarray(img[0])).to(device)
        R = torch.from_numpy(np.ascontiguousarray(img[1])).to(device)
        featL, u_r = ref.detect_and_match(L, R, bf, orb, st)
        uv, oc, de, va, ur = (x.cpu().numpy() for x in (featL.uv, featL.octave, featL.desc,
                                                         featL.valid, u_r))
        pv = r["kf_feat_valid"][k]
        differ = ((pv != va) | np.any(r["kf_uv"][k] != uv, axis=-1) | (r["kf_octave"][k] != oc)
                  | np.any(r["kf_desc"][k] != de, axis=-1) | (r["kf_ur"][k] != ur))
        slots = pv | va
        bad += int(np.sum(differ & slots))
        total += int(np.sum(slots))
    return bad, total


def evaluate(config, traffic, limits, sessions, outs, window, end_frame, seed, device):
    """(correct, {number: {"value", "limit"}}) for one run. `window` is the
    set of (session, frame) keys read inside the window; `end_frame[s]` the
    first frame of session s after it."""
    rng = np.random.default_rng([seed, 0x5EED])
    prev_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False  # the reference is full float32
    try:
        bad, total = frontend_mismatch(config, sessions, outs, window, rng,
                                       traffic.get("check_keyframes", 4), device)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev_tf32
    nums = {"fe_mismatch": bad / total if total else 1.0}
    ate, perr, lost, wall = [], [], [], []
    half = config["world"].get("room_half", [5.0, 5.0, 2.0])
    R0 = None
    for s, o in enumerate(outs["sessions"]):
        n = end_frame[s]
        if n < 3:  # a session the window left without answers
            ate.append(np.inf), perr.append(np.inf), lost.append(1.0), wall.append(np.inf)
            continue
        est = o["poses"][:n, 4:7].astype(np.float64)
        gt_p, gt_q = _gt(sessions[s].world, range(n))
        err, _, _ = stats.aligned_errors(est, gt_p)
        ate.append(stats.rmse(err))
        in_win = np.array([(s, f) in window for f in range(n)])
        perr.append(float(err[in_win].max()) if in_win.any() else float("inf"))
        modes = o["modes"][:n][in_win]
        lost.append(float(np.mean(modes != 1)) if len(modes) else 1.0)
        pts = o["rows"]["mp_pos"]
        Rs = stats.quat_to_matrix(gt_q[0])
        wall.append(float(np.median(stats.box_distance((Rs @ pts.T).T + gt_p[0], half)))
                    if len(pts) else float("inf"))
        if s == 0:
            R0 = Rs
    nums.update(ate_m=max(ate), pose_err_max_m=max(perr), lost_share=max(lost),
                map_wall_med_m=max(wall))
    if "gravity_err_deg" in limits:
        g_true = R0.T @ np.array([0.0, 0.0, -9.81]) if R0 is not None else None
        nums["gravity_err_deg"] = (stats.angle_deg(outs["gravity_w"], g_true)
                                   if outs.get("imu_initialized") and R0 is not None else 180.0)
    if "kf_ate_m" in limits:
        nums["kf_ate_m"] = max(kf_ate(sessions[s].world, o["rows"])
                               for s, o in enumerate(outs["sessions"]))
    checks = {}
    for k, lim in limits.items():
        checks[k] = {"value": nums.get(k, float("inf")), "limit": lim}
    correct = bool(checks) and all(c["value"] <= c["limit"] for c in checks.values())
    return correct, checks
