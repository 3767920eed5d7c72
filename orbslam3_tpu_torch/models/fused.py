"""The per-frame SLAM step and its host wrapper.

Port of orbslam3_tpu/models/fused.py: `TrackState`, `FrameOut`, the front
end for one frame or a whole chunk of frames, `_slam_step_core`,
`slam_step_chunk` and `FusedSlam` with its host services (IMU
initialization, time-phased refinement, the static-start reset, map
compaction with its pressure evictions, loop closing), checkpoint resume
(`from_state`) and chunked dispatch. The JAX package runs the whole step as one XLA program
with lax.cond branches, and a chunk as a lax.scan over it; here the step
runs eagerly on the state's device, a chunk is the batched front end
followed by a Python loop over the step's back end, and each lax.cond
became:

* one host read per frame of a few flags and counters together
  (`FusedSlam._sync`): the lost-timeout reset, the keyframe insert, the
  map-point cull, whether tracking held, the active map's keyframe count
  (it decides local BA, triangulation, fusion, point statistics and the
  keyframe cull inside the insert), and the tracker mode, row counts and
  atlas size the host services want. After a lost-timeout reset the active
  map is empty, so the host knows the count without a second read, and the
  atlas size by whether the reset archived the map;
* torch.where over both results, for the reference-keyframe Hamming
  fallback and the RANSAC seed that follows it (one (N, N) Hamming matrix
  and 128 three-point hypotheses a frame);
* a masked write, for a keyframe cull that may find no candidate
  (`mapping_ops.remove_keyframe(..., enable=)`);
* nothing, for the choice between the visual and the visual-inertial pose
  solve and bundle adjustment: `imu_ok` changes only in the host's
  IMU-initialization service, so the host knows it, as it knows whether the
  frame came with IMU samples.

With a vocabulary `FusedSlam` runs the loop closer (loop/closer.py) in its
service rounds, on the JAX host's cadence: each round acts on the keyframe
count, atlas size and tracker mode as of the round before (the host
mirrors them from the per-frame flag reads, so this costs no read).
"""
from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch

from orbslam3_tpu_torch import default_device, set_full_precision
from orbslam3_tpu_torch.frontend.camera import Camera
from orbslam3_tpu_torch.frontend.orb import Features, detect_orb_batch
from orbslam3_tpu_torch.frontend.stereo import match_stereo
from orbslam3_tpu_torch.geometry import quat
from orbslam3_tpu_torch.imu import preintegration as pre
from orbslam3_tpu_torch.interop import to_device
from orbslam3_tpu_torch.map import mapping_ops as mo
from orbslam3_tpu_torch.map import slam_map as sm
from orbslam3_tpu_torch.map.compaction import compact_map
from orbslam3_tpu_torch.map.triangulation import triangulate_with_neighbor
from orbslam3_tpu_torch.models import policy
from orbslam3_tpu_torch.models.local_mapper import (apply_ba_results, apply_vi_ba_results,
                                                    build_ba_problem, build_vi_ba_problem)
from orbslam3_tpu_torch.models.slam import SlamConfig
from orbslam3_tpu_torch.models.tracker import match_local_map, update_point_counters
from orbslam3_tpu_torch.ops.hamming import hamming_matrix
from orbslam3_tpu_torch.optim.imu_init import inertial_init
from orbslam3_tpu_torch.optim.local_ba import solve_local_ba
from orbslam3_tpu_torch.optim.pose_only import (pose_inertial_optimize, pose_optimize,
                                                visual_residuals)
from orbslam3_tpu_torch.optim.robust_pose import robust_pose_3d3d
from orbslam3_tpu_torch.optim.vi_ba import solve_vi_ba

MODE_NOT_INIT = 0
MODE_OK = 1
MODE_RECENTLY_LOST = 2

I32 = torch.int32
F32 = torch.float32

# The stereo-only configuration of the port's first slice: no IMU, no RANSAC
# seed and no map maintenance beyond the map-point cull.
SLICE_CFG = SlamConfig(use_imu=False, ransac_fallback=False, triangulate_mono=False,
                       fuse_neighbors=False, update_point_stats=False, kf_cull_redundancy=0.0)
# The stereo-inertial odometry configuration the JAX package measures itself
# on (bench.py); every production flag of SlamConfig() is on.
BENCH_CFG = SlamConfig(use_imu=True, kf_max_frames=6, ba_iters=3, ba_window=6, lost_timeout=5.0)


class TrackState(NamedTuple):
    """Device-resident tracker state."""

    q: torch.Tensor  # (4,)
    p: torch.Tensor  # (3,)
    v: torch.Tensor  # (3,)
    bg: torch.Tensor  # (3,)
    ba: torch.Tensor  # (3,)
    motion_dq: torch.Tensor  # (4,)
    motion_dp: torch.Tensor  # (3,)
    mode: torch.Tensor  # () int32
    lost_since: torch.Tensor  # () f32, -1 = not lost
    last_lost_t: torch.Tensor  # () f32, very negative = never
    last_t: torch.Tensor  # () f32
    frames_since_kf: torch.Tensor  # () int32
    ref_inliers: torch.Tensor  # () int32
    kfs_since_cull: torch.Tensor  # () int32
    last_kf: torch.Tensor  # () int32
    kf_preint: pre.PreintState  # running preintegration since last keyframe
    gravity_w: torch.Tensor  # (3,)
    imu_ok: torch.Tensor  # () bool

    @staticmethod
    def initial(device=None) -> "TrackState":
        def s(v, dtype):
            return torch.tensor(v, dtype=dtype, device=device)

        z3 = torch.zeros(3, dtype=F32, device=device)
        return TrackState(
            q=quat.identity(device=device), p=z3, v=z3.clone(), bg=z3.clone(), ba=z3.clone(),
            motion_dq=quat.identity(device=device), motion_dp=z3.clone(),
            mode=s(MODE_NOT_INIT, I32), lost_since=s(-1.0, F32), last_lost_t=s(-1e9, F32),
            last_t=s(0.0, F32), frames_since_kf=s(0, I32), ref_inliers=s(1, I32),
            kfs_since_cull=s(0, I32), last_kf=s(0, I32),
            kf_preint=pre.PreintState.identity(device=device),
            gravity_w=s([0.0, 0.0, -9.81], F32), imu_ok=s(False, torch.bool),
        )


class FrameOut(NamedTuple):
    """Per-frame outputs (0-d or small tensors on the state's device)."""

    q: torch.Tensor
    p: torch.Tensor
    v: torch.Tensor
    n_matches: torch.Tensor
    n_inliers: torch.Tensor
    mode: torch.Tensor
    is_kf: torch.Tensor
    kf_id: torch.Tensor
    n_kf: torch.Tensor
    n_features: torch.Tensor  # valid detections this frame
    n_stereo: torch.Tensor  # features with stereo depth
    mean_reproj_px: torch.Tensor  # RMS reprojection error of inliers [px]
    # pose relative to the reference keyframe at record time
    ref_kf: torch.Tensor  # () int32 (-1 = none)
    rel_q: torch.Tensor  # (4,)
    rel_p: torch.Tensor  # (3,)


def _frontend_chunk(lefts_u8, rights_u8, cam: Camera, cfg: SlamConfig):
    """Front end for all C frames of a chunk in one batched pass over the
    2C images (one FAST/NMS launch): ORB detection, stereo matching,
    body-frame 3D points. It depends only on the images, not on the tracking
    state, so it runs before the chunk's sequential steps. Every result
    carries the leading chunk axis C."""
    # left and right of a frame side by side in the batch: the operators that
    # work on groups of images (ops/brief.py::orientations_from_patches) then
    # see each stereo pair as a one-frame call does
    imgs = torch.stack([lefts_u8, rights_u8], dim=1).flatten(0, 1)
    f = detect_orb_batch(imgs.to(F32), cfg.orb)
    featL = Features(*[a[0::2] for a in f])
    featR = Features(*[a[1::2] for a in f])
    u_r, depth, has_depth = match_stereo(featL, featR, cam, cfg.stereo)
    points_body = cam.cam_pts_to_body(
        cam.unproject(featL.uv, torch.where(has_depth, depth, torch.ones_like(depth))))
    return featL, u_r, depth, has_depth, points_body


def _frontend_frame(fe, i: int):
    """Frame i's slice of a `_frontend_chunk` result."""
    featL, *rest = fe
    return (Features(*[a[i] for a in featL]), *[a[i] for a in rest])


def _frontend(left_u8, right_u8, cam: Camera, cfg: SlamConfig):
    """The front end of one frame: a chunk of one."""
    return _frontend_frame(_frontend_chunk(left_u8[None], right_u8[None], cam, cfg), 0)


def _ref_kf_match(st: sm.MapState, kf, featL, max_hamming: int):
    """Dense mutual-best Hamming match against keyframe `kf`'s features
    (pose-free reference-keyframe fallback)."""
    K = st.kf_valid.shape[0]
    M = st.mp_pos.shape[0]
    kk = kf.long().clamp(0, K - 1)
    okB = st.kf_feat_valid[kk] & (st.kf_mp[kk] >= 0)
    D = hamming_matrix(featL.desc, st.kf_desc[kk]).to(F32)
    cost = torch.where(featL.valid[:, None] & okB[None, :], D, torch.full_like(D, 1e6))
    best = torch.argmin(cost, dim=1)
    best_val = torch.gather(cost, 1, best[:, None])[:, 0]
    back = torch.argmin(cost, dim=0)
    mutual = back[best] == torch.arange(cost.shape[0], device=cost.device)
    good = (best_val <= max_hamming) & mutual
    mp = st.kf_mp[kk][best]
    mp_safe = mp.clamp(0, M - 1)
    good = good & (mp >= 0) & st.mp_valid[mp_safe.long()]
    return torch.where(good, mp_safe, torch.full_like(mp_safe, -1)), st.mp_pos[mp_safe.long()]


def _where_tree(c, a, b):
    """torch.where over every leaf of two (nested) NamedTuples."""
    return type(a)(*[_where_tree(c, x, y) if isinstance(x, tuple) else torch.where(c, x, y)
                     for x, y in zip(a, b)])


class StepFlags(NamedTuple):
    """What the host learns from a frame's one device read."""

    lost: bool  # lost beyond the timeout: the active map was reset or archived
    is_kf: bool  # a keyframe was inserted
    mode: int  # tracker mode after the step
    n_kf: int  # keyframe rows in use after the step
    n_mp: int  # map-point rows in use before the step's insert
    next_map_id: int  # the atlas's next map id after the step


def _ransac_seed(t: float) -> int:
    """Seed of a frame's RANSAC draws: 17 and the float32 bit pattern of t."""
    return (17 << 32) | int(np.float32(t).view(np.uint32))


def _slam_step_core(st: sm.MapState, ts: TrackState, left_u8, right_u8, gyro, acc, dts,
                    imu_mask, t, cam: Camera, cfg: SlamConfig, sync, imu_ok: bool = False,
                    have_imu_host: bool = True, lap=lambda stage: None, fe=None):
    """One SLAM iteration. `fe` is the frame's front-end result where the
    caller computed it already (a chunk's, batched), else the front end runs
    here on the two images. `sync(tensor)` reads device flags to the host;
    `imu_ok` (the IMU is initialized) and `have_imu_host` (the frame has IMU
    samples) are what the host already knows of `ts.imu_ok` and `imu_mask`.
    `lap(stage)` is called at the end of each stage of the step, for a
    caller that keeps host time by stage.
    Returns (MapState, TrackState, FrameOut, StepFlags)."""
    dev = ts.q.device
    if fe is None:
        fe = _frontend(left_u8, right_u8, cam, cfg)
        lap("frontend")
    featL, u_r, depth, has_depth, points_body = fe
    t_host = float(t)
    t = torch.as_tensor(t, dtype=F32, device=dev)
    K = st.kf_valid.shape[0]

    # ---------------- IMU
    have_imu = imu_mask.any()
    preint_frame = pre.integrate_assoc(gyro, acc, dts, imu_mask, ts.bg, ts.ba, noise=cfg.imu_noise)
    ts = ts._replace(kf_preint=_where_tree(have_imu, pre.merge(ts.kf_preint, preint_frame),
                                           ts.kf_preint))
    dt_frame = torch.clamp(t - ts.last_t, min=0.0)

    # ---------------- predict
    q_imu, v_imu, p_imu = pre.propagate(preint_frame, ts.q, ts.v, ts.p, ts.bg, ts.ba,
                                        gravity_w=ts.gravity_w)
    q_mm = quat.normalize(quat.mul(ts.q, ts.motion_dq))
    p_mm = ts.p + quat.rotate(ts.q, ts.motion_dp)
    use_imu_pred = ts.imu_ok & have_imu
    q_pred = torch.where(use_imu_pred, q_imu, q_mm)
    p_pred = torch.where(use_imu_pred, p_imu, p_mm)
    v_pred = torch.where(use_imu_pred, v_imu, ts.v)
    lap("imu_predict")

    # ---------------- match + solve
    matched, mp_w, vis_ids, vis_ok = match_local_map(
        st, cam, featL.uv, featL.desc, featL.octave, featL.valid, q_pred, p_pred, cfg.track)
    n_matches = torch.sum(matched >= 0, dtype=I32)
    use_fallback = (n_matches < cfg.min_track_inliers) & (ts.mode != MODE_NOT_INIT)
    fb_matched, fb_mp_w = _ref_kf_match(st, ts.last_kf, featL, cfg.track.max_hamming)
    matched = torch.where(use_fallback, fb_matched, matched)
    mp_w = torch.where(use_fallback, fb_mp_w, mp_w)
    n_matches = torch.sum(matched >= 0, dtype=I32)
    valid = matched >= 0
    enough = n_matches >= cfg.min_track_inliers
    lap("match")

    # no-prior robust pose: when projection matching under-filled, the
    # motion/IMU prior is suspect, so the solve is seeded from a batched
    # 3D-3D RANSAC over the fallback matches instead
    q_seed, p_seed = q_pred, p_pred
    if cfg.ransac_fallback:
        gen = torch.Generator(device=dev)
        gen.manual_seed(_ransac_seed(t_host))
        q_h, p_h, _, n_h = robust_pose_3d3d(mp_w, points_body, valid & has_depth, cam.bf, cam.fx,
                                            generator=gen, n_hyp=cfg.ransac_hyps)
        seeded = use_fallback & (n_h >= cfg.min_track_inliers)
        q_seed = torch.where(seeded, q_h, q_pred)
        p_seed = torch.where(seeded, p_h, p_pred)
        lap("ransac_seed")

    ur_obs = torch.where(valid, u_r, torch.full_like(u_r, -1.0))
    if imu_ok and have_imu_host:
        # while within imu_trust_recovery_s of the last tracking failure the
        # dead-reckoned prior is suspect: vision leads (cap 10), steady
        # tracking gets the full IMU edge (30)
        kf = ts.last_kf.long().clamp(0, K - 1)
        recovering = (t - ts.last_lost_t) < cfg.imu_trust_recovery_s
        cap = torch.where(recovering, torch.full_like(t, 10.0), torch.full_like(t, 30.0))
        q_new, p_new, v_new, _, _, inliers, n_inl = pose_inertial_optimize(
            q_seed, p_seed, v_pred, ts.bg, ts.ba, cam, mp_w, featL.uv, ur_obs, featL.octave,
            valid, ts.kf_preint, st.kf_q[kf], st.kf_p[kf], st.kf_v[kf], st.kf_bg[kf], st.kf_ba[kf],
            gravity=ts.gravity_w, imu_cap=cap)
        lap("pose_solve_vi")
    else:
        res = pose_optimize(q_seed, p_seed, cam, mp_w, featL.uv, ur_obs, featL.octave, valid)
        v_new = torch.where(dt_frame > 1e-6, (res.p - ts.p) / torch.clamp(dt_frame, min=1e-6),
                            ts.v)
        q_new, p_new, inliers, n_inl = res.q, res.p, res.inliers, res.n_inliers
        lap("pose_solve_visual")

    tracked_ok = enough & (n_inl >= cfg.min_track_inliers)
    q_new = torch.where(tracked_ok, q_new, q_pred)
    p_new = torch.where(tracked_ok, p_new, p_pred)
    v_new = torch.where(tracked_ok, v_new, v_pred)
    # velocity held within 0.5 m/s of the visual finite difference
    v_vis = (p_new - ts.p) / torch.clamp(dt_frame, min=1e-6)
    dv = v_new - v_vis
    dv_n = torch.linalg.norm(dv)
    v_new = torch.where(tracked_ok & (dt_frame > 1e-6) & (dv_n > 0.5),
                        v_vis + dv * (0.5 / torch.clamp(dv_n, min=1e-9)), v_new)
    speed = torch.linalg.norm(v_new)
    v_new = v_new * torch.clamp(cfg.max_speed / torch.clamp(speed, min=1e-6), max=1.0)

    initialized = ts.mode != MODE_NOT_INIT
    q_new = torch.where(initialized, q_new, ts.q)
    p_new = torch.where(initialized, p_new, ts.p)
    v_new = torch.where(initialized, v_new, ts.v)

    # ---------------- state machine
    now_lost = initialized & ~tracked_ok
    last_lost_t = torch.where(now_lost, t, ts.last_lost_t)
    lost_since = torch.where(now_lost, torch.where(ts.lost_since < 0, t, ts.lost_since),
                             torch.full_like(t, -1.0))
    lost_timeout = now_lost & (lost_since >= 0) & (t - lost_since > cfg.lost_timeout)
    i32 = (lambda v: torch.tensor(v, dtype=I32, device=dev))
    mode = torch.where(initialized, torch.where(tracked_ok, i32(MODE_OK), i32(MODE_RECENTLY_LOST)),
                       i32(MODE_NOT_INIT))
    mode = torch.where(lost_timeout, i32(MODE_NOT_INIT), mode)

    # ---------------- keyframe decision
    n_stereo = torch.sum(has_depth, dtype=I32)
    want_init = (mode == MODE_NOT_INIT) & (n_stereo >= 50)
    frames_since = ts.frames_since_kf + 1
    policy_kf = policy.keyframe_wanted(mode == MODE_OK, frames_since, n_inl, ts.ref_inliers,
                                       cfg.kf_max_frames, cfg.kf_inlier_ratio, cfg.kf_min_inliers)
    if cfg.insert_kfs_lost:
        policy_kf = policy_kf | policy.keyframe_wanted_lost(
            mode == MODE_RECENTLY_LOST, ts.imu_ok, have_imu, frames_since, cfg.kf_max_frames,
            allow_visual=cfg.insert_kfs_lost_visual)
    has_room = st.n_kf < K  # never insert past the keyframe array
    is_kf = (want_init | policy_kf) & has_room
    v_new = torch.where(want_init, torch.zeros_like(v_new), v_new)
    matched_for_insert = torch.where(want_init, torch.full_like(matched, -1), matched)
    cull_due = ts.kfs_since_cull + 1 >= cfg.cull_every_kfs
    n_active = sm.count_map_keyframes(st, st.active_map)
    mode_out = torch.where(want_init & has_room, i32(MODE_OK), mode)

    f_lost, f_kf, f_cull, f_tracked, n_active_h, mode_h, n_kf_h, n_mp_h, next_map_h = sync(
        torch.stack([lost_timeout.to(I32), is_kf.to(I32), cull_due.to(I32), tracked_ok.to(I32),
                     n_active, mode_out, st.n_kf, st.n_mp, st.next_map_id]))
    lap("decide_and_flag_read")

    if f_lost:  # atlas: lost beyond timeout -> reset or new map
        small = sm.reset_active_map(st)
        big = sm.create_new_map(st)
        st = _where_tree(n_active < cfg.min_kfs_keep_map, small, big)
        next_map_h += n_active_h >= cfg.min_kfs_keep_map
        n_active_h = 0  # either way the active map holds no keyframe now
    n_in_map = n_active_h + 1  # after this frame's insert

    vis, fnd = update_point_counters(st.mp_visible, st.mp_found, vis_ids, vis_ok, matched, inliers)
    st = st._replace(mp_visible=vis, mp_found=fnd)
    ts = ts._replace(
        motion_dq=torch.where(tracked_ok, quat.normalize(quat.mul(quat.conj(ts.q), q_new)),
                              ts.motion_dq),
        motion_dp=torch.where(tracked_ok, quat.rotate(quat.conj(ts.q), p_new - ts.p),
                              ts.motion_dp),
        q=q_new, p=p_new, v=v_new,
        mode=mode_out,
        lost_since=lost_since, last_lost_t=last_lost_t, last_t=t,
    )

    if f_kf:
        st, kf_id = sm.insert_keyframe(
            st, t, q_new, p_new, v_new, ts.bg, ts.ba, featL.uv, u_r, depth, featL.octave,
            featL.desc, points_body, featL.valid, matched_for_insert, ts.kf_preint,
            torch.where(want_init, i32(-1), ts.last_kf), new_mp_budget=cfg.new_mp_budget)
        # insert-time tracking quality (0 while dead-reckoning, n_stereo for
        # a map anchor)
        q_inl = torch.where(want_init, n_stereo,
                            torch.where(tracked_ok, n_inl, torch.zeros_like(n_inl))).to(I32)
        st = st._replace(kf_inliers=sm.set_row(st.kf_inliers, kf_id, q_inl))
        lap("kf_insert")
        # local BA from the map's third keyframe on, and only for a keyframe
        # inserted with a visual solve (an observation-less window is
        # unanchored); visual-inertial temporal-window BA once the IMU is
        # initialized
        if n_in_map >= 3 and f_tracked:
            if imu_ok:
                prob, ids, valid_w, pt_ids, pt_valid = build_vi_ba_problem(
                    st, kf_id, cfg.ba_window, cfg.ba_points, ts.gravity_w, cfg.vi_ba_fixed)
                ba = solve_vi_ba(prob, cam, iters=cfg.ba_iters)
                kf_q, kf_p, kf_v, kf_bg, kf_ba, mp_pos = apply_vi_ba_results(
                    st, ids, valid_w & prob.opt_cam, ba.q, ba.p, ba.v, ba.bg, ba.ba, pt_ids,
                    pt_valid, ba.Xw)
                st = st._replace(kf_q=kf_q, kf_p=kf_p, kf_v=kf_v, kf_bg=kf_bg, kf_ba=kf_ba,
                                 mp_pos=mp_pos)
                lap("vi_ba")
            else:
                prob, ids, valid_w, pt_ids, pt_valid = build_ba_problem(
                    st, kf_id, cfg.ba_window, cfg.ba_points, cfg.ba_fixed)
                ba = solve_local_ba(prob, cam, iters=cfg.ba_iters)
                kf_q, kf_p, mp_pos = apply_ba_results(st, ids, valid_w & prob.opt_cam, ba.q, ba.p,
                                                      pt_ids, pt_valid, ba.Xw)
                st = st._replace(kf_q=kf_q, kf_p=kf_p, mp_pos=mp_pos)
                lap("local_ba")
        # triangulation of unmatched features, duplicate fusion, and the
        # medoid descriptor / normal / depth refresh of the touched points
        if cfg.triangulate_mono and n_in_map >= 2:
            st, _ = triangulate_with_neighbor(st, kf_id, cam)
            lap("triangulate")
        if cfg.fuse_neighbors and n_in_map >= 3:
            st = mo.fuse_map_points(st, kf_id, cam)
            lap("fuse")
        if cfg.update_point_stats and n_in_map >= 2:
            st = mo.update_point_stats(st, kf_id)
            lap("point_stats")
        # redundancy keyframe culling: up to kf_cull_max_per_insert removals
        # per insert, the redundancy recomputed after each; a pass without a
        # candidate writes nothing
        if cfg.kf_cull_redundancy > 0 and n_in_map >= 7:
            thresh = cfg.kf_cull_redundancy_vi if imu_ok else cfg.kf_cull_redundancy
            for _ in range(cfg.kf_cull_max_per_insert):
                cand = mo.select_cull_candidate(st, kf_id, thresh, cfg.kf_cull_max_gap)
                st = mo.remove_keyframe(st, cand.clamp(0, K - 1), enable=cand >= 0)
            lap("kf_cull")
        if f_cull:
            st = sm.cull_map_points(st)
            lap("mp_cull")
        adopt = ts.imu_ok & tracked_ok
        kk = kf_id.long()
        new_bg = torch.where(adopt, 0.7 * ts.bg + 0.3 * st.kf_bg[kk], ts.bg)
        new_ba = torch.where(adopt, 0.7 * ts.ba + 0.3 * st.kf_ba[kk], ts.ba)
        ts = ts._replace(
            last_kf=kf_id.to(I32), frames_since_kf=i32(0),
            ref_inliers=torch.clamp(torch.where(want_init, n_stereo, n_matches), min=1),
            kfs_since_cull=i32(0) if f_cull else ts.kfs_since_cull + 1,
            kf_preint=pre.PreintState.identity(new_bg, new_ba),
            q=st.kf_q[kk], p=st.kf_p[kk], v=torch.where(adopt, st.kf_v[kk], ts.v),
            bg=new_bg, ba=new_ba,
        )
    else:
        kf_id = i32(-1)
        ts = ts._replace(frames_since_kf=frames_since)

    # ---------------- tracking-quality metrics
    r_fin = visual_residuals(ts.q, ts.p, cam, mp_w, featL.uv,
                             torch.where(valid, u_r, torch.full_like(u_r, -1.0)))
    inl_f = inliers.to(F32) * valid.to(F32)
    sq = torch.sum(r_fin[:, :2] ** 2, -1)
    mean_reproj = torch.sqrt(torch.sum(sq * inl_f) / torch.clamp(torch.sum(inl_f), min=1.0))

    ref = ts.last_kf.long().clamp(0, K - 1)
    ref_ok = (ts.mode != MODE_NOT_INIT) & st.kf_valid[ref]
    q_ref, p_ref = st.kf_q[ref], st.kf_p[ref]
    out = FrameOut(
        q=ts.q, p=ts.p, v=ts.v, n_matches=n_matches, n_inliers=n_inl, mode=ts.mode,
        is_kf=is_kf, kf_id=kf_id.to(I32), n_kf=st.n_kf,
        n_features=torch.sum(featL.valid, dtype=I32), n_stereo=n_stereo,
        mean_reproj_px=mean_reproj,
        ref_kf=torch.where(ref_ok, ref.to(I32), i32(-1)),
        rel_q=quat.normalize(quat.mul(quat.conj(q_ref), ts.q)),
        rel_p=quat.rotate(quat.conj(q_ref), ts.p - p_ref),
    )
    lap("bookkeeping")
    return st, ts, out, StepFlags(bool(f_lost), bool(f_kf), mode_h, n_kf_h + bool(f_kf), n_mp_h,
                                  next_map_h)


def slam_step_chunk(st: sm.MapState, ts: TrackState, lefts, rights, gyro, acc, dts, imu_mask,
                    t, cam: Camera, cfg: SlamConfig, sync, have_imu_host, imu_ok: bool = False,
                    lap=lambda stage: None):
    """C SLAM iterations on inputs that carry a leading chunk axis: the
    front end once on all 2C images, then the step's back end frame by
    frame (each frame's branches depend on the one before it, so each reads
    its own flags). `t` is a sequence of C host floats and `have_imu_host`
    of C bools. Latency grows by C frames: a throughput/latency knob.
    Returns (MapState, TrackState, FrameOut with every field stacked over
    the chunk, [StepFlags] * C)."""
    C = lefts.shape[0]
    fe = _frontend_chunk(lefts, rights, cam, cfg)
    lap("frontend")
    outs, flags = [], []
    for i in range(C):
        st, ts, out, fl = _slam_step_core(
            st, ts, None, None, gyro[i], acc[i], dts[i], imu_mask[i], t[i], cam, cfg, sync,
            imu_ok=imu_ok, have_imu_host=have_imu_host[i], lap=lap, fe=_frontend_frame(fe, i))
        outs.append(out)
        flags.append(fl)
    outs = FrameOut(*[torch.stack(f) for f in zip(*outs)])
    lap("chunk_outputs")
    return st, ts, outs, flags


def _retarget_tracker(ts: TrackState, q_old, p_old, q_new, p_new,
                      rotate_gravity: bool = False) -> TrackState:
    """Apply a loop or merge correction's world-frame delta to the live
    tracker state. ts was estimated while keyframe k sat at (q_old, p_old);
    the correction moved k to (q_new, p_new), i.e. world points were remapped
    by T_delta = T_new . T_old^-1. The motion deltas are body-relative and
    invariant under it.

    Gravity belongs to the map's world frame: a same-map correction folds
    the drifted segment back into the unchanged anchor frame, so gravity
    stays (rotating it would tilt it by the drift rotation). Only a
    cross-map merge (rotate_gravity=True) re-expresses the tracker's whole
    world frame, and then gravity moves with it."""
    qd = quat.normalize(quat.mul(q_new, quat.conj(q_old)))
    pd = p_new - quat.rotate(qd, p_old)
    return ts._replace(
        q=quat.normalize(quat.mul(qd, ts.q)),
        p=quat.rotate(qd, ts.p) + pd,
        v=quat.rotate(qd, ts.v),
        gravity_w=quat.rotate(qd, ts.gravity_w) if rotate_gravity else ts.gravity_w,
    )


class FusedSlam:
    """Host wrapper around the SLAM step: streams frames, keeps per-frame
    outputs on the device and reads them at the end, and runs the rare
    host services (IMU initialization and refinement, map compaction)
    every `service_every` frames. With `chunk` > 1 frames are buffered and
    dispatched `chunk` at a time (`flush`), the front end batched over the
    whole chunk.

    Runs on `device`: the CUDA card unless the caller passes another device
    (device="cpu" runs on the CPU), and a RuntimeError where there is no
    card; the device is picked before anything else. The camera is moved
    there. With a `vocabulary` (loop/vocab.py::Vocabulary) the service
    rounds run the loop closer with `loop_cfg` (LoopConfig() by default);
    `warmup` runs its programs once at construction so that their first
    calls do not land at the first loop closure. Without a vocabulary,
    `loop_cfg` and `warmup` do nothing."""

    def __init__(self, cam: Camera, cfg: SlamConfig, vocabulary=None, service_every: int = 8,
                 chunk: int = 1, warmup: bool = False, loop_cfg=None, device=None):
        self.device = default_device(device)
        set_full_precision()
        self.cam = cam.to(self.device)
        self.cfg = cfg
        self.map = sm.empty_map(cfg.cap, device=self.device)
        self.ts = TrackState.initial(self.device)
        # (t, FrameOut) a frame at chunk=1, ([t] * C, batched FrameOut) a chunk
        self.outs: list = []
        # compaction remaps for the corrected trajectory export: an entry of
        # `outs` recorded at epoch e passes its ref_kf through every remap
        # appended after e
        self._out_epochs: list = []
        self._kf_remaps: list = []
        self.service_every = service_every
        self.chunk = chunk  # frames per dispatch (throughput knob)
        self._pending: list = []
        self.compactions = 0
        self.map_evictions = 0  # archived maps dropped under keyframe pressure
        self.kf_evictions = 0  # keyframes thinned out of one full active map
        self.mp_evictions = 0  # stale map points evicted under point pressure
        self._frames = 0
        self._last_t = 0.0
        self.imu_initialized = False
        # host mirrors of device counters, exact after every frame (they come
        # with the frame's flag read): rows in use, and upper bounds on them
        # for the capacity check
        self._n_kf = 0
        self._kf_ub = 0
        self._mp_ub = 0
        # IMU-init refinement phases: re-run the gravity / bias solve as the
        # map matures, with priors phased out by map age
        self._imu_init_time: float | None = None
        self._imu_phase = 0  # 0 uninit, then one per _REFINE_PHASES entry
        self.imu_init_frame: int | None = None  # index of the frame it initialized after
        self.imu_refines = 0
        self.bad_imu_resets = 0
        # one-shot gravity/bias refine requested by a loop correction (the
        # loop closer sets it; nothing in this package does yet)
        self._refine_request = False
        self._refine_attempt_round = -99
        # tracker mode as of the previous service round (the JAX package reads
        # it one round late): time-phased refines are deferred while not OK
        self._last_mode_snap = MODE_OK
        self._mode_inflight: int | None = None
        self._mode = MODE_NOT_INIT
        self._service_round = 0
        self.host_syncs = 0  # explicit device->host reads (see _sync)
        self.timing: dict[str, list] = {}
        # the JAX host acts on snapshots one service round old: the keyframe
        # count (keyframes are serviced one round late), the atlas size
        # (whether archived maps exist) and the tracker mode; these hold
        # this round's mirrors for the next one
        self._next_map_id = 1
        self._nkf_inflight: int | None = None
        self._mapid_inflight: int | None = None
        self._multi_map = False  # sticky: archived maps exist
        # the last service round whose mode snapshot was not OK, and the
        # round until which loop closing runs in relocalization mode
        self._trouble_round = 0
        self._reloc_until = -1
        self._n_kf_seen = 0  # keyframe rows the loop closer has serviced
        self.loop_closer = None
        if vocabulary is not None:
            from orbslam3_tpu_torch.loop.closer import LoopCloser, LoopConfig

            self.loop_closer = LoopCloser(vocabulary.to(self.device), loop_cfg or LoopConfig(),
                                          sync=self._sync)
            if warmup:
                self.loop_closer.warmup(self.map, self.cam)
        from orbslam3_tpu_torch.utils.logging import Throttle, get_logger

        self._log = get_logger("orbslam3_tpu_torch.fused")
        # counts service rounds (one per service_every frames)
        self._log_throttle = Throttle(max(100 // max(service_every, 1), 1))

    # ------------------------------------------------------------------
    def _sync(self, flags):
        """Read a small device tensor to the host: one device sync."""
        self.host_syncs += 1
        return flags.tolist()

    def _tic(self):
        return time.perf_counter()

    def _toc(self, name: str, t0: float):
        cell = self.timing.setdefault(name, [0.0, 0])
        cell[0] += time.perf_counter() - t0
        cell[1] += 1

    def _lap(self, stage: str):
        """End of a stage of the step: its host time since the last lap."""
        now = time.perf_counter()
        cell = self.timing.setdefault("step." + stage, [0.0, 0])
        cell[0] += now - self._lap_t
        cell[1] += 1
        self._lap_t = now

    def timing_report(self) -> dict:
        """Per-stage host wall time: {stage: {total_s, calls, mean_ms}}.
        "step" is the whole per-frame step and "step.<stage>" its parts in
        order, each counted from the end of the one before it (their totals
        add up to it; "step.bookkeeping" is the rest of the step after the
        last named stage, "step.chunk_outputs" the stacking of a chunk's
        outputs, once a chunk). The device runs ahead of the host, so device
        time lands in the stage that next waits for it
        ("step.decide_and_flag_read" holds the per-frame flag read; "imu_init"
        and "imu_refine" hold their own reads). With a loop closer,
        "loop_service" / "loop_correct" are its per-keyframe services and
        "loop.<stage>" the closer's own stages inside them."""
        cells = dict(self.timing)
        if self.loop_closer is not None:
            cells.update(self.loop_closer.timing)
        return {
            k: {"total_s": round(v[0], 4), "calls": v[1],
                "mean_ms": round(1e3 * v[0] / max(v[1], 1), 3)}
            for k, v in sorted(cells.items())
        }

    def _pad_imu(self, gyro, acc, dts):
        return pre.pad_imu_window(gyro, acc, dts, self.cfg.max_imu_per_frame)

    @classmethod
    def from_state(cls, cam: Camera, cfg: SlamConfig, map_state, track_state,
                   **kwargs) -> "FusedSlam":
        """Resume a running system from a (MapState, TrackState) pair, as a
        checkpoint holds it (map/checkpoint.py::load_map). The state is moved
        to the system's device (`device=` as in the constructor).

        The host mirrors are set from the state in one read: row counts,
        atlas size, tracker mode, last frame time (the newest keyframe's),
        IMU phase (a resumed session with an initialized IMU skips the
        initialization and the time-phased refinements). Keyframes already
        in the map are not serviced by the loop closer; they stay candidates,
        as place recognition matches against the map's descriptors."""
        slam = cls(cam, cfg, **kwargs)
        dev = slam.device
        slam.map, slam.ts = to_device(map_state, dev), to_device(track_state, dev)
        m = slam.map
        K = m.kf_valid.shape[0]
        in_use = torch.arange(K, device=dev) < m.n_kf
        newest = torch.where(in_use, m.kf_time, torch.zeros_like(m.kf_time)).max()
        n_kf, n_mp, imu_ok, mode, last_t, next_map = slam._sync(torch.stack(
            [x.to(torch.float64) for x in (m.n_kf, m.n_mp, slam.ts.imu_ok, slam.ts.mode, newest,
                                           m.next_map_id)]))
        slam._n_kf = slam._kf_ub = slam._n_kf_seen = int(n_kf)
        slam._mp_ub = int(n_mp)
        slam._next_map_id = int(next_map)
        slam._mode = int(mode)
        if slam._n_kf:
            slam._last_t = float(np.float32(last_t))
        if imu_ok:
            slam.imu_initialized = True
            slam._imu_phase = 3  # past all refinement phases
            slam._imu_init_time = slam._last_t
        return slam

    def process_frame(self, left, right, gyro, acc, dts, t: float):
        t0 = self._tic()
        g, a, d, m = self._pad_imu(gyro, acc, dts)
        l_u8 = np.asarray(left, np.uint8) if left.dtype != np.uint8 else left
        r_u8 = np.asarray(right, np.uint8) if right.dtype != np.uint8 else right
        out = None
        if self.chunk > 1:
            self._pending.append((l_u8, r_u8, g, a, d, m, np.float32(t)))
            if len(self._pending) >= self.chunk:
                out = self.flush()
        else:
            dev = self.device
            args = [torch.from_numpy(np.ascontiguousarray(x)).to(dev)
                    for x in (l_u8, r_u8, g, a, d, m)]
            self._toc("upload", t0)
            t0 = self._lap_t = self._tic()
            self.map, self.ts, out, flags = _slam_step_core(
                self.map, self.ts, *args, np.float32(t), self.cam, self.cfg, self._sync,
                imu_ok=self.imu_initialized, have_imu_host=bool(m.any()), lap=self._lap)
            self._toc("step", t0)
            self.outs.append((t, out))
            self._out_epochs.append(len(self._kf_remaps))
            self._mirror(flags)
        self._frames += 1
        self._last_t = float(t)
        # host services only while something host-side remains to do
        need_services = (self.loop_closer is not None
                         or (self.cfg.use_imu and not self.imu_initialized)
                         or self._imu_refine_due() or self._compact_due())
        if need_services and self._frames % self.service_every == 0:
            if self._pending:
                self.flush()
            t0 = self._tic()
            self._host_services()
            self._toc("host_services", t0)
        return out

    def _mirror(self, flags: StepFlags):
        """Host mirrors of the device's counters after a step."""
        self._mode = flags.mode
        self._n_kf = flags.n_kf
        self._next_map_id = flags.next_map_id
        # rows in use: exact for keyframes; a keyframe adds at most the
        # stereo spawn budget plus the triangulated points
        self._kf_ub = flags.n_kf
        self._mp_ub = flags.n_mp + (self.cfg.new_mp_budget + 128) * flags.is_kf

    def _compact_due(self) -> bool:
        """The row bounds reach the capacity margin; a buffered frame counts
        for the most rows it can add (one keyframe and its points)."""
        cap = self.cfg.cap
        n = len(self._pending)
        return (self._kf_ub + n >= cap.max_kf - 4
                or self._mp_ub + n * (self.cfg.new_mp_budget + 128)
                >= cap.max_mp - 2 * self.cfg.new_mp_budget)

    def _host_services(self, final: bool = False):
        """Rare host-side work: IMU initialization until it succeeds, then
        the time-phased refinements; the loop closer's service of every
        keyframe up to the count of the round before (final=True, at the end
        of the sequence: up to the present count), or on a round without a
        new keyframe the closer's in-flight work; and the capacity check.

        Like the JAX host, a round acts on the keyframe count, atlas size and
        tracker mode of the round before; the port knows them exactly after
        every frame and keeps the previous round's values."""
        cfg = self.cfg
        self._service_round += 1
        snap, self._nkf_inflight = self._nkf_inflight, self._n_kf
        snap_mm, self._mapid_inflight = self._mapid_inflight, self._next_map_id
        snap_mode, self._mode_inflight = self._mode_inflight, self._mode
        if snap_mode is not None:
            self._last_mode_snap = snap_mode
            if snap_mode != MODE_OK:
                # large loop seams stay plausible for ~50 rounds after trouble
                self._trouble_round = self._service_round
            if snap_mode == MODE_RECENTLY_LOST:
                self._reloc_until = self._service_round + 4
        n_kf = self._n_kf if final or snap is None else snap
        if snap_mm is not None:
            self._multi_map = self._multi_map or snap_mm > 1
        if self.loop_closer is not None and self.imu_initialized:
            self.loop_closer.gravity_w = self.ts.gravity_w
        if cfg.use_imu and not self.imu_initialized:
            if self._n_kf >= cfg.imu_init_kfs:
                t0 = self._tic()
                self._try_imu_init(self._n_kf)
                self._toc("imu_init", t0)
        elif self._imu_refine_due():
            t0 = self._tic()
            self._imu_refine()
            self._toc("imu_refine", t0)
        new_kfs = self._n_kf_seen < n_kf
        while self._n_kf_seen < n_kf:
            k = self._n_kf_seen
            if self.loop_closer is not None:
                # keyframe k's pose before the service: a correction moves
                # every keyframe, so its delta at row k retargets the tracker
                q_old, p_old = self.map.kf_q[k].clone(), self.map.kf_p[k].clone()
                t0 = self._tic()
                self.map, corrected = self.loop_closer.on_keyframe(
                    self.map, k, self.cam, multi_map=self._multi_map,
                    round_id=self._service_round,
                    reloc=self._service_round < self._reloc_until,
                    # steady: no tracking trouble for 50 rounds arms the
                    # closer's implied-seam veto (session start counts as trouble)
                    steady=(self._last_mode_snap == MODE_OK
                            and self._service_round - self._trouble_round > 50))
                self._toc("loop_correct" if corrected else "loop_service", t0)
                if corrected:
                    self._after_correction(q_old, p_old, k)
            self._n_kf_seen += 1
        if not new_kfs:
            # idle round: act on the in-flight packet, leave a verification
            # it dispatches for the next round
            self._drain_loop_closer(sync=False)
        t0 = self._tic()
        self._maybe_compact()
        self._toc("compaction", t0)
        # throttled run log: host-side counters only, no device read
        if self._log_throttle.ready():
            self._log.info(
                "frame=%d t=%.2fs kfs_seen=%d imu=%s compactions=%d loops=%s",
                self._frames, self._last_t, self._n_kf_seen, self.imu_initialized,
                self.compactions,
                self.loop_closer.stats.corrected if self.loop_closer else "-")

    def _after_correction(self, q_old, p_old, k: int):
        """The tracker follows a correction that moved keyframe k from
        (q_old, p_old), and a gravity / bias refinement is requested against
        the corrected poses."""
        self.ts = _retarget_tracker(self.ts, q_old, p_old, self.map.kf_q[k], self.map.kf_p[k],
                                    rotate_gravity=self.loop_closer.last_was_merge)
        self._refine_request = True

    def _drain_loop_closer(self, sync: bool = True):
        """Act on the loop closer's in-flight detection packet and
        verification. sync=False (idle rounds) leaves a verification the
        packet dispatches for the next round."""
        if self.loop_closer is None or self.loop_closer.pending_kf is None:
            return
        pk = self.loop_closer.pending_kf
        q_old, p_old = self.map.kf_q[pk].clone(), self.map.kf_p[pk].clone()
        self.map, corrected = self.loop_closer.drain(self.map, self.cam, sync=sync)
        if corrected:
            self._after_correction(q_old, p_old, pk)

    def _compact_once(self):
        """One compaction pass and the host's remap bookkeeping, with one
        device read: the old->new keyframe table, the pre-compaction temporal
        chain, the tracker's reference keyframe and the new row counts."""
        prev_chain = self.map.kf_prev  # pre-compaction rows
        self.map, kf_map, _ = compact_map(self.map)
        K = kf_map.shape[0]
        table = self._sync(torch.cat([kf_map, prev_chain, torch.stack(
            [self.ts.last_kf, self.map.n_kf, self.map.n_mp])]))
        km, prev_chain = np.asarray(table[:K]), table[K:2 * K]
        lk, n_kf, n_mp = table[2 * K:]
        # if the tracker's reference keyframe was culled, walk its temporal
        # chain to the nearest surviving predecessor rather than silently
        # re-referencing row 0 (an arbitrary oldest keyframe)
        new_lk = -1
        for _ in range(K):
            if not (0 <= lk < K):
                break
            new_lk = int(km[lk])
            if new_lk >= 0:
                break
            lk = prev_chain[lk]
        self.ts = self.ts._replace(
            last_kf=torch.tensor(max(new_lk, 0), dtype=I32, device=self.device))
        if self.loop_closer is not None:
            self.loop_closer.remap_rows(km)
        # only rows already serviced count as seen: the keyframes newer than
        # the last round's count still get their service next round
        self._n_kf_seen = int((km[:self._n_kf_seen] >= 0).sum())
        self._nkf_inflight = None  # it counted pre-compaction rows
        self._kf_remaps.append(km)
        self.compactions += 1
        self._n_kf = self._kf_ub = n_kf
        self._mp_ub = n_mp

    def _maybe_compact(self):
        """Reclaim culled rows when capacity nears exhaustion. Runs as a
        host service, only near the capacity ceiling; each pass reads the
        device once, and so does each decision between passes.

        If capacity stays exhausted after compaction, live rows are what
        occupy it and something must go or the system wedges or starves:
        - keyframe rows held by archived maps: evict the oldest archived map
          first (a tracking loss at full capacity could otherwise never
          insert the fresh map's anchor keyframe);
        - keyframe rows of one giant active map: pressure-evict the most
          connected non-recent keyframes (spatial thinning: without new
          keyframe rows no map point can spawn and tracking starves as the
          camera moves on);
        - map-point rows: evict stale low-value points (regular culling only
          removes weak young points; mature out-of-view points live forever
          and a textured world spawns corners without bound)."""
        if not self._compact_due():
            return
        cap, cfg = self.cfg.cap, self.cfg
        kf_margin = cap.max_kf - 4
        mp_margin = cap.max_mp - 2 * cfg.new_mp_budget
        n_kf, n_mp = self._sync(torch.stack([self.map.n_kf, self.map.n_mp]))
        self._n_kf = self._kf_ub = n_kf
        self._mp_ub = n_mp
        if n_kf < kf_margin and n_mp < mp_margin:
            return
        K = cap.max_kf
        self._compact_once()
        while self._n_kf >= kf_margin:
            m = self.map
            table = self._sync(torch.cat([m.kf_map_id, m.kf_valid.to(I32), m.active_map[None]]))
            kf_map_id, kf_valid, active = np.asarray(table[:K]), np.asarray(table[K:2 * K]), table[-1]
            archived = sorted(set(kf_map_id[kf_valid > 0].tolist()) - {active})
            if archived:
                self.map = sm.drop_map(m, torch.tensor(archived[0], dtype=I32, device=self.device))
                self.map_evictions += 1
            else:
                # one giant active map: thin the densest regions. A pass
                # without a candidate writes nothing, and neither does any
                # pass after it.
                evicted = torch.zeros((), dtype=I32, device=self.device)
                for _ in range(max(K // 8, 4)):
                    k = mo.select_pressure_evict_kf(m, self.ts.last_kf)
                    m = mo.remove_keyframe(m, k.clamp(0, K - 1), enable=k >= 0)
                    evicted = evicted + (k >= 0).to(I32)
                (evicted,) = self._sync(evicted[None])
                if evicted == 0:
                    break
                self.kf_evictions += evicted
                # orphaned points (they lost their observers) go with them
                self.map = sm.cull_map_points(m)
            self._compact_once()
        # stale-point eviction: free at least 4 keyframes' spawn headroom per
        # pass, bounded by the per-pass cap of the point removal
        n_evict = min(max(cap.max_mp // 8, 4 * cfg.new_mp_budget), 4096)
        while self._mp_ub >= mp_margin:
            before = self._mp_ub
            self.map = sm.evict_stale_points(self.map, n_evict)
            self._compact_once()
            if self._mp_ub >= before:
                break  # nothing eligible (all protected)
            self.mp_evictions += before - self._mp_ub

    # ---------------------------------------------------------------- IMU
    def _fetch_kf_table(self, n_kf: int) -> dict:
        """The keyframe columns an IMU init or refine attempt looks at, for
        rows [0, n_kf), in one device-to-host copy (float64 holds every
        int32 and float32 exactly)."""
        m = self.map
        f64 = torch.float64
        cols = [m.kf_valid, m.kf_map_id, m.kf_inliers, m.kf_time, m.kf_preint.dt]
        table = torch.cat([torch.stack([c[:n_kf].to(f64) for c in cols], dim=1),
                           m.kf_p[:n_kf].to(f64), m.active_map.to(f64).expand(n_kf, 1)], dim=1)
        self.host_syncs += 1
        tab = table.cpu().numpy()
        return dict(valid=tab[:, 0] > 0, map_id=tab[:, 1].astype(np.int64),
                    inliers=tab[:, 2].astype(np.int64), time=tab[:, 3].astype(np.float32),
                    dt=tab[:, 4].astype(np.float32), p=tab[:, 5:8].astype(np.float32),
                    active=int(tab[0, 8]))

    def _imu_window(self, ids: list, dt):
        """The fixed 16-row window of an inertial_init call: `ids` (at most
        16 keyframe rows, oldest first) padded in front by repeating the
        oldest row, with the padding's edges masked. Returns None when fewer
        than len(ids) - 2 edges carry a preintegration, else
        (idx tensor (16,), pad, PreintState (15,), edge_valid (15,))."""
        W = len(ids)
        pad = 16 - W
        ids = [ids[0]] * pad + ids
        edge_valid = (dt[ids[1:]] > 1e-4) & (np.arange(15) >= pad)
        if int(edge_valid.sum()) < W - 2:
            return None
        idx = torch.tensor(ids, dtype=torch.long, device=self.device)
        preints = pre.PreintState(*[a[idx[1:]] for a in self.map.kf_preint])
        return idx, pad, preints, torch.from_numpy(edge_valid).to(self.device)

    def _try_imu_init(self, n_kf: int):
        cfg = self.cfg
        tab = self._fetch_kf_table(n_kf)
        in_map = [k for k in range(n_kf) if tab["valid"][k] and tab["map_id"][k] == tab["active"]]
        if len(in_map) < cfg.imu_init_kfs:
            return
        ids = in_map[-16:]
        if float(tab["time"][ids[-1]] - tab["time"][ids[0]]) < cfg.imu_init_min_time:
            return
        # sufficient-motion guard: a static camera cannot observe gravity.
        # After bad_imu_timeout with less than bad_imu_min_motion of
        # displacement, reset the map rather than poison the init
        ps_w = tab["p"][in_map]
        motion = float(np.linalg.norm(ps_w - ps_w[0], axis=1).max())
        full_span = float(tab["time"][in_map[-1]] - tab["time"][in_map[0]])
        if motion < cfg.bad_imu_min_motion:
            if full_span >= cfg.bad_imu_timeout:
                self._reset_bad_imu()
            return
        win = self._imu_window(ids, tab["dt"])
        if win is None:
            return
        idx, pad, preints, edge_valid = win
        res = inertial_init(self.map.kf_q[idx], self.map.kf_p[idx], preints, edge_valid)
        g_norm, cost0, cost1 = self._sync(torch.stack(
            [torch.linalg.norm(res.gravity_w), res.cost0, res.cost1]))
        if not (8.5 < g_norm < 11.0) or not cost1 < cost0:
            return
        # only the real rows are written (the padding repeats a row)
        idx_r = idx[pad:]
        W = idx_r.shape[0]
        self.map = self.map._replace(
            kf_v=self.map.kf_v.index_copy(0, idx_r, res.vels[pad:]),
            kf_bg=self.map.kf_bg.index_copy(0, idx_r, res.bias_g.expand(W, 3)),
            kf_ba=self.map.kf_ba.index_copy(0, idx_r, res.bias_a.expand(W, 3)))
        self.ts = self.ts._replace(
            gravity_w=res.gravity_w, bg=res.bias_g, ba=res.bias_a, v=res.vels[-1],
            imu_ok=torch.ones((), dtype=torch.bool, device=self.device))
        self.imu_initialized = True
        self._imu_phase = 1
        self._imu_init_time = self._last_t
        self.imu_init_frame = self._frames - 1

    # refinement thresholds [s since the first init] and prior scales
    _REFINE_PHASES = ((1, 5.0, 0.3), (2, 15.0, 0.02), (3, 30.0, 0.02))

    def _imu_refine_due(self) -> bool:
        if not self.imu_initialized or self._imu_init_time is None:
            return False
        if self._refine_request:
            # an armed request retries every 4th round: its guards need
            # seconds of new healthy keyframes to start passing
            return self._service_round - self._refine_attempt_round >= 4
        if self._last_mode_snap != MODE_OK:
            return False  # defer: the window's poses are dead-reckoned or drifting
        age = self._last_t - self._imu_init_time
        return any(self._imu_phase == phase and age >= after
                   for phase, after, _ in self._REFINE_PHASES)

    def _imu_refine(self):
        """Re-estimate the gravity direction and the biases against the
        matured, VI-BA-polished keyframe poses."""
        self._refine_attempt_round = self._service_round
        is_request = self._refine_request
        if is_request:
            scale = 0.1  # after a loop correction: a moderate prior
        else:
            scale = {p: s for p, _, s in self._REFINE_PHASES}[self._imu_phase]
            self._imu_phase += 1  # one attempt per phase either way
        cfg = self.cfg
        n_kf = self._n_kf
        tab = self._fetch_kf_table(n_kf)
        all_in_map = [k for k in range(n_kf)
                      if tab["valid"][k] and tab["map_id"][k] == tab["active"]]
        # the trailing contiguous healthy run only: a dead-reckoned
        # keyframe's pose carries no gravity information, and contiguity
        # keeps the stored preintegration edges aligned with the pose pairs
        in_map = []
        for k in reversed(all_in_map):
            if tab["inliers"][k] < 30:
                break
            in_map.append(k)
        in_map.reverse()
        if len(in_map) < cfg.imu_init_kfs:
            return  # a pending request stays armed until enough healthy keyframes
        # observability guard: gravity needs a window of real duration
        if float(tab["time"][in_map[-1]] - tab["time"][in_map[max(-len(in_map), -16)]]) < 3.0:
            return
        if is_request:
            self._refine_request = False
        win = self._imu_window(in_map[-16:], tab["dt"])
        if win is None:
            return
        idx, pad, preints, edge_valid = win
        res = inertial_init(self.map.kf_q[idx], self.map.kf_p[idx], preints, edge_valid,
                            prior_scale=scale)
        out = self._sync(torch.cat([res.gravity_w, self.ts.gravity_w,
                                    torch.stack([res.cost0, res.cost1])]))
        g_new, g_old, (cost0, cost1) = np.float32(out[0:3]), np.float32(out[3:6]), out[6:8]
        g_norm = float(np.linalg.norm(g_new))
        if not (9.0 < g_norm < 10.6) or not cost1 < cost0:
            return
        # direction-jump guard: once initialized the gravity error is a few
        # degrees at most; a large swing is a degenerate window's noise
        cosang = float(np.dot(g_old, g_new)
                       / max(np.linalg.norm(g_old) * np.linalg.norm(g_new), 1e-9))
        if cosang < np.cos(np.radians(10.0)):
            return
        # accept: gravity and biases (velocities stay VI-BA's)
        self.ts = self.ts._replace(gravity_w=res.gravity_w, bg=res.bias_g, ba=res.bias_a)
        idx_r = idx[pad:]
        W = idx_r.shape[0]
        self.map = self.map._replace(
            kf_bg=self.map.kf_bg.index_copy(0, idx_r, res.bias_g.expand(W, 3)),
            kf_ba=self.map.kf_ba.index_copy(0, idx_r, res.bias_a.expand(W, 3)))
        self.imu_refines += 1

    def _reset_bad_imu(self):
        """Static-start recovery: drop the poisoned map, restart tracking."""
        dev = self.device
        z3 = torch.zeros(3, dtype=F32, device=dev)
        self.map = sm.reset_active_map(self.map)
        self.ts = self.ts._replace(
            mode=torch.tensor(MODE_NOT_INIT, dtype=I32, device=dev), v=z3, bg=z3.clone(),
            ba=z3.clone(), kf_preint=pre.PreintState.identity(device=dev),
            frames_since_kf=torch.tensor(0, dtype=I32, device=dev),
            lost_since=torch.tensor(-1.0, dtype=F32, device=dev))
        self.bad_imu_resets += 1
        self._imu_phase = 0
        self._imu_init_time = None

    def flush(self):
        """Dispatch the buffered frames as one chunk: one upload of the
        stacked inputs, one batched front end, then the steps in turn. The
        chunk's FrameOut stays one batched entry of `outs`."""
        if not self._pending:
            return None
        t0 = self._tic()
        batch, self._pending = self._pending, []
        dev = self.device
        stacked = [torch.from_numpy(np.stack([b[i] for b in batch])).to(dev) for i in range(6)]
        ts_ = [b[6] for b in batch]
        self._toc("upload", t0)
        t0 = self._lap_t = self._tic()
        self.map, self.ts, outs, flags = slam_step_chunk(
            self.map, self.ts, *stacked, ts_, self.cam, self.cfg, self._sync,
            [bool(b[5].any()) for b in batch], imu_ok=self.imu_initialized, lap=self._lap)
        # the chunk's frames share its time: "step" stays a per-frame figure
        # and its stages go on adding up to it
        cell = self.timing.setdefault("step", [0.0, 0])
        cell[0] += time.perf_counter() - t0
        cell[1] += len(batch)
        self._toc("dispatch_chunk", t0)
        self.outs.append(([float(t) for t in ts_], outs))
        self._out_epochs.append(len(self._kf_remaps))
        self._mirror(flags[-1])
        return outs

    def finalize(self):
        """End of sequence: dispatch the buffered frames, a last service
        round (with a loop closer, or if the IMU is still to be
        initialized) over every keyframe, act on the loop closer's in-flight
        work, then wait for the device."""
        self.flush()
        if self.loop_closer is not None or (self.cfg.use_imu and not self.imu_initialized):
            self._host_services(final=True)
        self._drain_loop_closer()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------------
    def _flat_outs(self):
        """(times, FrameOut of numpy arrays stacked over every frame, the
        compaction epoch of every frame): one device read per field for the
        whole sequence. A chunk's entry holds a batched FrameOut."""
        ts_, eps, fields = [], [], [[] for _ in FrameOut._fields]
        for (t, o), ep in zip(self.outs, self._out_epochs):
            chunked = isinstance(t, list)
            ts_.extend(t if chunked else [t])
            eps.extend([ep] * (len(t) if chunked else 1))
            for col, x in zip(fields, o):
                col.append(x if chunked else x[None])
        if not self.outs:
            return ts_, None, eps
        return ts_, FrameOut(*[torch.cat(col).cpu().numpy() for col in fields]), eps

    def frame_outputs(self):
        """The FrameOut of every processed frame, its fields stacked over the
        sequence as numpy arrays (None before the first frame)."""
        return self._flat_outs()[1]

    def trajectory_arrays(self, corrected: bool = True):
        """(times, positions, quats). With corrected=True each frame pose is
        re-composed from its reference keyframe's final pose, found through
        the compaction remaps made since the frame was recorded; a frame
        whose reference keyframe was compacted away keeps its raw pose."""
        from orbslam3_tpu_torch.io.synthetic import _qmul, _qnorm, _qrot

        ts_, outs, eps = self._flat_outs()
        if outs is None:
            return np.asarray(ts_), np.zeros((0, 3), np.float32), np.zeros((0, 4), np.float32)
        ps = outs.p.copy()
        qs = outs.q.copy()
        if not corrected:
            return np.asarray(ts_), ps, qs
        kf_q = self.map.kf_q.cpu().numpy().astype(np.float64)
        kf_p = self.map.kf_p.cpu().numpy().astype(np.float64)
        K = len(kf_q)
        for i in range(len(ts_)):
            ref = int(outs.ref_kf[i])
            for km in self._kf_remaps[eps[i]:]:
                if ref < 0:
                    break
                ref = int(km[ref]) if ref < len(km) else -1
            if ref < 0 or ref >= K:
                continue
            qr = kf_q[ref]
            qs[i] = _qnorm(_qmul(qr, outs.rel_q[i].astype(np.float64))).astype(np.float32)
            ps[i] = (kf_p[ref] + _qrot(qr, outs.rel_p[i].astype(np.float64))).astype(np.float32)
        return np.asarray(ts_), ps, qs

    def modes(self):
        outs = self._flat_outs()[1]
        return np.zeros(0, int) if outs is None else outs.mode.astype(int)
