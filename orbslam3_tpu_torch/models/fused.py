"""The per-frame SLAM step and its host wrapper, for the stereo slice.

Port of orbslam3_tpu/models/fused.py at chunk=1: `TrackState`, `FrameOut`,
`_frontend`, `_slam_step_core` and `FusedSlam`. The JAX package runs the
whole step as one XLA program with lax.cond branches; here the step runs
eagerly on the state's device and each lax.cond on a device value became:

* one host read of a few flags (`FusedSlam._sync`), for the expensive
  branches: the lost-timeout reset, the keyframe insert, and inside it
  local BA and the map-point cull. The four flags are read together, once
  per frame; only a frame that resets the map and inserts a keyframe in
  one go reads the BA flag a second time;
* torch.where over both results, for the reference-keyframe Hamming
  fallback (one (N, N) Hamming matrix);
* nothing, for the choice between the visual and the visual-inertial pose
  solve: `imu_ok` changes only in the host's IMU-initialization service,
  which the slice does not run, so the host knows it is False.

`FusedSlam` refuses (NotImplementedError) every option whose code path is
not ported yet, and map compaction: see SLICE_CFG.
"""
from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch

from orbslam3_tpu_torch import set_full_precision
from orbslam3_tpu_torch.frontend.camera import Camera
from orbslam3_tpu_torch.frontend.orb import detect_orb_pair
from orbslam3_tpu_torch.frontend.stereo import match_stereo
from orbslam3_tpu_torch.geometry import quat
from orbslam3_tpu_torch.imu import preintegration as pre
from orbslam3_tpu_torch.map import slam_map as sm
from orbslam3_tpu_torch.models import policy
from orbslam3_tpu_torch.models.local_mapper import apply_ba_results, build_ba_problem
from orbslam3_tpu_torch.models.slam import SlamConfig
from orbslam3_tpu_torch.models.tracker import match_local_map, update_point_counters
from orbslam3_tpu_torch.ops.hamming import hamming_matrix
from orbslam3_tpu_torch.optim.local_ba import solve_local_ba
from orbslam3_tpu_torch.optim.pose_only import pose_optimize, visual_residuals

MODE_NOT_INIT = 0
MODE_OK = 1
MODE_RECENTLY_LOST = 2

I32 = torch.int32
F32 = torch.float32

# The configuration the port runs: the JAX package's defaults with the
# options that are not ported yet turned off (the JAX package supports this
# configuration itself; tests/test_e2e_stereo.py runs use_imu=False).
SLICE_CFG = SlamConfig(use_imu=False, ransac_fallback=False, triangulate_mono=False,
                       fuse_neighbors=False, update_point_stats=False, kf_cull_redundancy=0.0)


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


def _frontend(left_u8, right_u8, cam: Camera, cfg: SlamConfig):
    """ORB pair detection + stereo matching; body-frame 3D points."""
    featL, featR = detect_orb_pair(left_u8.to(F32), right_u8.to(F32), cfg.orb)
    u_r, depth, has_depth = match_stereo(featL, featR, cam, cfg.stereo)
    points_body = cam.cam_pts_to_body(
        cam.unproject(featL.uv, torch.where(has_depth, depth, torch.ones_like(depth))))
    return featL, u_r, depth, has_depth, points_body


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
    return type(a)(*[torch.where(c, x, y) for x, y in zip(a, b)])


def _slam_step_core(st: sm.MapState, ts: TrackState, left_u8, right_u8, gyro, acc, dts,
                    imu_mask, t, cam: Camera, cfg: SlamConfig, sync):
    """One SLAM iteration. `sync(tensor)` reads device flags to the host.
    Returns (MapState, TrackState, FrameOut)."""
    dev = ts.q.device
    featL, u_r, depth, has_depth, points_body = _frontend(left_u8, right_u8, cam, cfg)
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

    res = pose_optimize(q_pred, p_pred, cam, mp_w, featL.uv,
                        torch.where(valid, u_r, torch.full_like(u_r, -1.0)), featL.octave, valid)
    v_vis_solve = torch.where(dt_frame > 1e-6, (res.p - ts.p) / torch.clamp(dt_frame, min=1e-6),
                              ts.v)
    q_new, p_new, v_new, inliers, n_inl = res.q, res.p, v_vis_solve, res.inliers, res.n_inliers

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
    # local BA runs when the map holds >= 3 keyframes after this insert
    ba_due = (sm.count_map_keyframes(st, st.active_map) + 1 >= 3) & tracked_ok

    f_lost, f_kf, f_ba, f_cull = sync(torch.stack([lost_timeout, is_kf, ba_due, cull_due]))

    if f_lost:  # atlas: lost beyond timeout -> reset or new map
        n_active = sm.count_map_keyframes(st, st.active_map)
        small = sm.reset_active_map(st)
        big = sm.create_new_map(st)
        st = _where_tree(n_active < cfg.min_kfs_keep_map, small, big)
        if f_kf:
            f_ba = sync(((sm.count_map_keyframes(st, st.active_map) + 1 >= 3)
                         & tracked_ok)[None])[0]

    vis, fnd = update_point_counters(st.mp_visible, st.mp_found, vis_ids, vis_ok, matched, inliers)
    st = st._replace(mp_visible=vis, mp_found=fnd)
    ts = ts._replace(
        motion_dq=torch.where(tracked_ok, quat.normalize(quat.mul(quat.conj(ts.q), q_new)),
                              ts.motion_dq),
        motion_dp=torch.where(tracked_ok, quat.rotate(quat.conj(ts.q), p_new - ts.p),
                              ts.motion_dp),
        q=q_new, p=p_new, v=v_new,
        mode=torch.where(want_init & has_room, i32(MODE_OK), mode),
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
        if f_ba:
            prob, ids, valid_w, pt_ids, pt_valid = build_ba_problem(
                st, kf_id, cfg.ba_window, cfg.ba_points, cfg.ba_fixed)
            ba = solve_local_ba(prob, cam, iters=cfg.ba_iters)
            kf_q, kf_p, mp_pos = apply_ba_results(st, ids, valid_w & prob.opt_cam, ba.q, ba.p,
                                                  pt_ids, pt_valid, ba.Xw)
            st = st._replace(kf_q=kf_q, kf_p=kf_p, mp_pos=mp_pos)
        if f_cull:
            st = sm.cull_map_points(st)
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
    return st, ts, out


class FusedSlam:
    """Host wrapper around the SLAM step: streams frames, keeps per-frame
    outputs on the device and reads them at the end.

    Runs the stereo slice (SLICE_CFG) at chunk=1 on `device`: the CUDA card
    unless the caller passes another device (device="cpu" runs on the CPU),
    and a RuntimeError where there is no card. The camera is moved there.
    Everything else raises NotImplementedError."""

    def __init__(self, cam: Camera, cfg: SlamConfig, vocabulary=None, service_every: int = 8,
                 chunk: int = 1, loop_cfg=None, device=None):
        refused = []
        if cfg.use_imu:
            refused.append("use_imu=True (IMU initialization and visual-inertial BA)")
        for flag in ("ransac_fallback", "triangulate_mono", "fuse_neighbors",
                     "update_point_stats"):
            if getattr(cfg, flag):
                refused.append(f"{flag}=True")
        if cfg.kf_cull_redundancy > 0:
            refused.append("kf_cull_redundancy>0 (keyframe culling)")
        if vocabulary is not None or loop_cfg is not None:
            refused.append("a vocabulary (loop closing)")
        if chunk != 1:
            refused.append("chunk>1 (batched dispatch)")
        if refused:
            raise NotImplementedError(
                "orbslam3_tpu_torch runs the stereo slice only (models/fused.py::SLICE_CFG); "
                "not ported yet: " + ", ".join(refused))
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "FusedSlam runs on device 'cuda' by default and no CUDA device is "
                    "available (torch.cuda.is_available() is False); pass device='cpu' "
                    "to run on the CPU")
            device = "cuda"
        self.device = torch.device(device)
        set_full_precision()
        self.cam = cam.to(self.device)
        self.cfg = cfg
        self.map = sm.empty_map(cfg.cap, device=self.device)
        self.ts = TrackState.initial(self.device)
        self.outs: list = []  # (t, FrameOut), device tensors
        self.service_every = service_every
        self._frames = 0
        # host-side upper bounds on row usage (no device reads), resynced to
        # the true counts when a capacity check reads them
        self._kf_ub = 0
        self._mp_ub = 0
        self.host_syncs = 0  # explicit device->host reads (see _sync)
        self.timing: dict[str, list] = {}

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

    def timing_report(self) -> dict:
        """Per-stage host wall time: {stage: {total_s, calls, mean_ms}}.
        The device runs ahead of the host, so device time lands in the
        stage that next waits for it ("step", which holds the per-frame
        flag read)."""
        return {
            k: {"total_s": round(v[0], 4), "calls": v[1],
                "mean_ms": round(1e3 * v[0] / max(v[1], 1), 3)}
            for k, v in sorted(self.timing.items())
        }

    def _pad_imu(self, gyro, acc, dts):
        return pre.pad_imu_window(gyro, acc, dts, self.cfg.max_imu_per_frame)

    def process_frame(self, left, right, gyro, acc, dts, t: float):
        t0 = self._tic()
        g, a, d, m = self._pad_imu(gyro, acc, dts)
        l_u8 = np.asarray(left, np.uint8) if left.dtype != np.uint8 else left
        r_u8 = np.asarray(right, np.uint8) if right.dtype != np.uint8 else right
        dev = self.device
        args = [torch.from_numpy(np.ascontiguousarray(x)).to(dev) for x in (l_u8, r_u8, g, a, d, m)]
        self._toc("upload", t0)
        t0 = self._tic()
        self.map, self.ts, out = _slam_step_core(self.map, self.ts, *args, np.float32(t),
                                                 self.cam, self.cfg, self._sync)
        self._toc("step", t0)
        self.outs.append((t, out))
        self._frames += 1
        # worst-case rows a frame can add
        self._kf_ub += 1
        self._mp_ub += self.cfg.new_mp_budget + 128
        if self._compact_due() and self._frames % self.service_every == 0:
            t0 = self._tic()
            self._host_services()
            self._toc("host_services", t0)
        return out

    def _compact_due(self) -> bool:
        cap = self.cfg.cap
        return (self._kf_ub >= cap.max_kf - 4
                or self._mp_ub >= cap.max_mp - 2 * self.cfg.new_mp_budget)

    def _host_services(self):
        """The slice's only host service: the capacity check."""
        t0 = self._tic()
        self._maybe_compact()
        self._toc("compaction", t0)

    def _maybe_compact(self):
        """Read the true row counts once the host-side bounds near
        capacity. Compaction itself is not ported: a map that really reaches
        the margin raises NotImplementedError."""
        if not self._compact_due():
            return
        n_kf, n_mp = self._sync(torch.stack([self.map.n_kf, self.map.n_mp]))
        cap = self.cfg.cap
        if n_kf >= cap.max_kf - 4 or n_mp >= cap.max_mp - 2 * self.cfg.new_mp_budget:
            raise NotImplementedError(
                f"map compaction is not ported yet (n_kf={n_kf}/{cap.max_kf}, "
                f"n_mp={n_mp}/{cap.max_mp})")
        self._kf_ub = n_kf
        self._mp_ub = n_mp

    def flush(self):
        """No buffered frames at chunk=1."""
        return None

    def finalize(self):
        """End of sequence: nothing is buffered and no host service remains
        in the slice; waits for the device."""
        self.flush()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------------
    def _flat_outs(self):
        """(times, FrameOut of stacked numpy arrays) — one device read per
        field for the whole sequence."""
        ts_ = [t for t, _ in self.outs]
        if not self.outs:
            return ts_, None
        outs = FrameOut(*[torch.stack([o[i] for _, o in self.outs]).cpu().numpy()
                          for i in range(len(FrameOut._fields))])
        return ts_, outs

    def trajectory_arrays(self, corrected: bool = True):
        """(times, positions, quats). With corrected=True each frame pose is
        re-composed from its reference keyframe's final pose."""
        from orbslam3_tpu_torch.io.synthetic import _qmul, _qnorm, _qrot

        ts_, outs = self._flat_outs()
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
            if ref < 0 or ref >= K:
                continue
            qr = kf_q[ref]
            qs[i] = _qnorm(_qmul(qr, outs.rel_q[i].astype(np.float64))).astype(np.float32)
            ps[i] = (kf_p[ref] + _qrot(qr, outs.rel_p[i].astype(np.float64))).astype(np.float32)
        return np.asarray(ts_), ps, qs

    def modes(self):
        _, outs = self._flat_outs()
        return np.zeros(0, int) if outs is None else outs.mode.astype(int)
