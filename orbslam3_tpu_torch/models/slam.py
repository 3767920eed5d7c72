"""SlamConfig and SlamSystem: stage-by-stage host orchestration of the SLAM
pipeline (port of orbslam3_tpu/models/slam.py).

`FusedSlam` (models/fused.py) is the production pipeline. `SlamSystem`
dispatches the same device stages (process_stereo, match_local_map,
pose_[inertial_]optimize, insert_keyframe, local_ba_step, triangulation,
fusion, point statistics, culling) one at a time from the host, so each
stage can be timed on its own (scripts/profile_pipeline_torch.py) and the
state inspected between them. It differs from `FusedSlam` as the JAX class
does: visual-only local BA even after the IMU is initialized, the IMU
initialized inline at the keyframe that reaches `imu_init_kfs` (with the
static-start map reset), its own atlas handling (`_handle_lost` resets small
maps, archives large ones and re-initializes from the same frame), and no
reference-keyframe fallback, RANSAC seed, keyframes while lost or chunking.

The host reads the device where the JAX class's int(), float() and bool()
decide its control flow, reads that fall at one point in one transfer, and
once a frame for the FrameResult's pose; `host_syncs` counts them. IMU
windows stay host numpy arrays as in JAX; the preintegration runs the
sequential `pre.integrate` over the window's samples.

State machine: NotInitialized -> Ok -> RecentlyLost -> (reset / new map).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from orbslam3_tpu_torch import default_device, set_full_precision
from orbslam3_tpu_torch.frontend.camera import Camera
from orbslam3_tpu_torch.frontend.orb import OrbConfig
from orbslam3_tpu_torch.frontend.stereo import StereoConfig, StereoFrame, process_stereo
from orbslam3_tpu_torch.geometry import quat
from orbslam3_tpu_torch.imu import preintegration as pre
from orbslam3_tpu_torch.imu.preintegration import ImuNoise
from orbslam3_tpu_torch.map import mapping_ops as mo
from orbslam3_tpu_torch.map import slam_map as sm
from orbslam3_tpu_torch.map.compaction import compact_map
from orbslam3_tpu_torch.map.slam_map import MapCapacity
from orbslam3_tpu_torch.map.triangulation import triangulate_with_neighbor
from orbslam3_tpu_torch.models import policy
from orbslam3_tpu_torch.models.local_mapper import local_ba_step
from orbslam3_tpu_torch.models.tracker import TrackConfig, match_local_map, update_point_counters
from orbslam3_tpu_torch.optim.imu_init import inertial_init
from orbslam3_tpu_torch.optim.pose_only import pose_inertial_optimize, pose_optimize

F32 = torch.float32
I32 = torch.int32


class SlamConfig(NamedTuple):
    """Every field and default of orbslam3_tpu's SlamConfig."""

    orb: OrbConfig = OrbConfig()
    stereo: StereoConfig = StereoConfig()
    track: TrackConfig = TrackConfig()
    cap: MapCapacity = MapCapacity()
    # keyframe policy
    kf_max_frames: int = 10
    kf_inlier_ratio: float = 0.7
    kf_min_inliers: int = 25
    min_track_inliers: int = 12
    # local mapping
    ba_window: int = 8
    ba_points: int = 2048
    ba_fixed: int = 16  # fixed observer keyframes in visual local BA
    vi_ba_fixed: int = 0
    ba_iters: int = 4
    cull_every_kfs: int = 3
    new_mp_budget: int = 384
    # IMU
    use_imu: bool = True
    imu_noise: ImuNoise = ImuNoise()
    imu_init_kfs: int = 12
    imu_init_min_time: float = 1.0
    max_imu_per_frame: int = 32
    max_imu_per_kf: int = 512
    # atlas
    lost_timeout: float = 5.0
    min_kfs_keep_map: int = 10
    # recovery
    insert_kfs_lost: bool = True
    insert_kfs_lost_visual: bool = False
    ransac_fallback: bool = True
    ransac_hyps: int = 128
    bad_imu_timeout: float = 10.0
    bad_imu_min_motion: float = 0.02
    max_speed: float = 20.0
    imu_trust_recovery_s: float = 2.0
    # map maintenance
    fuse_neighbors: bool = True
    triangulate_mono: bool = True
    kf_cull_redundancy: float = 0.92  # 0 disables keyframe culling
    kf_cull_redundancy_vi: float = 0.7
    kf_cull_max_per_insert: int = 2
    kf_cull_max_gap: float = 3.0
    update_point_stats: bool = True


class FrameResult(NamedTuple):
    t: float
    q: np.ndarray
    p: np.ndarray
    n_matches: int
    n_inliers: int
    state: str
    is_keyframe: bool


class SlamSystem:
    """Host-orchestrated SLAM on `device`: the CUDA card unless the caller
    passes another device (device="cpu" runs on the CPU), a RuntimeError
    where there is no card. The camera is moved there."""

    def __init__(self, cam: Camera, cfg: SlamConfig = SlamConfig(), device=None):
        self.device = default_device(device)
        set_full_precision()
        dev = self.device
        self.cam = cam.to(dev)
        self.cfg = cfg
        self.map = sm.empty_map(cfg.cap, device=dev)
        self.state = "NotInitialized"
        # current body state
        self.q = quat.identity(device=dev)
        self.p = self._zeros3()
        self.v = self._zeros3()
        self.bg = self._zeros3()
        self.ba = self._zeros3()
        # motion model (per-frame body-frame delta)
        self.motion_dq = quat.identity(device=dev)
        self.motion_dp = self._zeros3()
        self.last_t: Optional[float] = None
        # keyframe bookkeeping
        self.last_kf_id = -1
        self.frames_since_kf = 0
        self.ref_inliers = 1
        self.kfs_since_cull = 0
        # IMU samples since the last keyframe (host numpy windows)
        self._kf_gyro: list = []
        self._kf_acc: list = []
        self._kf_dts: list = []
        self.imu_initialized = False
        self.gravity_w = None  # estimated gravity in the world frame
        self.trajectory: list[FrameResult] = []
        self._preint_frame = None
        self._frame_imu = None  # this frame's IMU window, integrated on first use
        self._kf_preint_cache = None  # (samples integrated, bg, ba, PreintState)
        self.lost_since: Optional[float] = None
        self.n_maps_created = 1
        self.bad_imu_resets = 0
        self.host_syncs = 0  # explicit device -> host reads

    # ------------------------------------------------------------------
    def _zeros3(self):
        return torch.zeros(3, dtype=F32, device=self.device)

    def _read(self, *xs) -> list:
        """Read device values to the host in one transfer: one sync. float64
        holds every int32 and float32 exactly."""
        self.host_syncs += 1
        return torch.stack([x.reshape(()).to(torch.float64) for x in xs]).tolist()

    def _upload(self, x):
        """A host array or a tensor as float32 on the system's device."""
        if isinstance(x, torch.Tensor):
            return x.to(self.device, F32)
        return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(self.device)

    def _integrate_window(self, gyro, acc, dts, n, init=None, start=0):
        """`pre.integrate` over pad_imu_window(gyro, acc, dts, n): padding rows
        leave the state as it is, so only the samples are stepped (rows
        [start, samples) from `init` when given)."""
        g, a, d, m = pre.pad_imu_window(gyro, acc, dts, n)
        k = int(m.sum())
        up = self._upload
        return pre.integrate(up(g[start:k]), up(a[start:k]), up(d[start:k]),
                             torch.from_numpy(m[start:k]).to(self.device), self.bg, self.ba,
                             noise=self.cfg.imu_noise, init=init)

    def _frame_preint(self):
        """This frame's preintegration. JAX integrates every frame's window
        as it comes; it is read only once the IMU is initialized, so here it
        is integrated on first use (the biases do not change in between)."""
        if self._preint_frame is None and self._frame_imu is not None:
            self._preint_frame = self._integrate_window(*self._frame_imu,
                                                        self.cfg.max_imu_per_frame)
        return self._preint_frame

    # ------------------------------------------------------------------
    def process_frame(self, left, right, gyro, acc, dts, t: float) -> FrameResult:
        """Track one stereo frame. Images (H, W) 0..255 (numpy or tensors);
        the IMU window is the samples between the previous frame and this
        one."""
        cfg = self.cfg
        sf = process_stereo(self._upload(left), self._upload(right), self.cam, cfg.orb,
                            cfg.stereo)

        self._preint_frame = None
        self._frame_imu = None
        if cfg.use_imu and len(dts) > 0:
            self._kf_gyro.append(np.asarray(gyro))
            self._kf_acc.append(np.asarray(acc))
            self._kf_dts.append(np.asarray(dts))
            self._frame_imu = (gyro, acc, dts)

        if self.state == "NotInitialized":
            return self._initialize(sf, t)

        # ---- predict
        dt_frame = (t - self.last_t) if self.last_t is not None else 0.0
        if self.imu_initialized and self._frame_imu is not None:
            q_pred, v_pred, p_pred = pre.propagate(self._frame_preint(), self.q, self.v, self.p,
                                                   self.bg, self.ba, gravity_w=self.gravity_w)
        else:
            q_pred = quat.normalize(quat.mul(self.q, self.motion_dq))
            p_pred = self.p + quat.rotate(self.q, self.motion_dp)
            v_pred = self.v

        # ---- match against the local map
        matched, mp_w, vis_ids, vis_ok = match_local_map(
            self.map, self.cam, sf.feat.uv, sf.feat.desc, sf.feat.octave, sf.feat.valid, q_pred,
            p_pred, cfg.track)
        (n_matches,) = self._read(torch.sum(matched >= 0, dtype=I32))
        n_matches = int(n_matches)

        if n_matches < cfg.min_track_inliers:
            # dead-reckon this frame (RecentlyLost)
            self.state = "RecentlyLost"
            self.q, self.p, self.v = q_pred, p_pred, v_pred
            if self.lost_since is None:
                self.lost_since = t
            elif t - self.lost_since > cfg.lost_timeout:
                return self._handle_lost(sf, t)
            res = self._result(t, n_matches, 0, False)
            self.trajectory.append(res)
            self._post_frame(t, dt_frame)
            return res

        # ---- pose solve
        valid = matched >= 0
        ur = torch.where(valid, sf.u_right, torch.full_like(sf.u_right, -1.0))
        if self.imu_initialized and self._frame_imu is not None:
            kf = self.last_kf_id
            m = self.map
            q_new, p_new, v_new, _, _, inliers, n_inl = pose_inertial_optimize(
                q_pred, p_pred, v_pred, self.bg, self.ba, self.cam, mp_w, sf.feat.uv, ur,
                sf.feat.octave, valid.to(F32), self._kf_preint_state(), m.kf_q[kf], m.kf_p[kf],
                m.kf_v[kf], m.kf_bg[kf], m.kf_ba[kf], gravity=self.gravity_w)
            # velocity is per-frame state; the biases stay anchored to the
            # last keyframe (per-frame bias updates random-walk away)
            self.v = v_new
        else:
            opt = pose_optimize(q_pred, p_pred, self.cam, mp_w, sf.feat.uv, ur, sf.feat.octave,
                                valid)
            q_new, p_new, inliers, n_inl = opt.q, opt.p, opt.inliers, opt.n_inliers
            if dt_frame > 0:
                self.v = (p_new - self.p) / torch.tensor(dt_frame, dtype=F32, device=self.device)

        (n_inl,) = self._read(n_inl)
        n_inl = int(n_inl)
        if n_inl < cfg.min_track_inliers:
            self.state = "RecentlyLost"
            q_new, p_new = q_pred, p_pred
            if self.lost_since is None:
                self.lost_since = t
            elif t - self.lost_since > cfg.lost_timeout:
                return self._handle_lost(sf, t)
        else:
            self.state = "Ok"
            self.lost_since = None

        # motion model update (body-frame delta)
        self.motion_dq = quat.normalize(quat.mul(quat.conj(self.q), q_new))
        self.motion_dp = quat.rotate(quat.conj(self.q), p_new - self.p)
        self.q, self.p = q_new, p_new

        # counters for culling
        vis, fnd = update_point_counters(self.map.mp_visible, self.map.mp_found, vis_ids, vis_ok,
                                         matched, inliers)
        self.map = self.map._replace(mp_visible=vis, mp_found=fnd)

        # ---- keyframe decision
        is_kf = self.state == "Ok" and self._keyframe_decision(n_inl)
        if is_kf:
            is_kf = self._insert_keyframe(sf, t, matched, n_matches)

        res = self._result(t, n_matches, n_inl, is_kf)
        self.trajectory.append(res)
        self._post_frame(t, dt_frame)
        return res

    # ------------------------------------------------------------------
    def _result(self, t, n_matches, n_inl, is_kf, state=None) -> FrameResult:
        """The frame's FrameResult, its pose read in one transfer."""
        self.host_syncs += 1
        qp = torch.cat([self.q, self.p]).cpu().numpy()
        return FrameResult(t, qp[:4], qp[4:], n_matches, n_inl, state or self.state, is_kf)

    def _post_frame(self, t, dt_frame):
        self.last_t = t
        self.frames_since_kf += 1

    def _keyframe_decision(self, n_inl: int) -> bool:
        """The policy function FusedSlam runs (models/policy.py), here on
        host counts."""
        cfg = self.cfg
        if self.frames_since_kf < 1:
            return False
        return bool(policy.keyframe_wanted(True, self.frames_since_kf, n_inl, self.ref_inliers,
                                           cfg.kf_max_frames, cfg.kf_inlier_ratio,
                                           cfg.kf_min_inliers))

    def _kf_preint_state(self):
        """Preintegration from the last keyframe to now, over the first
        max_imu_per_kf samples. A call continues the previous one's result
        while the biases are the same objects (equal to integrating from the
        keyframe, bit for bit)."""
        if not self._kf_dts:
            return pre.PreintState.identity(self.bg, self.ba)
        g = np.concatenate(self._kf_gyro)
        a = np.concatenate(self._kf_acc)
        d = np.concatenate(self._kf_dts)
        n = self.cfg.max_imu_per_kf
        c = self._kf_preint_cache
        if c is not None and c[1] is self.bg and c[2] is self.ba and c[0] <= min(len(d), n):
            st = self._integrate_window(g, a, d, n, init=c[3], start=c[0])
        else:
            st = self._integrate_window(g, a, d, n)
        self._kf_preint_cache = (min(len(d), n), self.bg, self.ba, st)
        return st

    def _clear_kf_imu(self):
        self._kf_gyro, self._kf_acc, self._kf_dts = [], [], []
        self._kf_preint_cache = None

    def _insert_keyframe(self, sf: StereoFrame, t, matched, n_matched: int) -> bool:
        """Insert the frame as a keyframe and run the local mapping after it.
        `n_matched` is the host's count of matched >= 0."""
        cfg = self.cfg
        dev = self.device
        n_kf, n_mp = (int(x) for x in self._read(self.map.n_kf, self.map.n_mp))
        # near capacity: compact culled rows back into the free pool
        if n_kf >= cfg.cap.max_kf or n_mp >= cfg.cap.max_mp - cfg.new_mp_budget:
            self.map, kf_map, mp_map = compact_map(self.map)
            # `matched` holds pre-compaction point rows; compaction permuted
            # them (culled targets map to -1 = unmatched)
            M = mp_map.shape[0]
            matched = torch.where(matched >= 0, mp_map[matched.long().clamp(0, M - 1)],
                                  torch.full_like(matched, -1))
            last = kf_map[max(self.last_kf_id, 0)]
            last, n_kf, n_matched = (int(x) for x in self._read(
                last, self.map.n_kf, torch.sum(matched >= 0, dtype=I32)))
            if self.last_kf_id >= 0:
                self.last_kf_id = last
        # capacity guard: past max_kf insert_keyframe's row writes would
        # land out of range while n_kf kept advancing
        if n_kf >= cfg.cap.max_kf:
            return False
        preint = self._kf_preint_state()
        self.map, kf_id = sm.insert_keyframe(
            self.map, t, self.q, self.p, self.v, self.bg, self.ba, sf.feat.uv, sf.u_right,
            sf.depth, sf.feat.octave, sf.feat.desc, self.cam.cam_pts_to_body(sf.points_cam),
            sf.feat.valid, matched, preint, torch.tensor(self.last_kf_id, dtype=I32, device=dev),
            new_mp_budget=cfg.new_mp_budget)
        kf = n_kf  # insert_keyframe writes row n_kf
        n_kf += 1
        self.last_kf_id = kf
        # insert-time quality for pose-graph edge weighting: the tracked-match
        # count (FusedSlam stores the pose solve's inliers)
        self.map = self.map._replace(kf_inliers=sm.set_row(
            self.map.kf_inliers, kf_id, torch.sum(matched >= 0, dtype=I32)))
        self.frames_since_kf = 0
        self._clear_kf_imu()

        # local BA around the new keyframe
        if n_kf >= 3:
            self.map, _ = local_ba_step(self.map, self.cam, kf_id, window=cfg.ba_window,
                                        max_points=cfg.ba_points, iters=cfg.ba_iters,
                                        fixed=cfg.ba_fixed)
            # adopt the refined keyframe pose as the current estimate
            self.q = self.map.kf_q[kf]
            self.p = self.map.kf_p[kf]

        # multi-view triangulation, duplicate fusion, point statistics and
        # keyframe culling
        if cfg.triangulate_mono and n_kf >= 2:
            self.map, _ = triangulate_with_neighbor(self.map, kf_id, self.cam)
        if cfg.fuse_neighbors and n_kf >= 3:
            self.map = mo.fuse_map_points(self.map, kf_id, self.cam)
        if cfg.update_point_stats and n_kf >= 2:
            self.map = mo.update_point_stats(self.map, kf_id)
        if cfg.kf_cull_redundancy > 0 and kf >= 6 and kf % 3 == 0 and kf - 4 > 0:
            cand = torch.tensor(kf - 4, dtype=I32, device=dev)
            ok, red = self._read(self.map.kf_valid[kf - 4],
                                 mo.keyframe_redundancy(self.map, cand))
            if ok and red > cfg.kf_cull_redundancy:
                self.map = mo.remove_keyframe(self.map, cand)

        self.kfs_since_cull += 1
        if self.kfs_since_cull >= cfg.cull_every_kfs:
            self.map = sm.cull_map_points(self.map)
            self.kfs_since_cull = 0

        self.ref_inliers = max(n_matched, 1)

        if cfg.use_imu and not self.imu_initialized and n_kf >= cfg.imu_init_kfs:
            self._try_imu_init(n_kf)
        return True

    def _try_imu_init(self, n_kf: int):
        """Gravity, velocity and bias initialization over the last 16
        keyframes of the active map, with the sufficient-motion guard."""
        cfg = self.cfg
        m = self.map
        f64 = torch.float64
        cols = [m.kf_valid, m.kf_map_id, m.kf_time, m.kf_preint.dt]
        table = torch.cat([torch.stack([c[:n_kf].to(f64) for c in cols], dim=1),
                           m.kf_p[:n_kf].to(f64), m.active_map.to(f64).expand(n_kf, 1)], dim=1)
        self.host_syncs += 1
        tab = table.cpu().numpy()
        kf_valid, kf_map = tab[:, 0] > 0, tab[:, 1].astype(np.int64)
        kf_time, kf_dt = tab[:, 2].astype(np.float32), tab[:, 3].astype(np.float32)
        active = int(tab[0, 7])
        in_map = [k for k in range(n_kf) if kf_valid[k] and kf_map[k] == active]
        if len(in_map) < cfg.imu_init_kfs:
            return
        ids = in_map[-16:]
        W = len(ids)
        if float(kf_time[ids[-1]] - kf_time[ids[0]]) < cfg.imu_init_min_time:
            return
        # sufficient-motion guard: a static camera cannot observe gravity
        ps_w = tab[:, 4:7].astype(np.float32)[in_map]
        motion = float(np.linalg.norm(ps_w - ps_w[0], axis=1).max())
        full_span = float(kf_time[in_map[-1]] - kf_time[in_map[0]])
        if motion < cfg.bad_imu_min_motion:
            if full_span >= cfg.bad_imu_timeout:
                self.map = sm.reset_active_map(self.map)
                self.state = "NotInitialized"
                self.last_kf_id = -1
                self.frames_since_kf = 0
                self.v, self.bg, self.ba = self._zeros3(), self._zeros3(), self._zeros3()
                self._clear_kf_imu()
                self.bad_imu_resets += 1
            return  # too static: gravity unobservable, no attempt
        # edge i: the preintegration stored on keyframe ids[i+1]
        edge_valid = kf_dt[ids[1:]] > 1e-4
        if int(edge_valid.sum()) < W - 2:
            return
        idx = torch.tensor(ids, dtype=torch.long, device=self.device)
        preints = pre.PreintState(*[a[idx[1:]] for a in m.kf_preint])
        res = inertial_init(m.kf_q[idx], m.kf_p[idx], preints,
                            torch.from_numpy(edge_valid).to(self.device))
        g_norm, cost0, cost1 = self._read(torch.linalg.norm(res.gravity_w), res.cost0, res.cost1)
        if not (8.5 < g_norm < 11.0) or not cost1 < cost0:
            return
        self.gravity_w = res.gravity_w
        self.bg = res.bias_g
        self.ba = res.bias_a
        self.v = res.vels[-1]
        # velocities and biases written back to the keyframes
        self.map = m._replace(kf_v=m.kf_v.index_copy(0, idx, res.vels),
                              kf_bg=m.kf_bg.index_copy(0, idx, res.bias_g.expand(W, 3)),
                              kf_ba=m.kf_ba.index_copy(0, idx, res.bias_a.expand(W, 3)))
        self.imu_initialized = True

    def _handle_lost(self, sf: StereoFrame, t):
        """Lost: reset a small map, archive a large one and start a new map,
        then re-initialize from this frame."""
        (n_active,) = self._read(sm.count_map_keyframes(self.map, self.map.active_map))
        if n_active < self.cfg.min_kfs_keep_map:
            self.map = sm.reset_active_map(self.map)
        else:
            self.map = sm.create_new_map(self.map)
            self.n_maps_created += 1
        self.state = "NotInitialized"
        self.lost_since = None
        self.last_kf_id = -1
        self.frames_since_kf = 0
        self.motion_dq = quat.identity(device=self.device)
        self.motion_dp = self._zeros3()
        self.v = self._zeros3()
        self._clear_kf_imu()
        # the predicted pose is kept, so the trajectory stays continuous
        # across the map change
        return self._initialize(sf, t)

    def _initialize(self, sf: StereoFrame, t):
        """First keyframe of a map at the current pose (world := the first
        body frame of the session). Needs 50 stereo points."""
        (n_stereo,) = self._read(torch.sum(sf.has_depth, dtype=I32))
        n_stereo = int(n_stereo)
        if n_stereo < 50:
            return self._result(t, 0, 0, False, "NotInitialized")
        matched = torch.full((sf.feat.uv.shape[0],), -1, dtype=I32, device=self.device)
        if not self._insert_keyframe(sf, t, matched, 0):
            # keyframe array full: stay uninitialized rather than flip to Ok
            # on a map that never received its anchor keyframe
            return self._result(t, 0, 0, False, "NotInitialized")
        self.state = "Ok"
        self.lost_since = None
        self.ref_inliers = n_stereo
        res = self._result(t, n_stereo, n_stereo, True, "Ok")
        self.trajectory.append(res)
        self.last_t = t
        return res

    # ------------------------------------------------------------------
    def trajectory_arrays(self):
        ts = np.array([r.t for r in self.trajectory])
        ps = np.stack([r.p for r in self.trajectory])
        qs = np.stack([r.q for r in self.trajectory])
        return ts, ps, qs
