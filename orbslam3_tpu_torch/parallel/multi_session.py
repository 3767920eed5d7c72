"""Multi-session SLAM: D independent sessions laid over a list of devices.

Port of orbslam3_tpu/parallel/multi_session.py. The JAX package maps a
fleet (D robots or recorded sequences) by sharding whole sessions over a
1-D mesh axis, one session a device, each device stepping its session with
the single-session program. Here `devices` takes the mesh's place: session
s lives on devices[s], and with devices=None the sessions go round-robin
over the CUDA cards, so all D share one card where there is one. Sessions
are independent (no collectives), and each steps through the same chunk
program as a lone FusedSlam (`models/fused.py::slam_step_chunk`): one
batched front end and one FAST/NMS launch a session a flush in which it has
frames.

The host API mirrors the JAX class. Frames are buffered per session; a
flush takes c = min(chunk, longest pending) and every session up to c of
its frames, and runs the fleet's step (`make_multi_session_step`, the
counterpart of the JAX package's sharded step). A session with fewer (or
none) steps only those: its remaining slots are `valid=False`, leave its
state untouched and record the JAX package's placeholder FrameOut, which
`trajectory_arrays` filters out. One short or stalled stream therefore never
repeats a frame.

No host services run (no IMU initialization, compaction or loop closing),
as in the JAX package: a fleet with use_imu=True never initializes its IMU.
The intended flow is to stream every sequence through the fleet, then
finish each session (`session_state`) or weld them (`merge_session_maps`).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from orbslam3_tpu_torch import set_full_precision
from orbslam3_tpu_torch.frontend.camera import Camera
from orbslam3_tpu_torch.imu.preintegration import pad_imu_window
from orbslam3_tpu_torch.map.slam_map import empty_map
from orbslam3_tpu_torch.models.fused import (FrameOut, TrackState, _as_u8,
                                              slam_step_chunk)


def fleet_devices(n_sessions: int, devices=None) -> list:
    """The device of each session: `devices` (one entry a session), or the
    CUDA cards round-robin. A RuntimeError where there is no card and no
    `devices` (pass devices=["cpu"] * D to run on the CPU)."""
    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n == 0:
            raise RuntimeError(
                "MultiSessionSlam lays its sessions over the CUDA cards by default and no "
                "CUDA device is available; pass devices=['cpu'] * n_sessions to run on the CPU")
        devices = [f"cuda:{s % n}" for s in range(n_sessions)]
    if len(devices) != n_sessions:
        raise ValueError(f"{n_sessions} sessions need {n_sessions} devices, got {len(devices)}")
    return [torch.device(d) for d in devices]


def _placeholder(st, ts) -> FrameOut:
    """The FrameOut a valid=False slot records (JAX multi_session.py's
    `skip`): the session's current pose and mode, nothing tracked."""
    dev = ts.q.device
    i32 = lambda v: torch.tensor(v, dtype=torch.int32, device=dev)
    return FrameOut(q=ts.q, p=ts.p, v=ts.v, n_matches=i32(0), n_inliers=i32(0), mode=ts.mode,
                    is_kf=torch.tensor(False, device=dev), kf_id=i32(-1), n_kf=st.n_kf,
                    n_features=i32(0), n_stereo=i32(0),
                    mean_reproj_px=torch.tensor(0.0, dtype=torch.float32, device=dev),
                    ref_kf=i32(-1),
                    rel_q=torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=torch.float32, device=dev),
                    rel_p=torch.zeros(3, dtype=torch.float32, device=dev))


def _host(x) -> np.ndarray:
    """A host array or tensor as a numpy array."""
    return np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)


def _rows(x, idx, dev):
    """Rows `idx` of a host array or tensor, stacked on `dev`."""
    if isinstance(x, torch.Tensor):
        return x[idx].to(dev)
    return torch.from_numpy(np.ascontiguousarray(x[idx])).to(dev)


def make_multi_session_step(devices, cam: Camera, cfg):
    """The fleet's step over sessions laid on `devices` (session s on
    devices[s]): step(sts, tss, lefts, rights, gyro, acc, dts, imu_mask, t,
    valid) -> (sts, tss, outs), with sts and tss the D sessions' MapStates and
    TrackStates, frame arrays of (D, chunk, ...) (host arrays or tensors, or a
    list of D such (chunk, ...) arrays; t and imu_mask are read on the host)
    and `valid` (D, chunk) host bools; outs is one FrameOut a session with
    `chunk` rows.

    A valid=False slot leaves its session untouched and records the
    placeholder FrameOut of the session's state at that slot. Each run of
    consecutive valid slots of a session goes through `slam_step_chunk` on
    that session's device (one batched front end, one FAST/NMS launch), so a
    session whose valid slots lead its chunk steps exactly as a lone
    FusedSlam at the same chunk would. Optional keywords: `sync` reads the
    per-frame flags (FusedSlam._sync's role), `step_s` accumulates each
    session's host wall."""
    devices = [torch.device(d) for d in devices]
    cams = [cam.to(dev) for dev in devices]

    def read(flags):
        return flags.tolist()

    def step(sts, tss, lefts, rights, gyro, acc, dts, imu_mask, t, valid, sync=read,
             step_s=None):
        valid = np.asarray(valid, bool)
        t = [_host(t[s]).astype(np.float32) for s in range(len(devices))]
        mask = [_host(imu_mask[s]) for s in range(len(devices))]
        sts, tss, outs = list(sts), list(tss), []
        for s, dev in enumerate(devices):
            rows, i, c = [], 0, valid.shape[1]
            t0 = time.perf_counter()
            while i < c:
                j = i
                while j < c and valid[s, j] == valid[s, i]:
                    j += 1
                if valid[s, i]:
                    idx = np.arange(i, j)
                    stacked = [_rows(x[s], idx, dev)
                               for x in (lefts, rights, gyro, acc, dts, imu_mask)]
                    sts[s], tss[s], out, _ = slam_step_chunk(
                        sts[s], tss[s], *stacked, list(t[s][i:j]), cams[s], cfg, sync,
                        [bool(mask[s][k].any()) for k in idx])
                    rows.append(out)
                else:
                    pad = _placeholder(sts[s], tss[s])
                    rows.append(FrameOut(*[torch.stack([x] * (j - i)) for x in pad]))
                i = j
            if step_s is not None:
                step_s[s] += time.perf_counter() - t0
            outs.append(rows[0] if len(rows) == 1 else FrameOut(
                *[torch.cat(f) for f in zip(*rows)]))
        return sts, tss, outs

    return step


class MultiSessionSlam:
    """Host wrapper around D concurrent SLAM sessions."""

    def __init__(self, cam: Camera, cfg, n_sessions: int, chunk: int = 4, devices=None):
        self.devices = fleet_devices(n_sessions, devices)
        set_full_precision()
        self.cfg = cfg
        self.chunk = chunk
        self.d = n_sessions
        self.cams = [cam.to(dev) for dev in self.devices]
        self.maps = [empty_map(cfg.cap, device=dev) for dev in self.devices]
        self.tss = [TrackState.initial(dev) for dev in self.devices]
        self._step = make_multi_session_step(self.devices, cam, cfg)
        self._pending: list[list] = [[] for _ in range(n_sessions)]
        # one entry a flush: (times (D, c), [FrameOut with c rows] * D, valid (D, c))
        self.outs: list = []
        self._frames = 0
        # a shape template for the slots of sessions with fewer frames
        # buffered at dispatch time (their slots run with valid=False)
        self._template = None
        self.host_syncs = 0  # per-frame flag reads, summed over the sessions
        self.launches = [0] * n_sessions  # step chunks dispatched, per session
        # host wall of each session's steps (their flag reads wait for the device)
        self.step_s = [0.0] * n_sessions

    def _sync(self, flags):
        self.host_syncs += 1
        return flags.tolist()

    def process_frame(self, session: int, left, right, gyro, acc, dts, t: float):
        """Buffer one frame for `session`; dispatches a flush as soon as that
        session holds `chunk` frames."""
        g, a, d, m = pad_imu_window(gyro, acc, dts, self.cfg.max_imu_per_frame)
        frame = (_as_u8(left), _as_u8(right), g, a, d, m, np.float32(t))
        self._pending[session].append(frame)
        if self._template is None:
            self._template = tuple(x.new_zeros(x.shape) if isinstance(x, torch.Tensor)
                                   else np.zeros_like(x) for x in frame)
        if len(self._pending[session]) >= self.chunk:
            self.flush()

    def finalize(self):
        """Dispatch every session's buffered frames (ragged tails run with
        valid=False slots), then wait for the devices."""
        while any(self._pending):
            self.flush()
        for dev in set(self.devices):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

    def flush(self):
        """One fleet step over c = min(chunk, longest pending) slots: each
        session's first c buffered frames, padded with valid=False slots."""
        c = min(self.chunk, max((len(p) for p in self._pending), default=0))
        if c == 0:
            return
        valid = np.zeros((self.d, c), bool)
        batches = [[] for _ in range(7)]  # per field, one (c, ...) stack a session
        for s, pend in enumerate(self._pending):
            take, self._pending[s] = pend[:c], pend[c:]
            valid[s, :len(take)] = True
            slots = take + [self._template] * (c - len(take))
            for i in range(7):
                col = [f[i] for f in slots]
                batches[i].append(torch.stack(col) if isinstance(col[0], torch.Tensor)
                                  else np.stack(col))
        self.maps, self.tss, outs = self._step(self.maps, self.tss, *batches, valid,
                                               sync=self._sync, step_s=self.step_s)
        for s in range(self.d):
            self.launches[s] += int(valid[s].any())
        self.outs.append((np.stack(batches[6]), outs, valid))
        self._frames += int(valid.sum())

    def session_state(self, i: int):
        """Session i as a plain (MapState, TrackState) on its device: feed it
        to the per-session host work (loop closing, export, checkpoint)."""
        return self.maps[i], self.tss[i]

    def trajectory_arrays(self, i: int):
        """(times, positions, quats) tracked by session i so far, raw (not
        re-composed from the keyframes); valid=False slots filtered out."""
        ts_, ps, qs = [], [], []
        for t_arr, outs, valid in self.outs:
            m = valid[i]
            ts_.append(t_arr[i][m])
            ps.append(outs[i].p.cpu().numpy()[m])
            qs.append(outs[i].q.cpu().numpy()[m])
        if not ts_:
            return np.zeros((0,)), np.zeros((0, 3)), np.zeros((0, 4))
        return np.concatenate(ts_), np.concatenate(ps), np.concatenate(qs)

    def frame_outputs(self, i: int) -> FrameOut | None:
        """Session i's FrameOut of every frame it tracked, fields stacked as
        numpy arrays (valid=False slots filtered out)."""
        rows = [(outs[i], valid[i]) for _, outs, valid in self.outs]
        if not rows:
            return None
        return FrameOut(*[np.concatenate([getattr(o, f).cpu().numpy()[m] for o, m in rows])
                          for f in FrameOut._fields])


def merge_session_maps(states, vocab, cam: Camera, loop_cfg=None, sampler=None):
    """Weld session maps into one multi-map state (collaborative mapping).

    Concatenates every session's MapState (map/compaction.py::concat_maps)
    and replays every keyframe through a LoopCloser, then drains it: where a
    keyframe of one session recognizes another session's area, the verified
    Sim3 folds its whole map into the other's world frame and the pose graph
    refines the weld. Sessions with no overlap stay separate atlas maps.
    `sampler` is the closer's optional source of RANSAC draws
    (LoopCloser.sampler). Runs on the first state's device.

    Returns (MapState, LoopCloser): the closer carries the merge statistics."""
    from orbslam3_tpu_torch.interop import to_device
    from orbslam3_tpu_torch.loop.closer import LoopCloser, LoopConfig
    from orbslam3_tpu_torch.map.compaction import concat_maps

    st = states[0]
    dev = st.kf_q.device
    for other in states[1:]:
        st, _, _ = concat_maps(st, to_device(other, dev))
    cam = cam.to(dev)
    closer = LoopCloser(vocab.to(dev), loop_cfg or LoopConfig())
    closer.sampler = sampler
    for k in range(int(st.n_kf)):
        st, _ = closer.on_keyframe(st, k, cam)
    st, _ = closer.drain(st, cam)
    return st, closer
