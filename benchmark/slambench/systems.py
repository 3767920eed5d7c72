"""The system under test: the only module of the benchmark that imports the
program (orbslam3_tpu_torch).

A configuration's `system` names its driver here. A driver builds the
program's entry point from the configuration, feeds it the traffic's frames
the way a caller does (closed loop: the next frame goes in when the previous
pose is back), reads each pose to the host as the caller would, and
reports what the program counts and keeps (its stage timers, host syncs,
launches, keyframe rows, map points) for the readers and the check.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from orbslam3_tpu_torch.frontend.camera import Camera
from orbslam3_tpu_torch.models.fused import FusedSlam
from orbslam3_tpu_torch.models.slam import SlamConfig

def slam_config(d: dict) -> SlamConfig:
    """SlamConfig from the configuration file's `slam` object: every field
    by name, nested groups into their own NamedTuples; an unknown name
    raises."""
    defaults = SlamConfig._field_defaults
    kw = {}
    for k, v in d.items():
        if k not in defaults:
            raise KeyError(f"SlamConfig has no field {k!r}")
        kw[k] = type(defaults[k])(**v) if isinstance(v, dict) else v
    return SlamConfig(**kw)


def camera(config: dict, world) -> Camera:
    c = config["camera"]
    return Camera.create(c["fx"], c["fy"], c["width"] / 2.0, c["height"] / 2.0, c["baseline"],
                         c["width"], c["height"], q_bc=world.q_bc32, p_bc=world.p_bc32)


def _stamp(spans, name, t0):
    if spans is not None:
        spans.append((name, t0, time.perf_counter()))


def _kf_rows(m) -> dict:
    """A map's keyframe rows and valid points, on the host."""
    rows = {k: getattr(m, k).cpu().numpy() for k in (
        "kf_time", "kf_valid", "kf_uv", "kf_ur", "kf_octave", "kf_desc", "kf_feat_valid")}
    rows["mp_pos"] = m.mp_pos[m.mp_valid].cpu().numpy().astype(np.float64)
    return rows


def _stack(poses: dict, n: int) -> np.ndarray:
    """Frames 0..n-1's (q, p) rows as read, (n, 7)."""
    return np.stack([poses[i] for i in range(n)]) if n else np.zeros((0, 7))


class FusedDriver:
    """FusedSlam, one session, at the configuration's chunk."""

    def __init__(self, config: dict, sessions: list, device, spans=None):
        self.cfg = slam_config(config["slam"])
        self.s = sessions[0]
        self.slam = FusedSlam(camera(config, self.s.world), self.cfg,
                              service_every=config["service_every"], chunk=config["chunk"],
                              device=device)
        self.next = 0  # next frame to feed
        self.n_read = 0  # frames whose pose is on the host
        self.called = {}  # frame -> time of its process_frame call
        self.poses = {}  # frame -> (q (4,), p (3,)) as read
        self._seen = 0  # entries of slam.outs read
        self.spans = spans
        if spans is not None:
            self._trace_program()

    def _trace_program(self):
        """Record the program's own stage laps and timers as host spans."""
        slam, spans = self.slam, self.spans
        lap, toc = slam._lap, slam._toc

        def traced_lap(stage):
            t0 = slam._lap_t
            lap(stage)
            spans.append(("step." + stage, t0, slam._lap_t))

        def traced_toc(name, t0):
            toc(name, t0)
            spans.append((name, t0, time.perf_counter()))

        slam._lap, slam._toc = traced_lap, traced_toc

    # ---- the caller's loop
    def remaining(self) -> int:
        return len(self.s.times) - self.next

    def step(self) -> list:
        """Feed one frame; return the frames whose pose reached the host
        with it: [((session, frame), seconds from its call to its pose)]."""
        i = self.next
        self.next += 1
        g, a, d = self.s.imu[i]
        t0 = time.perf_counter()
        self.called[i] = t0
        self.slam.process_frame(self.s.frames[i, 0], self.s.frames[i, 1], g, a, d,
                                float(self.s.times[i]))
        _stamp(self.spans, "process_frame", t0)
        return self._read()

    def _read(self) -> list:
        done = []
        t0 = time.perf_counter()
        for _, out in self.slam.outs[self._seen:]:
            qp = torch.cat((out.q, out.p), dim=-1).cpu().numpy().reshape(-1, 7)
            for row in qp:
                self.poses[self.n_read] = row
                done.append(self.n_read)
                self.n_read += 1
        self._seen = len(self.slam.outs)
        now = time.perf_counter()
        _stamp(self.spans, "pose_read", t0)
        return [((0, i), now - self.called.pop(i)) for i in done]

    def finish(self):
        """Dispatch what is buffered and read it (after the window)."""
        self.slam.flush()
        self._read()

    @property
    def imu_initialized(self) -> bool:
        return self.slam.imu_initialized

    # ---- what the program counts
    def counters(self) -> dict:
        slam = self.slam
        return {"timing": {k: list(v) for k, v in slam.timing.items()},
                "host_syncs": slam.host_syncs,
                "keyframes": slam.timing.get("step.kf_insert", [0.0, 0])[1]}

    # ---- what the check reads, after the window
    def outputs(self) -> dict:
        slam = self.slam
        modes = slam.modes()
        rows = _kf_rows(slam.map)
        return {"sessions": [{"poses": _stack(self.poses, self.n_read),
                              "modes": modes[:self.n_read], "rows": rows}],
                "imu_initialized": slam.imu_initialized,
                "gravity_w": slam.ts.gravity_w.cpu().numpy().astype(np.float64)}

    def close(self):
        self.slam = None


DRIVERS = {"FusedSlam": FusedDriver}
