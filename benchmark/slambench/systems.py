"""What the system drivers share. With the drivers
(benchmark/systems/<system>.py), the only code of the benchmark that
imports the program (orbslam3_tpu_torch).

A configuration's `system` names its driver file, found by name
(slambench/manifest.py::load_driver). A driver's `Driver(config, sessions,
device, trace)` builds the program's entry point from the configuration,
feeds it the traffic's frames the way a caller does (closed loop: the next
frame goes in when the previous pose is back), reads each pose to the host
as the caller would, and reports what the program counts and keeps for the
readers and the check:

* `step()`: feed one frame; the frames whose pose reached the host with it,
  [((session, frame), seconds from its call to its pose)];
* `remaining()`: frames left to feed; `imu_initialized`: a bool;
* `counters()`: a snapshot of the program's counters (numbers, [seconds,
  calls] timers, dicts of either); the harness takes the window's as the
  difference of two snapshots (slambench/harness.py::_delta);
* `spans`: None, or with `trace` a list of (name, frame, t0_ns, t1_ns) on
  time.perf_counter_ns that the program and the driver append to and the
  harness clears as the window opens;
* `finish()`: dispatch and read what is buffered, after the window;
* `outputs()`: what the check reads (slambench/check.py); `close()`.
"""
from __future__ import annotations

import numpy as np
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


def _kf_rows(m) -> dict:
    """A map's keyframe rows (poses, times, features) and valid points, on
    the host."""
    rows = {k: getattr(m, k).cpu().numpy() for k in (
        "kf_q", "kf_p", "kf_time", "kf_valid", "kf_uv", "kf_ur", "kf_octave", "kf_desc",
        "kf_feat_valid")}
    rows["mp_pos"] = m.mp_pos[m.mp_valid].cpu().numpy().astype(np.float64)
    return rows


def _stack(poses: dict, n: int) -> np.ndarray:
    """Frames 0..n-1's (q, p) rows as read, (n, 7)."""
    return np.stack([poses[i] for i in range(n)]) if n else np.zeros((0, 7))
