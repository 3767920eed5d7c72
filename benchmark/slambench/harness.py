"""One run of one cell: set-up, the measured window, the readers, the check.

The run, in order:

1. set-up: the traffic's sessions (rendered once per checkout, then the
   seed's noise draws), the program's entry point (built by the driver
   that the configuration's `system` names, benchmark/systems/<system>.py),
   and the warm-up the traffic names, which drives every shape the window
   uses;
2. the window: frames fed closed loop for `seconds`, ending at the first
   completed frame after it; with --trace 1 under torch.profiler;
3. the end-to-end metrics (host clock, allocator peak) or the per-layer
   readers (benchmark/metrics/<name>.py) on a `WindowRecord`;
4. after the window and the peak's reading: the frames still buffered are
   dispatched, the program's outputs copied to the host and its state
   freed, and the check (slambench/check.py) decides `correct`.
"""
from __future__ import annotations

import gc
import sys
import time
from dataclasses import dataclass

import torch

from slambench import check, faults, manifest, stats, traffic
from slambench.launches import Launches, launch_check, step_spans
from slambench.roofline import peaks
from slambench.trace import Trace


def log(msg: str):
    print(msg, file=sys.stderr, flush=True)


@dataclass
class WindowRecord:
    """What a per-layer reader reads: the window's length and frames, each
    window frame's latency, the program's counters over the window
    (differences of two snapshots), the trace and the spans the program and
    the driver recorded in the window (None without --trace 1) and the run's
    configuration."""

    cell: str
    config: dict
    frames: int
    keyframes: int
    window_s: float
    counters: dict
    latencies: list | None = None  # seconds from each frame's call to its pose on the host
    trace: Trace | None = None
    device_kind: str = ""
    spans: list | None = None  # (name, frame, t0_ns, t1_ns) on time.perf_counter_ns
    launches: Launches | None = None  # the trace's, by correlation id (slambench/launches.py)
    _steps: tuple | None = None

    def stage_s(self, *stages) -> float:
        """Host seconds of the program's timers (FusedSlam.timing) named."""
        t = self.counters.get("timing", {})
        return sum(t.get(s, [0.0, 0])[0] for s in stages)

    def peaks(self) -> dict | None:
        return peaks(self.device_kind)

    def step_attribution(self):
        """(the "step" spans and their parts, the innermost of them that
        each launch lies in, the launch check), computed once; None without
        launches or spans."""
        if self.launches is None or self.spans is None:
            return None
        if self._steps is None:
            steps = step_spans(self.spans)
            own = self.launches.owners(steps)
            self._steps = (steps, own, launch_check(self.launches, steps, own))
        return self._steps

    def stage_work(self, *stages):
        """(launches, device seconds) of the launches whose innermost "step"
        span or part is one of `stages` (slambench/launches.py::work); None
        where there is nothing to read. The launch check is the log's."""
        att = self.step_attribution()
        if att is None:
            return None
        steps, own, _ = att
        return self.launches.work(steps, set(stages), own)


def _delta(a, b):
    """b - a for two snapshots of a driver's counters: numbers, [seconds,
    calls] timers and dicts of either, member by member; what `a` lacks
    counts from zero."""
    if isinstance(b, dict):
        a = a or {}
        return {k: _delta(a.get(k), v) for k, v in b.items()}
    if isinstance(b, list):
        return [y - x for x, y in zip(a or [0] * len(b), b)]
    return b - (a or 0)


def _warmup(driver, spec: dict, read: list):
    """Feed frames until the traffic's warm-up holds."""
    if "frames" in spec:
        while len(read) < spec["frames"]:
            read.extend(driver.step())
    elif spec.get("until") == "imu_initialized":
        while not driver.imu_initialized and len(read) < spec["max_frames"]:
            read.extend(driver.step())
        if not driver.imu_initialized:
            log(f"set-up: the IMU did not initialize within {spec['max_frames']} frames")
        else:
            log(f"set-up: the IMU initialized by frame {len(read)}")
        n = max(len(read) + spec.get("then_frames", 0), spec.get("min_frames", 0))
        while len(read) < n:
            read.extend(driver.step())
    else:
        raise ValueError(f"unknown warm-up {spec}")


def run_cell(cell: str, seed: int, seconds: float, trace: bool, *, resolved=None,
             device=None, cache_dir=traffic.CACHE_DIR, workers=0, control=None,
             fault=None, t_start=None) -> dict:
    """The result line of one run, as a dict. `control` and `fault` (a name
    of slambench/faults.py) are for reading the check, never measured."""
    disarm = []
    try:
        return _run_cell(cell, seed, seconds, trace, resolved, device, cache_dir, workers,
                         control, fault, t_start, disarm)
    finally:
        for undo in disarm:
            undo()


def _run_cell(cell, seed, seconds, trace, resolved, device, cache_dir, workers, control, fault,
              t_start, disarm) -> dict:
    t_start = time.perf_counter() if t_start is None else t_start
    res = resolved if resolved is not None else manifest.resolve(manifest.load(), cell)
    config, traf, limits = res["config"], res["traffic"], res["cell"]["limits"]
    dev = torch.device(device or "cuda")
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats(dev)

    def plant(stage):
        if fault is not None and faults.when(fault) == stage:
            disarm.append(faults.arm(fault))
            log(f"fault {fault} planted at the {stage}")

    sessions = traffic.build(config, traf, seed, cache_dir, workers, log=log)
    plant("start")
    driver = manifest.load_driver(config["system"])(config, sessions, dev, trace)
    spans = driver.spans
    if control == "tf32":
        # the lower-precision control: every float32 matrix product in TF32
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.set_float32_matmul_precision("high")
    read = []
    _warmup(driver, traf["warmup"], read)
    if cuda:
        torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - t_start
    log(f"set-up {setup_s:.3f} s, {len(read)} frames")
    if spans is not None:
        spans.clear()

    plant("window")
    c0 = driver.counters()
    window, lat = [], []
    with Trace(trace, cuda) as tr:
        tw0 = time.perf_counter()
        tw1 = tw0
        while True:
            if driver.remaining() <= 0:
                log("window: the sequence ended before the window did")
                break
            done = driver.step()
            if done:
                tw1 = time.perf_counter()
                window.extend(k for k, _ in done)
                lat.extend(x for _, x in done)
                if tw1 - tw0 >= seconds:
                    break
    c1 = driver.counters()
    window_spans = list(spans) if spans is not None else None
    window_s = tw1 - tw0
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    kind = torch.cuda.get_device_name(dev) if cuda else str(dev)

    metrics = {}
    man_metrics = res.get("metrics")
    if man_metrics is None:
        man_metrics = manifest.cell_metrics(manifest.load(), cell, trace)
    e2e = {"tracked_fps": lambda: stats.rate(len(window), window_s),
           "frame_latency_p90_ms": lambda: 1e3 * stats.percentile(lat, 90),
           "peak_device_mib": lambda: peak / 2**20, "setup_s": lambda: setup_s}
    rec = WindowRecord(cell=cell, config=config, frames=len(window),
                       keyframes=c1.get("keyframes", 0) - c0.get("keyframes", 0),
                       window_s=window_s, counters=_delta(c0, c1), latencies=lat,
                       trace=tr if trace else None,
                       device_kind=kind, spans=window_spans,
                       launches=Launches.from_trace(tr) if trace else None)
    for m in man_metrics:
        if trace:
            v = manifest.load_reader(m["name"])(rec)
        else:
            v = e2e[m["name"]]() if lat else None
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    log(f"window {window_s:.3f} s, {len(window)} frames"
        + (f", {stats.rate(len(window), window_s)!r} frames/s, p90 "
           f"{1e3 * stats.percentile(lat, 90)!r} ms" if lat else ""))
    log("window latencies ms: " + " ".join(f"{1e3 * x:.1f}" for x in lat))
    stages = rec.counters.get("timing", {})
    if stages:
        log("window stages s/calls: " + ", ".join(
            f"{k} {v[0]:.3f}/{v[1]}" for k, v in sorted(stages.items()) if v[1]))
    if "loop" in rec.counters:
        log(f"window loop closer: {rec.counters['loop']}")
    if rec.step_attribution() is not None:
        log(f"window launch check: {rec.step_attribution()[2]}")

    # after the window: answers still buffered, and the IMU's initialization
    # where the window closed before it (an answer late, not missing)
    end_frame = [max([f for s, f in window if s == q], default=-1) + 1
                 for q in range(len(sessions))]
    for _ in range(traf.get("finish_imu_init", 0)):
        if driver.imu_initialized or driver.remaining() <= 0:
            break
        driver.step()
    driver.finish()
    outs = driver.outputs()
    driver.close()
    del driver
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    ok, checks = check.evaluate(config, traf, limits, sessions, outs, set(window), end_frame,
                                seed, dev)
    modes_bad = sum(int(o["modes"][f] != 1) for s, o in enumerate(outs["sessions"])
                    for (q, f) in window if q == s)

    result = {"correct": ok, "attempted": len(window), "failed": modes_bad, "metrics": metrics,
              "device": {"platform": "gpu" if cuda else dev.type, "kind": kind,
                         "count": 1 if cuda else 0, "memory_peak_bytes": int(peak)}}
    if trace:
        result["device"]["busy_s"] = tr.busy_s()
        result["device"]["window_s"] = tr.window_s
        result["breakdown"] = {"device_ops": tr.top_ops(), "idle_gaps": tr.idle_by_host(
            [(n, 1e-9 * a, 1e-9 * b) for n, _, a, b in window_spans or []])}
    result["checks"] = checks
    return result
