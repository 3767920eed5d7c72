"""Launches, device time and host time by stage of one cell's window, read
through the program's span hook (FusedSlam.trace_spans), on the card.

    python3 benchmark/stages.py --workload <name> --seed <n> --seconds <s>

Set-up and window as `run.py --trace 1` runs them (slambench/harness.py: the
same traffic, FusedDriver, warm-up and closed loop under the profiler), with
the program's span hook on. The last line of standard output is one JSON
object: tracked_fps (traced), host_sync_wait_ms (the program's "sync_wait"
timer), pose_row_inlier_share (the solve's inlier rows over its
`cap.n_feat` rows, from the window frames' `n_inliers`, read after the
window) and pose_solve_ms over the window; each stage's launches and device
milliseconds (slambench/launches.py), the four stage-group figures
(pose_solve_launches and pose_solve_busy_ms a window frame,
kf_branch_launches and kf_branch_busy_ms a window keyframe), host
microseconds a pose-solve launch, two checks (`launch_check`) and the
device's idle time by the innermost span it fell in. No correctness check
runs: `run.py` is the benchmark; this is a reading of where its time goes,
until FusedDriver (slambench/systems.py) takes the hook's spans itself.
"""
import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

POSE_SOLVE = ("step.pose_solve_vi", "step.pose_solve_visual", "step.ransac_seed")
# metrics/kf_branch_ms.py's stages
KF_BRANCH = ("step.kf_insert", "step.vi_ba", "step.local_ba", "step.triangulate", "step.fuse",
             "step.point_stats", "step.kf_cull", "step.mp_cull")


def stage_figures(lz, spans, frames: int, keyframes: int, timing: dict) -> dict:
    """What the profiler adds: by stage, by stage group, and two checks: of
    the assignment to the innermost span, and of the correlation itself."""
    steps = [s for s in spans if s[0] == "step" or s[0].startswith("step.")]
    own = lz.owners(steps)
    out = {"stages": {n: {"launches": c, "device_ms": 1e3 * d,
                          "host_ms": 1e3 * timing.get(n, [0.0, 0])[0],
                          "calls": timing.get(n, [0.0, 0])[1]}
                      for n, (c, d) in lz.by_name(steps).items()}}
    for key, names, per in (("pose_solve", POSE_SOLVE, frames), ("kf_branch", KF_BRANCH, keyframes)):
        n, busy = lz.work(steps, set(names), own)
        if per:
            out[f"{key}_launches"] = n / per
            out[f"{key}_busy_ms"] = 1e3 * busy / per
        if key == "pose_solve" and n:
            host_s = sum(timing.get(s, [0.0, 0])[0] for s in names)
            out["pose_solve_host_us_per_launch"] = 1e6 * host_s / n
    # innermost-span assignment: the "step." spans tile each "step" span, so
    # every launch inside a "step" span has to land in one of its stages
    in_step = int((lz.owners([s for s in steps if s[0] == "step"]) >= 0).sum())
    in_stages = sum(v["launches"] for k, v in out["stages"].items() if k != "step")
    # correlation: every host call that launches, copies or sets found its
    # device work by id (launches == launch_calls), and the window's device
    # activities that found no launch are those launched before it
    out["launch_check"] = {"in_step_spans": in_step, "in_stage_spans": in_stages,
                           "launches": len(lz.at), "launch_calls": lz.calls,
                           "activities": len(lz.dev_of),
                           "activities_unmatched": int((lz.dev_of < 0).sum())}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    cache = os.path.join(HERE, ".cache")
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(cache, "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(cache, "triton"))
    sys.path[:0] = [HERE, ROOT]

    import torch

    from slambench import manifest, stats, traffic
    from slambench.harness import _delta, _warmup, log
    from slambench.launches import Launches
    from slambench.systems import FusedDriver
    from slambench.trace import Trace

    if not torch.cuda.is_available():
        log("no result: no CUDA device")
        return 3
    res = manifest.resolve(manifest.load(), args.workload)
    config, traf = res["config"], res["traffic"]
    sessions = traffic.build(config, traf, args.seed, traffic.CACHE_DIR, 0, log=log)
    dev = torch.device("cuda")
    driver = FusedDriver(config, sessions, dev)
    read = []
    _warmup(driver, traf["warmup"], read)
    torch.cuda.synchronize(dev)
    host_spans = []  # FusedDriver's own spans: process_frame, pose_read
    driver.spans = host_spans
    slam = driver.slam
    slam.trace_spans(True)
    c0 = driver.counters()
    window = []
    with Trace(True) as tr:
        tw0 = tw1 = time.perf_counter()
        while driver.remaining() > 0:
            done = driver.step()
            if done:
                tw1 = time.perf_counter()
                window.extend(f for (_, f), _ in done)
                if tw1 - tw0 >= args.seconds:
                    break
    c = _delta(c0, driver.counters())
    timing, frames, kfs = c["timing"], len(window), c["keyframes"]
    out = {"workload": args.workload, "seed": args.seed, "device": torch.cuda.get_device_name(dev),
           "frames": frames, "keyframes": kfs, "window_s": tw1 - tw0,
           "tracked_fps": stats.rate(frames, tw1 - tw0)}
    if frames:
        n_inl = slam.frame_outputs().n_inliers[window]
        out["host_sync_wait_ms"] = 1e3 * timing["sync_wait"][0] / frames
        out["pose_row_inlier_share"] = 100.0 * float(n_inl.sum()) / (
            frames * config["slam"]["cap"]["n_feat"])
        out["pose_solve_ms"] = 1e3 * sum(timing.get(n, [0.0, 0])[0] for n in POSE_SOLVE) / frames
    lz = Launches.from_trace(tr) if frames else None
    if lz is not None:
        spans = list(slam.spans)
        out.update(stage_figures(lz, spans, frames, kfs, timing))
        out["busy_s"] = tr.busy_s()
        out["idle_gaps"] = tr.idle_by_host(
            [(n, a * 1e-9, b * 1e-9) for n, _, a, b in spans] + host_spans, n=16)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
