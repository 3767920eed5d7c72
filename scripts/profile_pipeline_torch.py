"""Per-stage timing of the host-orchestrated SLAM pipeline (SlamSystem).

Port of scripts/profile_pipeline.py: the same world (SyntheticConfig(
duration=2.0, n_landmarks=1500), 752x480 at 20 Hz), the same configuration
(SlamConfig(use_imu=False, kf_max_frames=4)) and the same stages in the same
order: detect_orb on the left image, process_stereo, match_local_map and
pose_optimize against a map built by 12 frames, local_ba_step (window 8,
2048 points, 8 iterations), cull_map_points, the full process_frame over
the next 10 frames, and the round trip of a tiny dispatch.

Each stage is timed twice per call: by host wall (the time the host spends
issuing it) and device-inclusive, between CUDA events with the device
synchronized at the stage's end, so that the time includes the stage's
device work. Each stage also counts its FAST/NMS kernel launches. Last, on
the card, one more call of each stage (of the full frame: frames 22-29, two
or more of them keyframes: kf_max_frames=4) runs under torch.profiler, which sums
the device's busy time in it (the kernels' own time). On the CPU (--device
cpu) the device-inclusive time is the wall time of the call and the busy
time is not measured.

    python3 scripts/profile_pipeline_torch.py [--device cpu] [--small]

Runs on the CUDA card by default. --small runs the small test world
(384x256, 384 features, 4 levels) for a quick check; chip_smoke.py imports
`profile` and runs it at full width.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# the stage names of scripts/profile_pipeline.py, in its order
STAGES = ("detect_orb(left)", "process_stereo", "match_local_map", "pose_optimize",
          "local_ba_step(w8,p2048)", "cull_map_points", "full process_frame",
          "tiny dispatch+sync RTT")
SMALL = dict(width=384, height=256, fx=240.0, fy=240.0, n_landmarks=600)


def _timer(dev):
    """fn -> (host ms, device-inclusive ms, FAST/NMS launches) of one call."""
    import torch

    from orbslam3_tpu_torch.ops.fast_cuda import fast_nms

    on_card = dev.type == "cuda"

    def run(fn):
        if on_card:
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize(dev)
            e0.record()
        k0 = fast_nms.launches
        t0 = time.perf_counter()
        fn()
        host = (time.perf_counter() - t0) * 1e3
        launches = fast_nms.launches - k0
        if on_card:
            e1.record()
            torch.cuda.synchronize(dev)
            return host, e0.elapsed_time(e1), launches
        return host, (time.perf_counter() - t0) * 1e3, launches

    return run


def _busy_ms(fn, calls: int = 1) -> float:
    """Device busy milliseconds a call of fn (which makes `calls` calls)
    under torch.profiler: the self device time of every CUDA event."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    total = 0.0
    for e in prof.key_averages():
        if str(e.device_type).endswith("CUDA"):
            v = getattr(e, "self_device_time_total", None)
            total += v if v is not None else e.self_cuda_time_total
    return total / 1e3 / calls


def profile(device=None, small: bool = False, log=print) -> dict:
    """Run every stage; returns {stage: {"host_ms", "device_ms", "launches",
    "calls", "busy_ms"}}, each a mean over the stage's timed calls (launches
    a call; busy_ms of one profiled call, None on the CPU)."""
    import numpy as np
    import torch

    from orbslam3_tpu_torch import default_device
    from orbslam3_tpu_torch.frontend.orb import OrbConfig, detect_orb
    from orbslam3_tpu_torch.frontend.stereo import process_stereo
    from orbslam3_tpu_torch.io.synthetic import SyntheticConfig, SyntheticWorld
    from orbslam3_tpu_torch.map.slam_map import MapCapacity, cull_map_points
    from orbslam3_tpu_torch.models.local_mapper import local_ba_step
    from orbslam3_tpu_torch.models.slam import SlamConfig, SlamSystem
    from orbslam3_tpu_torch.models.tracker import match_local_map
    from orbslam3_tpu_torch.optim.pose_only import pose_optimize

    dev = default_device(device)
    world = SyntheticWorld(SyntheticConfig(**dict(dict(duration=2.0, n_landmarks=1500),
                                                  **(SMALL if small else {}))))
    slam_cfg = SlamConfig(use_imu=False, kf_max_frames=4)
    if small:
        slam_cfg = slam_cfg._replace(orb=OrbConfig(n_features=384, n_levels=4),
                                     cap=MapCapacity(max_kf=64, n_feat=384, max_mp=8192))
    slam = SlamSystem(world.cam, slam_cfg, device=dev)
    cam = slam.cam
    frames = [world.render_frame(t) for t in world.frame_times()[:30]]
    run = _timer(dev)
    out, probes = {}, []

    def timeit(name, fn, n=10):
        probes.append((name, fn))
        fn()  # warm
        cells = np.array([run(fn) for _ in range(n)])
        rec = dict(host_ms=float(cells[:, 0].mean()), device_ms=float(cells[:, 1].mean()),
                   launches=float(cells[:, 2].mean()), calls=n)
        out[name] = rec
        log(f"{name}: host {rec['host_ms']:.3f} ms, device-inclusive {rec['device_ms']:.3f} ms, "
            f"FAST/NMS launches {rec['launches']:g}/call")

    def upload(img):
        return torch.from_numpy(np.asarray(img, np.float32)).to(dev)

    z3, z0 = np.zeros((0, 3)), np.zeros(0)
    lj, rj = upload(frames[0][0]), upload(frames[0][1])
    timeit("detect_orb(left)", lambda: detect_orb(lj, slam_cfg.orb))
    timeit("process_stereo",
           lambda: process_stereo(lj, rj, cam, slam_cfg.orb, slam_cfg.stereo))

    # build some map state first
    for i in range(12):
        slam.process_frame(*frames[i], z3, z3, z0, float(i) * 0.05)

    sf = process_stereo(lj, rj, cam, slam_cfg.orb, slam_cfg.stereo)
    f = sf.feat

    def match():
        return match_local_map(slam.map, cam, f.uv, f.desc, f.octave, f.valid, slam.q, slam.p,
                               slam_cfg.track)

    timeit("match_local_map", match)
    matched, mp_w, _, _ = match()
    valid = matched >= 0
    ur = torch.where(valid, sf.u_right, torch.full_like(sf.u_right, -1.0))
    timeit("pose_optimize",
           lambda: pose_optimize(slam.q, slam.p, cam, mp_w, f.uv, ur, f.octave, valid))
    kf = torch.tensor(slam.last_kf_id, dtype=torch.int32, device=dev)
    timeit("local_ba_step(w8,p2048)",
           lambda: local_ba_step(slam.map, cam, kf, window=8, max_points=2048, iters=8)[1], n=3)
    timeit("cull_map_points", lambda: cull_map_points(slam.map), n=3)

    # the full frame, 10 frames in turn (each call reads the device itself)
    def frame(i):
        return lambda: slam.process_frame(*frames[i], z3, z3, z0, float(i) * 0.05)

    cells = [run(frame(i)) for i in range(12, 22)]
    cells = np.array(cells)
    out["full process_frame"] = dict(host_ms=float(cells[:, 0].mean()),
                                     device_ms=float(cells[:, 1].mean()),
                                     launches=float(cells[:, 2].mean()), calls=len(cells))
    r = out["full process_frame"]
    log(f"full process_frame: host {r['host_ms']:.3f} ms, device-inclusive {r['device_ms']:.3f} "
        f"ms, FAST/NMS launches {r['launches']:g}/call")

    # dispatch round trip: one tiny operation and a read back
    x = torch.ones((8, 8), device=dev)
    timeit("tiny dispatch+sync RTT", lambda: (x + 1).sum().item(), n=20)

    # last: the profiler, once attached, taxes every later launch
    probes = [(name, fn, 1) for name, fn in probes]
    probes.insert(6, ("full process_frame", lambda: [frame(i)() for i in range(22, 30)], 8))
    for name, fn, calls in probes:
        busy = _busy_ms(fn, calls) if dev.type == "cuda" else None
        out[name]["busy_ms"] = busy
        log(f"{name}: device busy " + ("not measured (CPU)" if busy is None else
                                       f"{busy:.3f} ms, {100 * busy / out[name]['device_ms']:.1f}% "
                                       f"of its device-inclusive time"))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    ap.add_argument("--small", action="store_true", help="the small test world")
    args = ap.parse_args(argv)
    profile(args.device, small=args.small)
    return 0


if __name__ == "__main__":
    sys.exit(main())
