#!/usr/bin/env python3
"""GPU smoke run of orbslam3_tpu_torch, the PyTorch/CUDA port.

    python3 chip_smoke.py

Needs one CUDA card and the CUDA toolkit (nvcc). Imports nothing of JAX.
Phases (each raises on failure; nothing is caught):

0. the card: `nvidia-smi` name and power limit, torch's device name;
1. build the FAST/NMS kernel (csrc/fast_nms.cu) with nvcc from the
   checkout, print its build time and ptxas' registers / shared memory;
2. kernel phase: the kernel against its plain PyTorch version, bitwise, at
   the 8 pyramid-level shapes of a 752x480 frame (B=2), on random
   integer images and on the pyramid of one rendered bench-world frame;
   CUDA-event times of both;
3. slice phase: the port's main path, FusedSlam(cam, SLICE_CFG) on cuda,
   over the 8 s, 20 Hz, 752x480 bench world (bench.py::HARD_WORLD, 160
   frames). The launch counter is reset just before the run and must grow
   by exactly 8 per frame (one launch per pyramid level). Prints fps after
   8 warm-up frames, timing_report(), host syncs per frame and peak
   memory. Then the same world under each sensor-noise draw of the
   recorded JAX reference (orbslam3_tpu_torch/data/slice_reference.json);
4. a torch.profiler window over 16 frames of a second run: device time by
   kernel and the device's busy share; the second run's poses must equal
   the first run's, bit for bit;
5. accuracy against the JAX reference, draw by draw (check_accuracy).

The last two lines are the card's name and power limit and
{"ok": true, "device": {...}}; the kernels' JSON record comes before them.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
HARD_WORLD = dict(texture="textured", exposure_drift=0.3, image_noise_std=3.0,
                  salt_pepper_frac=0.002, motion_blur_samples=3, exposure_time=0.02)
DURATION = 8.0
WARMUP = 8
PROFILE_FRAMES = 16
LAUNCHES_PER_FRAME = 8  # one fast_nms launch per pyramid level (OrbConfig().n_levels)


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def device_us(e) -> float:
    """Self device time of a profiler event average, in microseconds."""
    v = getattr(e, "self_device_time_total", None)
    return v if v is not None else e.self_cuda_time_total


def cuda_ms(fn, n: int) -> float:
    """Mean device time of fn() over n calls, after 3 warm-up calls."""
    import torch

    for _ in range(3):
        fn()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(n):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / n


def build_world():
    from orbslam3_tpu_torch.io.synthetic import SyntheticConfig, SyntheticWorld

    world = SyntheticWorld(SyntheticConfig(duration=DURATION, n_landmarks=1500, **HARD_WORLD))
    times = world.frame_times()
    frames = world.render_sequence(times, workers=min(os.cpu_count() or 2, 8))
    imu = []
    for i, t in enumerate(times):
        t_prev = times[i - 1] if i > 0 else t
        imu.append(world.imu_window(t_prev, t))
    return world, times, frames, imu


def kernel_phase(frame_left, frame_right):
    import numpy as np
    import torch

    from orbslam3_tpu_torch.ops.fast_cuda import fast_nms, fast_nms_reference
    from orbslam3_tpu_torch.ops.pyramid import build_pyramid, level_shapes

    dev = torch.device("cuda")
    shapes = level_shapes(480, 752, 8, 1.2)
    rng = np.random.default_rng(0)
    max_err = 0.0
    for hw in shapes:
        x = torch.from_numpy(rng.integers(0, 256, (2,) + hw).astype(np.float32)).to(dev)
        got, want = fast_nms(x), fast_nms_reference(x)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"fast_nms != fast_nms_reference on random {hw}: max |diff| "
                                 f"{float((got - want).abs().max())}")
        max_err = max(max_err, float((got - want).abs().max()))
    pair = torch.stack([torch.from_numpy(frame_left), torch.from_numpy(frame_right)]).to(dev)
    levels = build_pyramid(pair.float(), 8, 1.2)
    rows = []
    tot_k = tot_p = 0.0
    for lv in levels:
        lv = lv.contiguous()
        got, want = fast_nms(lv), fast_nms_reference(lv)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"fast_nms != fast_nms_reference on the frame's level "
                                 f"{tuple(lv.shape)}")
        max_err = max(max_err, float((got - want).abs().max()))
        ms_k = cuda_ms(lambda: fast_nms(lv), 200)
        ms_p = cuda_ms(lambda: fast_nms_reference(lv), 20)
        tot_k += ms_k
        tot_p += ms_p
        rows.append((tuple(lv.shape), ms_k, ms_p))
    log("kernel phase: bitwise equal at all 8 level shapes (random + rendered frame)")
    log("  level (B,H,W)        kernel_ms   plain_ms")
    for shp, a, b in rows:
        log(f"  {str(shp):20s} {a:9.5f}  {b:9.5f}")
    log(f"  per frame (8 levels) {tot_k:9.5f}  {tot_p:9.5f}")
    return max_err, tot_k, tot_p


def run_slice(world, times, frames, imu, cfg, device="cuda"):
    """The main path: FusedSlam.process_frame over every frame. Returns
    (slam, frames/s after WARMUP frames, host syncs per frame)."""
    import torch

    from orbslam3_tpu_torch.models.fused import FusedSlam

    slam = FusedSlam(world.cam, cfg, device=device)
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    n = len(times)
    for i in range(n):
        if i == WARMUP:
            sync()
            slam.timing.clear()
            syncs0 = slam.host_syncs
            if device == "cuda":
                torch.cuda.reset_peak_memory_stats()
            t_start = time.perf_counter()
        g, a, d = imu[i]
        slam.process_frame(frames[i][0], frames[i][1], g, a, d, float(times[i]))
    slam.finalize()
    elapsed = time.perf_counter() - t_start
    return slam, (n - WARMUP) / elapsed, (slam.host_syncs - syncs0) / (n - WARMUP)


def accuracy(slam, gt_p, n: int) -> dict:
    """ATE, ok_frac and keyframe count of a finished run; raises unless the
    trajectory is finite and has one position per frame."""
    import numpy as np

    from orbslam3_tpu_torch.eval.metrics import ate_rmse
    from orbslam3_tpu_torch.models.fused import MODE_OK

    _, ps, _ = slam.trajectory_arrays()
    if ps.shape != (n, 3) or not np.all(np.isfinite(ps)):
        raise AssertionError(f"trajectory not finite or of shape {ps.shape}, expected ({n}, 3)")
    return dict(ate=float(ate_rmse(ps, gt_p[:n])), ok_frac=float((slam.modes() == MODE_OK).mean()),
                n_kf=int(slam.map.n_kf))


def band(ate_jax: float) -> float:
    return max(0.02, 0.5 * ate_jax)


def check_accuracy(draws):
    """The port against the JAX reference, draw by draw.

    Every draw keeps ok_frac within 0.05 of the reference's. Every
    sensor-noise draw lands within band(ATE_jax) of the reference's ATE on
    the same draw, and the median ATE over all draws within band of the
    reference's median. The noise-free draw's own ATE is reported, not
    held: there the reference sits on an exact float32 tie of the keyframe
    gate (frame 56, 133 inliers against 0.7 * 190), and a single BRIEF bit
    that float32 rounding flips on the way decides the branch (PERF.md)."""
    import numpy as np

    for d in draws:
        if d["ok_frac"] < d["jax"]["ok_frac"] - 0.05:
            raise AssertionError(f"draw {d['seed']}: ok_frac {d['ok_frac']:.4f} below the JAX "
                                 f"reference {d['jax']['ok_frac']:.4f} - 0.05")
        if d["seed"] is not None and abs(d["ate"] - d["jax"]["ate_m"]) > band(d["jax"]["ate_m"]):
            raise AssertionError(f"draw {d['seed']}: ATE {d['ate']:.4f} m outside the JAX band "
                                 f"{d['jax']['ate_m']:.4f} +- {band(d['jax']['ate_m']):.4f}")
    med = float(np.median([d["ate"] for d in draws]))
    med_jax = float(np.median([d["jax"]["ate_m"] for d in draws]))
    log(f"accuracy: median ATE over {len(draws)} draws {med:.5f} m, JAX {med_jax:.5f} m "
        f"(band +-{band(med_jax):.4f})")
    if abs(med - med_jax) > band(med_jax):
        raise AssertionError(f"median ATE {med:.4f} m outside the JAX band {med_jax:.4f} "
                             f"+- {band(med_jax):.4f}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
        import orbslam3_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke.py: the orbslam3_tpu_torch package is not next to this script ({e})",
              file=sys.stderr)
        return 2

    # the world is rendered by worker processes before CUDA is initialized
    t0 = time.perf_counter()
    world, times, frames, imu = build_world()
    log(f"world: {len(times)} frames {world.cfg.width}x{world.cfg.height} rendered in "
        f"{time.perf_counter() - t0:.1f} s")

    # ---- 0. the card
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(f"card: {card} | torch: {kind} | torch {torch.__version__} cuda {torch.version.cuda}")

    # ---- 1. build
    from orbslam3_tpu_torch.ops import fast_cuda

    info = fast_cuda.build()
    log(f"build: {info['path']} in {info['seconds']:.2f} s (cached={info['cached']})")
    for line in info.get("ptxas", "").splitlines():
        if "registers" in line or "Compiling" in line or "bytes" in line:
            log("  ptxas: " + line.strip())

    # ---- 2. kernel phase
    import numpy as np

    max_err, ms_kernel, ms_plain = kernel_phase(frames[0][0].astype(np.float32),
                                                frames[0][1].astype(np.float32))

    # ---- 3. slice phase: the main path through FusedSlam
    from orbslam3_tpu_torch.models.fused import SLICE_CFG
    from orbslam3_tpu_torch.ops.fast_cuda import fast_nms

    fast_nms.launches = 0
    slam, fps, syncs_per_frame = run_slice(world, times, frames, imu, SLICE_CFG)
    launches = fast_nms.launches
    if launches != LAUNCHES_PER_FRAME * len(times):
        raise AssertionError(f"fast_nms launched {launches} times over {len(times)} frames, "
                             f"expected {LAUNCHES_PER_FRAME} per frame")
    peak = torch.cuda.max_memory_allocated()
    gt_p, _ = world.gt_trajectory()
    with open(os.path.join(ROOT, "orbslam3_tpu_torch", "data", "slice_reference.json")) as f:
        ref = json.load(f)
    draws = [dict(seed=None, jax=ref["draws"][0], **accuracy(slam, gt_p, len(times)))]
    log(f"slice: {len(times)} frames, n_kf {int(slam.map.n_kf)} (JAX {ref['n_kf']}), "
        f"n_mp {int(slam.map.n_mp)} (JAX {ref['n_mp']})")
    log(f"slice: {fps:.3f} frames/s after {WARMUP} warm-up frames, host syncs/frame "
        f"{syncs_per_frame:.3f}, peak device memory {peak / 2**20:.1f} MiB, "
        f"fast_nms launches {launches} ({launches / len(times):.1f}/frame)  [{card}]")
    log("timing_report (host wall, ms/call): " + json.dumps(slam.timing_report()))
    # the same world under the reference's sensor-noise draws
    from orbslam3_tpu_torch.io.synthetic import perturb_frames

    for jd in ref["draws"][1:]:
        s_, fps_, _ = run_slice(world, times, perturb_frames(frames, jd["seed"]), imu, SLICE_CFG)
        draws.append(dict(seed=jd["seed"], jax=jd, **accuracy(s_, gt_p, len(times))))
        log(f"  draw seed {jd['seed']}: {fps_:.3f} frames/s")
    for d in draws:
        log(f"accuracy, draw seed {d['seed']}: ATE {d['ate']:.5f} m (JAX {d['jax']['ate_m']:.5f}), "
            f"ok_frac {d['ok_frac']:.4f} (JAX {d['jax']['ok_frac']:.4f}), n_kf {d['n_kf']} "
            f"(JAX {d['jax']['n_kf']})")

    # ---- 4. profile a steady window of a second run (device time by kernel)
    from torch.profiler import ProfilerActivity, profile

    from orbslam3_tpu_torch.models.fused import FusedSlam

    slam2 = FusedSlam(world.cam, SLICE_CFG, device="cuda")
    n0 = WARMUP + 8
    for i in range(n0):
        g, a, d = imu[i]
        slam2.process_frame(frames[i][0], frames[i][1], g, a, d, float(times[i]))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(n0, n0 + PROFILE_FRAMES):
            g, a, d = imu[i]
            slam2.process_frame(frames[i][0], frames[i][1], g, a, d, float(times[i]))
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n2 = n0 + PROFILE_FRAMES
    same = bool(np.array_equal(slam2._flat_outs()[1].p, slam._flat_outs()[1].p[:n2]))
    log(f"reproducible: a second run's first {n2} raw poses equal the first run's: {same}")
    if not same:
        raise AssertionError("two runs on the same frames gave different poses")
    events = [e for e in prof.key_averages()
              if str(e.device_type).endswith("CUDA") and device_us(e) > 0]
    dev_us = sum(device_us(e) for e in events)
    events.sort(key=device_us, reverse=True)
    log(f"profile: {PROFILE_FRAMES} frames, wall {wall * 1e3 / PROFILE_FRAMES:.2f} ms/frame, "
        f"device busy {dev_us / 1e3 / PROFILE_FRAMES:.2f} ms/frame "
        f"({100 * dev_us / 1e6 / max(wall, 1e-9):.1f}% of wall; profiler on)")
    for e in events[:12]:
        log(f"  {device_us(e) / 1e3 / PROFILE_FRAMES:8.3f} ms/frame "
            f"{e.count // PROFILE_FRAMES:6d}/frame  {e.key[:90]}")

    # ---- 5. the slice's output against the JAX reference (after the
    # profile, so a failing run still shows where its time went)
    check_accuracy(draws)

    log(json.dumps({"kernels": [{
        "name": "fast_nms", "route": "cuda", "source": "orbslam3_tpu_torch/csrc/fast_nms.cu",
        "replaces": "orbslam3_tpu/ops/fast_pallas.py:147", "launches": launches,
        "max_abs_err": max_err, "ms": ms_kernel, "plain_ms": ms_plain}]}))
    log(card)
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
