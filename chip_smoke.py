#!/usr/bin/env python3
"""GPU smoke run of orbslam3_tpu_torch, the PyTorch/CUDA port.

    python3 chip_smoke.py

Needs one CUDA card and the CUDA toolkit (nvcc). Imports nothing of JAX.
Phases (each raises on failure; nothing is caught):

0. the card: `nvidia-smi` name and power limit, torch's device name;
1. build the FAST/NMS kernel (csrc/fast_nms.cu) with nvcc from the
   checkout, print its build time and ptxas' registers / shared memory;
2. kernel phase: the kernel against its plain PyTorch version, bitwise: the
   8 pyramid levels of a 752x480 frame (B=2) in one launch
   (fast_nms_levels), on random integer images and on the pyramid of one
   rendered bench-world frame, and one-level calls at each of the 8 shapes
   (fast_nms with B=2, fast_nms_single with B=1). Times on the rendered
   pyramid: CUDA events around 200 one-launch calls, the same calls
   replayed from a CUDA graph (no host in the way), with the L2 cache
   flushed before each call, the plain version, and 8 one-level launches
   (the call pattern before the levels were fused). The bound is computed
   from this pyramid's bytes and from the operations its corners need. Then
   the same at B=16, the 16 images of a chunk of 8 stereo frames in one
   launch, and the batched front end of that chunk against 8 one-frame
   calls, field by field;
3. stereo path: FusedSlam(cam, SLICE_CFG) on cuda over the 8 s, 20 Hz,
   752x480 bench world (bench.py::HARD_WORLD, 160 frames), noise-free and
   under sensor-noise draw 1 of the recorded JAX reference
   (orbslam3_tpu_torch/data/slice_reference.json), one run after the other.
   The launch counter is set to 0 just before the noise-free run and must
   have grown by exactly 1 per frame (one launch for all pyramid levels)
   just after it;
4. stereo-inertial path, the main path: FusedSlam(cam, BENCH_CFG), built
   with no `device` argument (so it must pick the card itself), over the
   same world with its IMU windows. Launch counter as in 3. Raises unless
   the IMU is initialized at the end and the trajectory is finite with one
   pose a frame. Prints frames/s after 8 warm-up frames, timing_report()
   and from it the step's host time by stage (front end, matching, RANSAC
   seed, visual and visual-inertial pose solve, flag read, keyframe insert,
   BA and VI-BA, triangulation, fusion, point statistics, culling), host
   syncs per frame, peak device memory, the frame at which the IMU
   initialized, gravity and biases, map sizes and keyframes culled. Then
   the same frames at chunk=8, service_every=8 (bench.py's dispatch): one
   FAST/NMS launch a chunk (20 over 160 frames), the IMU initialized after
   frame 63, raw poses held to the chunk=1 run's (1 mm; whether they are
   equal bit for bit is printed), frames/s and the stage table beside
   chunk=1's. Then compact_map on the run's final map at the full capacity
   shapes, on the card against the CPU (exact) with its invariants and
   its time;
5. the sensor-noise draw 1 of the stereo-inertial path
   (orbslam3_tpu_torch/data/vi_reference.json); a long session on draw 1:
   104 frames with a map of 16 keyframe rows, so that compaction and the
   keyframe pressure evictions fire by themselves, held to the JAX
   reference of the same configuration
   (orbslam3_tpu_torch/data/session_reference.json); the leaves of loop
   closing on the card against the CPU at real sizes (a k=10, 4-level
   vocabulary trained from the run's keyframe descriptors, sparse BoW
   vectors and scores, Sim3 RANSAC by reprojection at 256 hypotheses, the
   pose graph at K=256); then a second full run on the noise-free frames,
   alone on the card, stopped after frame 71, saved (save_map), loaded on
   the card (load_map) and resumed in a new system (FusedSlam.from_state).
   Its raw poses must equal the first run's bit for bit up to the
   checkpoint and stay within 1 mm of it after (bit-equality is printed),
   with no second IMU initialization; a torch.profiler window over the last
   16 frames of the resumed part (visual-inertial pose solves and at least two
   VI-BA keyframes) gives device time by kernel, the FAST/NMS kernel's own
   time and launches per frame, and the device's busy share, of the
   window's wall time and of the first run's untraced step. The profiled
   run comes last: once the profiler has attached to the CUDA runtime every
   later launch of the process costs more host time;
6. accuracy of all paths against their JAX references, draw by draw
   (check_accuracy).

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
NOISE_SEEDS = (1,)  # the sensor-noise draw that runs here (the references hold 1 and 2)
CHUNK = 8  # bench.py's frames per dispatch
SAVE_AT = 72  # the second run is saved after frame 71 and resumed from frame 72
SESSION_FRAMES, SESSION_MAX_KF, SESSION_SEED = 104, 16, 1  # scripts/make_session_reference.py
LAUNCHES_PER_FRAME = 1  # one fast_nms_levels launch for the whole pyramid
KERNEL_NAME = "fast_nms_kernel"
# NVIDIA H100 SXM data sheet: HBM3 bytes/s, float32 FLOP/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12


T0 = time.perf_counter()


def log(*a):
    print(*a, flush=True)


def phase(name: str):
    """Mark a phase with the seconds since the script started."""
    log(f"[{time.perf_counter() - T0:7.1f} s] {name}")


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


def build_world(frames=None):
    """The bench world, its frame times, rendered stereo frames (rendered
    here unless given) and the IMU window of every frame."""
    from orbslam3_tpu_torch.io.synthetic import SyntheticConfig, SyntheticWorld

    world = SyntheticWorld(SyntheticConfig(duration=DURATION, n_landmarks=1500, **HARD_WORLD))
    times = world.frame_times()
    if frames is None:
        frames = world.render_sequence(times, workers=min(os.cpu_count() or 2, 8))
    imu = []
    for i, t in enumerate(times):
        t_prev = times[i - 1] if i > 0 else t
        imu.append(world.imu_window(t_prev, t))
    return world, times, frames, imu


def kernel_device_us(prof, n_calls: int):
    """(device microseconds, launches) per call of the FAST/NMS kernel in a
    profiler window of n_calls; raises if the profiler saw no such kernel."""
    evs = [e for e in prof.key_averages()
           if KERNEL_NAME in e.key and str(e.device_type).endswith("CUDA") and device_us(e) > 0]
    if not evs:
        raise AssertionError(f"the profiler saw no kernel named *{KERNEL_NAME}*")
    return sum(device_us(e) for e in evs) / n_calls, sum(e.count for e in evs) / n_calls


def kernel_bound(levels, thr_hi=20.0, thr_lo=7.0) -> dict:
    """The least time the card could take for this pyramid, in ms.

    Bytes: every pixel read once and written once, over the HBM rate.
    Operations, as this data needs them: at every pixel 16 ring differences,
    32 compares at the smaller threshold, 8 maxima of the NMS, one multiply
    and one maximum to combine; at every pixel with a run of 9 at the smaller
    threshold, 32 compares at the larger one and 4 SADs of 16 x (sub, max,
    add). `dense_ops_ms` counts the SADs and compares at every pixel, as the
    plain version computes them."""
    from orbslam3_tpu_torch.ops.fast import fast_score

    pixels = sum(lv.numel() for lv in levels)
    corners = sum(int((fast_score(lv, min(thr_hi, thr_lo)) > 0).sum()) for lv in levels)
    ops = pixels * (16 + 32 + 8 + 2) + corners * (32 + 4 * 16 * 3)
    dense = pixels * (16 + 2 * (32 + 2 * 16 * 3) + 8 + 2)
    bytes_ms = 2 * 4 * pixels / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / F32_FLOP_PER_S * 1e3
    return dict(pixels=pixels, corners=corners, bytes_ms=bytes_ms, ops_ms=ops_ms,
                dense_ops_ms=dense / F32_FLOP_PER_S * 1e3, bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations")


def kernel_phase(frame_left, frame_right) -> dict:
    import numpy as np
    import torch

    from orbslam3_tpu_torch.ops.fast_cuda import (fast_nms, fast_nms_levels,
                                                  fast_nms_reference, fast_nms_single)
    from orbslam3_tpu_torch.ops.pyramid import build_pyramid, level_shapes

    dev = torch.device("cuda")
    shapes = level_shapes(480, 752, 8, 1.2)
    max_err = 0.0

    def hold(got, want, what):
        nonlocal max_err
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"{what} {tuple(want.shape)} != fast_nms_reference: max |diff| "
                                 f"{float((got - want).abs().max())}")
        max_err = max(max_err, float((got - want).abs().max()))

    def hold_levels(levels, what):
        n0 = fast_nms.launches
        outs = fast_nms_levels(levels)
        if fast_nms.launches != n0 + 1:
            raise AssertionError(f"fast_nms_levels made {fast_nms.launches - n0} launches, not 1")
        for got, lv in zip(outs, levels):
            hold(got, fast_nms_reference(lv), f"fast_nms_levels on {what}, level")

    rng = np.random.default_rng(0)
    rand = [torch.from_numpy(rng.integers(0, 256, (2,) + hw).astype(np.float32)).to(dev)
            for hw in shapes]
    hold_levels(rand, "random images")
    for x in rand:  # the one-level entry points, B=2 and B=1
        want = fast_nms_reference(x)
        hold(fast_nms(x), want, "fast_nms on a random stack")
        hold(fast_nms_single(x[1]), want[1], "fast_nms_single on a random image")
    pair = torch.stack([torch.from_numpy(frame_left), torch.from_numpy(frame_right)]).to(dev)
    levels = [lv.contiguous() for lv in build_pyramid(pair.float(), 8, 1.2)]
    if [tuple(lv.shape[1:]) for lv in levels] != [tuple(hw) for hw in shapes]:
        raise AssertionError("the rendered frame's pyramid has other shapes than level_shapes")
    hold_levels(levels, "the rendered frame")
    log("kernel phase: bitwise equal at all 8 level shapes: one launch for the pyramid "
        "(random + rendered frame), one-level calls with B=2 and B=1")

    # ---- times, all on the rendered frame's pyramid
    ms_call = cuda_ms(lambda: fast_nms_levels(levels), 200)
    ms_per_level = cuda_ms(lambda: [fast_nms(lv) for lv in levels], 200)
    ms_plain = sum(cuda_ms(lambda lv=lv: fast_nms_reference(lv), 20) for lv in levels)
    # the same call replayed from a CUDA graph: launches back to back, no host between them
    reps = 20
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fast_nms_levels(levels)
    ms_graph = cuda_ms(graph.replay, 20) / reps
    # with the L2 cache flushed before each call (the pyramid, 17.9 MB in and out, fits in
    # it). Four 256 MB fills keep the card busy while the host enqueues the call, so the
    # events see the kernel and not the wrapper.
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device=dev)
    cold = []
    for _ in range(20):
        for _ in range(4):
            flush.zero_()
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0.record()
        fast_nms_levels(levels)
        t1.record()
        torch.cuda.synchronize()
        cold.append(t0.elapsed_time(t1))
    del flush
    ms_cold = float(np.median(cold))
    bound = kernel_bound(levels)
    log(f"  pyramid: {bound['pixels']} pixels, {bound['corners']} with a run of 9 at the low "
        f"threshold ({100 * bound['corners'] / bound['pixels']:.2f}%)")
    log(f"  one launch, 200 eager calls (CUDA events)      {ms_call:9.5f} ms/frame")
    log(f"  one launch, replayed from a CUDA graph         {ms_graph:9.5f} ms/frame")
    log(f"  one launch, L2 flushed before it (median of 20) {ms_cold:8.5f} ms/frame")
    log(f"  8 one-level launches (CUDA events)             {ms_per_level:9.5f} ms/frame")
    log(f"  plain PyTorch version, 8 levels                {ms_plain:9.5f} ms/frame")
    log(f"  bound: bytes {bound['bytes_ms']:.5f} ms, operations this data needs "
        f"{bound['ops_ms']:.5f} ms (computed at every pixel: {bound['dense_ops_ms']:.5f} ms) "
        f"-> {bound['bound_ms']:.5f} ms by {bound['bound_by']}")
    return dict(max_abs_err=max_err, ms=ms_call, graph_ms=ms_graph, cold_ms=ms_cold,
                earlier_ms=ms_per_level, plain_ms=ms_plain,
                bound_ms=bound["bound_ms"], bound_by=bound["bound_by"],
                bound_bytes_ms=bound["bytes_ms"], bound_ops_ms=bound["ops_ms"])


def kernel_phase_chunk(frames, cam) -> dict:
    """The kernel at B = 16: the 8 pyramid levels of the 16 images of a
    chunk of CHUNK stereo frames in one launch, bitwise against the plain
    version, timed by CUDA events and CUDA-graph replay beside the plain
    version and the bound of its pixels. Then the batched front end of the
    chunk against CHUNK one-frame calls, field by field (printed; the
    chunk=8 run holds what follows from it)."""
    import numpy as np
    import torch

    from orbslam3_tpu_torch.models.fused import BENCH_CFG, _frontend, _frontend_chunk, _frontend_frame
    from orbslam3_tpu_torch.ops.fast_cuda import (fast_nms, fast_nms_levels, fast_nms_reference,
                                                  level_table)
    from orbslam3_tpu_torch.ops.pyramid import build_pyramid

    dev = torch.device("cuda")
    lefts = torch.from_numpy(np.stack([f[0] for f in frames[:CHUNK]])).to(dev)
    rights = torch.from_numpy(np.stack([f[1] for f in frames[:CHUNK]])).to(dev)
    imgs = torch.stack([lefts, rights], dim=1).flatten(0, 1).float()
    levels = [lv.contiguous() for lv in build_pyramid(imgs, 8, 1.2)]
    B = imgs.shape[0]
    blocks = level_table(tuple(tuple(lv.shape[1:]) for lv in levels), B)[1]
    n0 = fast_nms.launches
    outs = fast_nms_levels(levels)
    torch.cuda.synchronize()
    if fast_nms.launches != n0 + 1:
        raise AssertionError(f"fast_nms_levels at B={B} made {fast_nms.launches - n0} launches")
    max_err = 0.0
    for got, lv in zip(outs, levels):
        want = fast_nms_reference(lv)
        if not torch.equal(got, want):
            raise AssertionError(f"fast_nms_levels at B={B}, level {tuple(lv.shape)} != "
                                 f"fast_nms_reference: max |diff| {float((got - want).abs().max())}")
        max_err = max(max_err, float((got - want).abs().max()))
    ms_call = cuda_ms(lambda: fast_nms_levels(levels), 100)
    ms_plain = sum(cuda_ms(lambda lv=lv: fast_nms_reference(lv), 5) for lv in levels)
    reps = 10
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fast_nms_levels(levels)
    ms_graph = cuda_ms(graph.replay, 20) / reps
    bound = kernel_bound(levels)
    log(f"kernel at B={B} ({CHUNK} stereo frames, {blocks} blocks, {bound['pixels']} pixels): "
        f"bitwise equal at all 8 levels in one launch; {ms_call:.5f} ms/chunk by CUDA events "
        f"around 100 eager calls, {ms_graph:.5f} ms/chunk replayed from a CUDA graph "
        f"({ms_graph / CHUNK:.5f} ms/frame), plain version {ms_plain:.3f} ms/chunk, bound "
        f"{bound['bound_ms']:.5f} ms/chunk by {bound['bound_by']} (bytes {bound['bytes_ms']:.5f}, "
        f"operations {bound['ops_ms']:.5f})")

    fe = _frontend_chunk(lefts, rights, cam, BENCH_CFG)
    differ = {}
    for i in range(CHUNK):
        one = _frontend(lefts[i], rights[i], cam, BENCH_CFG)
        got = _frontend_frame(fe, i)
        fields = ([(f, getattr(got[0], f), getattr(one[0], f)) for f in got[0]._fields]
                  + [(nm, got[k], one[k]) for k, nm in ((1, "u_r"), (2, "depth"), (3, "has_depth"),
                                                        (4, "points_body"))])
        for name, x, y in fields:
            if not torch.equal(x, y):
                differ[name] = max(differ.get(name, 0.0), float((x.float() - y.float()).abs().max()))
    log(f"front end of a chunk of {CHUNK} frames against {CHUNK} one-frame calls: "
        + ("every field equal bit for bit" if not differ else
           "fields that differ (largest difference): " + json.dumps(differ)))
    return dict(B=B, blocks=blocks, max_abs_err=max_err, ms=ms_call, graph_ms=ms_graph,
                plain_ms=ms_plain, bound_ms=bound["bound_ms"], bound_by=bound["bound_by"],
                frontend_fields_that_differ=sorted(differ))


def chunk_run(world, times, frames, imu, first, first_fps, card):
    """The main path's frames at chunk=CHUNK, service_every=8: one launch a
    chunk, the IMU initialized at the chunk=1 run's frame, raw poses within
    1 mm of the chunk=1 run `first` (equality bit for bit is printed)."""
    import numpy as np

    from orbslam3_tpu_torch.models.fused import BENCH_CFG

    n = len(times)
    (slam, fps, syncs, _), launches = counted_run("stereo-inertial, chunk=8", world, times, frames,
                                                  imu, BENCH_CFG, chunk=CHUNK)
    a, b = slam.frame_outputs(), first.frame_outputs()
    same = bool(np.array_equal(a.p, b.p) and np.array_equal(a.q, b.q))
    d = np.linalg.norm(a.p - b.p, axis=1)
    moved = np.flatnonzero((a.p != b.p).any(axis=1) | (a.q != b.q).any(axis=1))
    log(f"chunk={CHUNK}: {n} frames in {len(slam.outs)} dispatches, fast_nms launches {launches} "
        f"({launches / len(slam.outs):g} a chunk), IMU initialized at frame {slam.imu_init_frame} "
        f"(chunk=1: {first.imu_init_frame}), raw poses equal chunk=1's bit for bit: {same}"
        + ("" if same else f" (first frame that differs {moved[0]}, largest position difference "
                           f"{d.max():.3e} m at frame {int(d.argmax())})"))
    log(f"chunk={CHUNK}: {fps:.3f} frames/s after {WARMUP} warm-up frames (chunk=1 in this "
        f"process: {first_fps:.3f}), host syncs/frame {syncs:.3f}, n_kf {int(slam.map.n_kf)} "
        f"(chunk=1: {int(first.map.n_kf)})  [{card}]")
    log(f"chunk={CHUNK} timing_report (host wall, ms/call): " + json.dumps(slam.timing_report()))
    stage_table(f"stereo-inertial, chunk={CHUNK}", slam.timing_report(), card)
    if launches != n // CHUNK or len(slam.outs) != n // CHUNK:
        raise AssertionError(f"chunk={CHUNK}: {launches} launches in {len(slam.outs)} dispatches "
                             f"over {n} frames")
    if slam.imu_init_frame != first.imu_init_frame or not slam.imu_initialized:
        raise AssertionError(f"chunk={CHUNK}: IMU initialized at frame {slam.imu_init_frame}, "
                             f"chunk=1 at {first.imu_init_frame}")
    if not d.max() <= 1e-3:
        raise AssertionError(f"chunk={CHUNK}: raw poses leave chunk=1's by {d.max()} m (> 1 mm)")
    return launches, fps


def compaction_check(slam, card):
    """compact_map on a finished run's map, at the full capacity shapes:
    the card's result against the same function on a CPU copy (every leaf
    exact), its invariants, and its device time."""
    import torch

    from orbslam3_tpu_torch.interop import to_device
    from orbslam3_tpu_torch.map.compaction import compact_map
    from orbslam3_tpu_torch.map.slam_map import empty_map

    def leaves(tree):
        for name, x in zip(tree._fields, tree):
            if isinstance(x, tuple):
                yield from ((f"{name}.{n}", y) for n, y in leaves(x))
            else:
                yield name, x

    st = slam.map
    got, kf_map, mp_map = compact_map(st)
    want, kf_map_c, mp_map_c = compact_map(to_device(st, "cpu"))
    torch.cuda.synchronize()
    bad = [n for (n, x), (_, y) in zip(leaves(got), leaves(want)) if not torch.equal(x.cpu(), y)]
    bad += [n for n, x, y in (("kf_map", kf_map, kf_map_c), ("mp_map", mp_map, mp_map_c))
            if not torch.equal(x.cpu(), y)]
    if bad:
        raise AssertionError(f"compact_map on the card differs from the CPU in {bad}")
    n_kf, n_mp = int(got.n_kf), int(got.n_mp)
    K, M = got.kf_valid.shape[0], got.mp_valid.shape[0]
    if (n_kf, n_mp) != (int(st.kf_valid.sum()), int(st.mp_valid.sum())):
        raise AssertionError("compact_map: n_kf / n_mp are not the live counts")
    fresh = empty_map(slam.cfg.cap, device=st.kf_q.device)
    for name in ("kf_valid", "kf_map_id", "kf_prev", "kf_inliers", "kf_mp", "kf_feat_valid",
                 "mp_valid", "mp_map_id", "mp_first_kf", "mp_visible", "mp_found", "mp_obs_kf",
                 "mp_obs_feat", "mp_obs_n"):
        n = n_kf if name.startswith("kf_") else n_mp
        if not torch.equal(getattr(got, name)[n:], getattr(fresh, name)[n:]):
            raise AssertionError(f"compact_map: rows [{n}:] of {name} are not pristine")
    if bool(got.covis[n_kf:].any()) or bool(got.covis[:, n_kf:].any()):
        raise AssertionError("compact_map: covisibility outside the live rows")
    for name, hi in (("kf_mp", n_mp), ("mp_obs_kf", n_kf), ("kf_prev", n_kf), ("mp_first_kf", n_kf)):
        ids = getattr(got, name)
        if int(ids.min()) < -1 or int(ids.max()) >= hi:
            raise AssertionError(f"compact_map: {name} out of range [-1, {hi})")
    if not (bool(got.kf_valid[:n_kf].all()) and bool(got.mp_valid[:n_mp].all())):
        raise AssertionError("compact_map: a dead row among the live ones")
    ms = cuda_ms(lambda: compact_map(st), 20)
    t0 = time.perf_counter()
    for _ in range(20):
        compact_map(st)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / 20 * 1e3
    log(f"compact_map at K={K}, M={M}: {int(st.n_kf)} -> {n_kf} keyframe rows, {int(st.n_mp)} -> "
        f"{n_mp} point rows, every leaf equal to the CPU's, invariants hold; {ms:.3f} ms a pass "
        f"by CUDA events, {wall:.3f} ms of wall  [{card}]")


def session_run(world, times, frames, imu, gt_p, card) -> dict:
    """The long session: SESSION_FRAMES frames of noise draw SESSION_SEED
    with a map of SESSION_MAX_KF keyframe rows. Compaction and the pressure
    evictions must fire by themselves through the host services, no
    exception, and the corrected trajectory (through the remaps) finite."""
    import numpy as np

    from orbslam3_tpu_torch.eval.metrics import ate_rmse
    from orbslam3_tpu_torch.map.slam_map import MapCapacity
    from orbslam3_tpu_torch.models.fused import BENCH_CFG

    cfg = BENCH_CFG._replace(cap=MapCapacity()._replace(max_kf=SESSION_MAX_KF))
    n = SESSION_FRAMES
    (slam, fps, syncs, _), _ = counted_run("session", world, times[:n], noisy(frames, SESSION_SEED)[:n],
                                           imu[:n], cfg)
    rec = accuracy(slam, gt_p, n)
    _, raw, _ = slam.trajectory_arrays(corrected=False)
    rec.update(ate_raw=float(ate_rmse(raw, gt_p[:n])), compactions=slam.compactions,
               kf_evictions=slam.kf_evictions, mp_evictions=slam.mp_evictions,
               map_evictions=slam.map_evictions)
    rep = slam.timing_report()
    log(f"session ({n} frames, {SESSION_MAX_KF} keyframe rows, draw {SESSION_SEED}): "
        f"{slam.compactions} compaction passes, {slam.kf_evictions} keyframes, "
        f"{slam.mp_evictions} points and {slam.map_evictions} maps evicted, n_kf {rec['n_kf']} of "
        f"{int(slam.frame_outputs().is_kf.sum())} inserted, {fps:.3f} frames/s, host syncs/frame "
        f"{syncs:.3f}, compaction service {rep['compaction']['total_s'] * 1e3:.1f} ms over "
        f"{rep['compaction']['calls']} rounds  [{card}]")
    if slam.compactions < 1 or len(slam._kf_remaps) != slam.compactions:
        raise AssertionError("session: compaction did not fire by itself")
    if not slam.imu_initialized:
        raise AssertionError("session: the IMU was not initialized")
    return rec


def check_session(rec: dict, ref: dict):
    """The session against the JAX reference of the same configuration and
    draw: the band rule of the other references on the corrected and on the
    raw trajectory, ok_frac, the IMU's frame, and the pass count printed
    beside the reference's."""
    jd = {d["seed"]: d for d in ref["draws"]}[SESSION_SEED]
    log(f"accuracy, session, draw seed {SESSION_SEED}: ATE {rec['ate']:.5f} m (JAX "
        f"{jd['ate_m']:.5f}), raw {rec['ate_raw']:.5f} m (JAX {jd['ate_raw_m']:.5f}), ok_frac "
        f"{rec['ok_frac']:.4f} (JAX {jd['ok_frac']:.4f}), compactions {rec['compactions']} (JAX "
        f"{jd['compactions']}), keyframes evicted {rec['kf_evictions']} (JAX "
        f"{jd['kf_evictions']}), n_kf {rec['n_kf']} (JAX {jd['n_kf']}), IMU initialized at frame "
        f"{rec['imu_init_frame']} (JAX {jd['imu_init_frame']})")
    if rec["imu_init_frame"] != jd["imu_init_frame"]:
        raise AssertionError("session: the IMU initialized at another frame than the reference")
    if rec["ok_frac"] < jd["ok_frac"] - 0.05:
        raise AssertionError(f"session: ok_frac {rec['ok_frac']:.4f} below the reference - 0.05")
    for mine, theirs in ((rec["ate"], jd["ate_m"]), (rec["ate_raw"], jd["ate_raw_m"])):
        if abs(mine - theirs) > band(theirs):
            raise AssertionError(f"session: ATE {mine:.4f} m outside the JAX band {theirs:.4f} "
                                 f"+- {band(theirs):.4f}")


def leaves_phase(slam, cam, card):
    """The leaf modules of loop closing on the card at real sizes, each
    against the same call on the CPU (ids exact, floats 1e-4), with times:
    a k=10, 4-level vocabulary trained from the run's keyframe descriptors,
    transform_sparse of every keyframe and score_sparse_many of the newest
    against the rest, sim3_ransac_reproj at 256 hypotheses on the matched
    points of the two newest live keyframes, solve_pose_graph at K=256 on
    the keyframe chain with one synthetic loop edge."""
    import numpy as np
    import torch

    from orbslam3_tpu_torch.geometry.sim3 import Sim3
    from orbslam3_tpu_torch.interop import to_device
    from orbslam3_tpu_torch.loop import sim3 as ls
    from orbslam3_tpu_torch.loop import vocab as vb
    from orbslam3_tpu_torch.optim.pose_graph import PoseGraphProblem, solve_pose_graph

    dev = torch.device("cuda")

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    def close(a, b, what, atol=1e-4):
        err = float((a.cpu().float() - b.cpu().float()).abs().max())
        if not err <= atol:
            raise AssertionError(f"leaves: {what} on the card leaves the CPU's by {err} (> {atol})")
        return err

    def dense(ids, w):
        """A sparse BoW vector (its set of (id, weight) pairs) as a dense one."""
        ids, w = ids.cpu().long(), w.cpu()
        return torch.zeros(voc.n_leaves).index_add(0, ids[ids >= 0], w[ids >= 0])

    st = slam.map
    live = torch.nonzero(st.kf_valid).flatten().tolist()
    desc_c, valid_c = st.kf_desc.cpu(), st.kf_feat_valid.cpu()

    # ---- vocabulary
    t0 = time.perf_counter()
    corpus = np.concatenate([desc_c[k][valid_c[k]].numpy() for k in live])
    docs = np.concatenate([np.full(int(valid_c[k].sum()), i) for i, k in enumerate(live)])
    voc_c = vb.train_vocabulary(corpus, k=10, levels=4, doc_ids=docs)
    train_s = time.perf_counter() - t0
    voc = voc_c.to(dev)
    rows = []
    for k in live:
        (ids, w, leaf), ms = timed(lambda k=k: vb.transform_sparse(voc, st.kf_desc[k],
                                                                    st.kf_feat_valid[k]))
        ids_c, w_c, leaf_c = vb.transform_sparse(voc_c, desc_c[k], valid_c[k])
        if not torch.equal(leaf.cpu(), leaf_c):
            raise AssertionError(f"leaves: leaf ids of keyframe {k} differ between card and CPU")
        if sorted(ids[ids >= 0].tolist()) != sorted(ids_c[ids_c >= 0].tolist()):
            raise AssertionError(f"leaves: sparse BoW ids of keyframe {k} differ")
        close(dense(ids, w), dense(ids_c, w_c), f"sparse BoW weights of keyframe {k}")
        rows.append((ids, w, ids_c, w_c, ms))
    db_ids, db_w = torch.stack([r[0] for r in rows[:-1]]), torch.stack([r[1] for r in rows[:-1]])
    scores, score_ms = timed(lambda: vb.score_sparse_many(voc, rows[-1][0], rows[-1][1], db_ids, db_w))
    scores_c = vb.score_sparse_many(voc_c, rows[-1][2], rows[-1][3],
                                    torch.stack([r[2] for r in rows[:-1]]),
                                    torch.stack([r[3] for r in rows[:-1]]))
    err = close(scores, scores_c, "score_sparse_many")
    log(f"leaves: vocabulary k=10, 4 levels ({voc.n_leaves} leaves) trained on the host from "
        f"{len(corpus)} descriptors of {len(live)} keyframes in {train_s:.1f} s; transform_sparse "
        f"{np.median([r[4] for r in rows]):.2f} ms a keyframe (median of {len(rows)}), leaf ids "
        f"exact; score_sparse_many of the newest against {len(rows) - 1}: {score_ms:.2f} ms, "
        f"best {float(scores.max()):.4f}, |card - CPU| {err:.1e}  [{card}]")

    # ---- Sim3 RANSAC by reprojection on the two newest live keyframes
    ka, kb = live[-2], live[-1]
    mp_a, mp_b = st.kf_mp[ka].cpu().numpy(), st.kf_mp[kb].cpu().numpy()
    where_b = {int(m): j for j, m in enumerate(mp_b) if m >= 0}
    N = mp_a.shape[0]
    ia = np.arange(N)
    jb = np.array([where_b.get(int(m), -1) if m >= 0 else -1 for m in mp_a])
    dep_a, dep_b = st.kf_depth[ka].cpu().numpy(), st.kf_depth[kb].cpu().numpy()
    ok = (jb >= 0) & (dep_a > 0) & (dep_b[np.clip(jb, 0, None)] > 0)
    jb = np.clip(jb, 0, None)
    cam_c = cam.to("cpu")

    def body(k, idx, d):
        uv = st.kf_uv[k].cpu()[idx]
        z = torch.from_numpy(np.where(ok, d, 1.0).astype(np.float32))
        return cam_c.cam_pts_to_body(cam_c.unproject(uv, z)), uv

    pa, uv_a = body(ka, ia, dep_a)
    pb, uv_b = body(kb, jb, dep_b[jb])
    sig_a = 1.2 ** st.kf_octave[ka].cpu()[ia].float()
    sig_b = 1.2 ** st.kf_octave[kb].cpu()[jb].float()
    valid = torch.from_numpy(ok)
    samples = ls.draw_samples(valid, 256, torch.Generator().manual_seed(4))
    args_c = (pa, pb, uv_a, uv_b, sig_a, sig_b, valid)
    args = [a.to(dev) for a in args_c] + [cam]
    # the first call also loads the batched SVD's library
    _, first_ms = timed(lambda: ls.sim3_ransac_reproj(*args, samples=samples.to(dev)))
    (S, inl, n_inl), ransac_ms = timed(lambda: ls.sim3_ransac_reproj(*args, samples=samples.to(dev)))
    S_c, inl_c, n_c = ls.sim3_ransac_reproj(*args_c, cam_c, samples=samples)
    flips = int((inl.cpu() != inl_c).sum())
    tol = 1e-4 if flips == 0 else 1e-3
    err = max(close(S.t, S_c.t, "the Sim3 translation", tol),
              close(S.q * torch.sign(S.q[0] * S_c.q[0].to(dev)), S_c.q, "the Sim3 rotation", tol))
    if flips > 2 or int(ok.sum()) < 20:
        raise AssertionError(f"leaves: {flips} inlier flags differ between card and CPU "
                             f"({int(ok.sum())} matched points)")
    log(f"leaves: sim3_ransac_reproj at 256 hypotheses on {int(ok.sum())} matched points of "
        f"keyframes {ka} and {kb}: {ransac_ms:.2f} ms (first call {first_ms:.0f} ms), {int(n_inl)} inliers (CPU {int(n_c)}, "
        f"{flips} flags differ), |card - CPU| {err:.1e}  [{card}]")

    # ---- pose graph on the keyframe chain with one synthetic loop edge
    K = st.kf_valid.shape[0]
    kv = st.kf_valid.cpu()
    prev = st.kf_prev.cpu().long()
    nodes = Sim3(st.kf_q.cpu(), st.kf_p.cpu(), torch.ones(K))
    e_i = prev.clamp(min=0)
    e_j = torch.arange(K)
    e_ok = kv & (prev >= 0) & kv[e_i]
    e_i = torch.cat([e_i, torch.tensor([live[0]])])
    e_j = torch.cat([e_j, torch.tensor([live[-1]])])
    e_ok = torch.cat([e_ok, torch.tensor([True])])
    gi, gj = (Sim3(*[a[e] for a in nodes]) for e in (e_i, e_j))
    meas = gi.inverse().compose(gj)
    meas = meas._replace(t=torch.cat([meas.t[:-1], meas.t[-1:] + torch.tensor([0.05, -0.03, 0.02])]))
    fixed = ~kv
    fixed[live[0]] = True
    w = torch.cat([torch.ones(K), torch.tensor([100.0])])
    prob_c = PoseGraphProblem(nodes, kv, fixed, e_i.to(torch.int32), e_j.to(torch.int32), meas, w,
                              e_ok)
    prob = to_device(prob_c, dev)
    solve_pose_graph(prob, iters=1)  # the first call also loads the solver's library
    (out, costs), pg_ms = timed(lambda: solve_pose_graph(prob, iters=12))
    out_c, costs_c = solve_pose_graph(prob_c, iters=12)
    err = max(close(out.t, out_c.t, "pose-graph positions"),
              close(out.q * torch.sign((out.q * out_c.q.to(dev)).sum(-1, keepdim=True)), out_c.q,
                    "pose-graph rotations"))
    if not (torch.isfinite(costs).all() and float(costs[-1]) < float(costs[0])):
        raise AssertionError(f"leaves: the pose graph did not descend: {costs.tolist()}")
    close(costs / costs[0], costs_c / costs_c[0], "pose-graph costs over the first", 1e-3)
    log(f"leaves: solve_pose_graph at K={K} ({int(e_ok.sum())} edges, one loop edge "
        f"{live[0]}-{live[-1]}), 12 iterations: {pg_ms:.1f} ms, cost {float(costs[0]):.4e} -> "
        f"{float(costs[-1]):.4e}, |card - CPU| {err:.1e}  [{card}]")


def run_slice(world, times, frames, imu, cfg, device=None, profile_at=None, chunk=1,
              slam=None, start=0, stop=None, finalize=True):
    """FusedSlam.process_frame over frames [start, stop), on the device
    FusedSlam picks itself (the card) unless `device` names one, in a new
    system unless `slam` is given. With `profile_at`, frames [profile_at,
    profile_at + PROFILE_FRAMES) run under torch.profiler.
    Returns (slam, frames/s after WARMUP frames, host syncs per frame,
    (profiler, wall seconds of its window) or None)."""
    import torch

    from orbslam3_tpu_torch.models.fused import FusedSlam

    if slam is None:
        kw = dict(chunk=chunk, service_every=8)
        slam = (FusedSlam(world.cam, cfg, **kw) if device is None
                else FusedSlam(world.cam, cfg, device=device, **kw))
    on_card = slam.device.type == "cuda"
    if device is None and not on_card:
        raise AssertionError(f"FusedSlam without a device argument runs on {slam.device}")
    sync = torch.cuda.synchronize if on_card else (lambda: None)

    def step(i):
        g, a, d = imu[i]
        slam.process_frame(frames[i][0], frames[i][1], g, a, d, float(times[i]))

    n = len(times) if stop is None else stop
    prof = None
    i = start
    while i < n:
        if i == start + WARMUP:
            sync()
            slam.timing.clear()
            syncs0 = slam.host_syncs
            if on_card:
                torch.cuda.reset_peak_memory_stats()
            t_start = time.perf_counter()
        if i == profile_at:
            from torch.profiler import ProfilerActivity, profile

            sync()
            t0 = time.perf_counter()
            # device activity only: with the host's operators traced too, the
            # window's several million events took minutes to collect and sum
            with profile(activities=[ProfilerActivity.CUDA]) as p:
                for j in range(i, i + PROFILE_FRAMES):
                    step(j)
                sync()
                wall = time.perf_counter() - t0
            prof = (p, wall)
            i += PROFILE_FRAMES
            continue
        step(i)
        i += 1
    if finalize:
        slam.finalize()
    sync()
    elapsed = time.perf_counter() - t_start
    timed = n - start - WARMUP
    return slam, timed / elapsed, (slam.host_syncs - syncs0) / timed, prof


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
                n_kf=int(slam.map.n_kf), imu_init_frame=slam.imu_init_frame)


def band(ate_jax: float) -> float:
    return max(0.02, 0.5 * ate_jax)


def log_accuracy(path: str, draws):
    for d in draws:
        imu = (f", IMU initialized at frame {d['imu_init_frame']} (JAX "
               f"{d['jax'].get('imu_init_frame')})" if d["imu_init_frame"] is not None else "")
        log(f"accuracy, {path}, draw seed {d['seed']}: ATE {d['ate']:.5f} m "
            f"(JAX {d['jax']['ate_m']:.5f}), ok_frac {d['ok_frac']:.4f} "
            f"(JAX {d['jax']['ok_frac']:.4f}), n_kf {d['n_kf']} (JAX {d['jax']['n_kf']}){imu}")


def check_accuracy(path: str, draws):
    """One path of the port against its JAX reference, draw by draw.

    Every draw keeps ok_frac within 0.05 of the reference's, initializes
    the IMU at the reference's frame (never, on the stereo path); every
    stereo-inertial draw ends within 2 keyframe rows of the reference's
    count. Every sensor-noise draw
    lands within band(ATE_jax) of the reference's ATE on the same draw, and,
    where three draws run, the median ATE over them within band of the
    reference's median (one noise draw runs now: NOISE_SEEDS). The
    noise-free draw's own ATE is reported, not held, on both paths. On the
    stereo path the reference sits on an exact float32 tie of the keyframe
    gate (frame 56, 133 inliers against 0.7 * 190), and a single BRIEF bit
    that float32 rounding flips on the way decides the branch. On the
    stereo-inertial path the same front-end bits meet a keyframe gate that
    the reference passes by 2.1 inliers (frame 88), and the run was measured
    to leave the reference's branch there while both noise draws stay within
    1e-4 m of it; fed the JAX front end's features the port stays on the
    reference's branch (scripts/vi_backend_witness.py, PERF.md);
    `first_divergence` prints where."""
    import numpy as np

    for d in draws:
        if d["imu_init_frame"] != d["jax"].get("imu_init_frame"):
            raise AssertionError(f"{path}, draw {d['seed']}: IMU initialized at frame "
                                 f"{d['imu_init_frame']}, the JAX reference at "
                                 f"{d['jax'].get('imu_init_frame')}")
        if d["imu_init_frame"] is not None and abs(d["n_kf"] - d["jax"]["n_kf"]) > 2:
            raise AssertionError(f"{path}, draw {d['seed']}: n_kf {d['n_kf']} more than 2 from "
                                 f"the JAX reference's {d['jax']['n_kf']}")
        if d["ok_frac"] < d["jax"]["ok_frac"] - 0.05:
            raise AssertionError(f"{path}, draw {d['seed']}: ok_frac {d['ok_frac']:.4f} below the "
                                 f"JAX reference {d['jax']['ok_frac']:.4f} - 0.05")
        if d["seed"] is not None and abs(d["ate"] - d["jax"]["ate_m"]) > band(d["jax"]["ate_m"]):
            raise AssertionError(f"{path}, draw {d['seed']}: ATE {d['ate']:.4f} m outside the JAX "
                                 f"band {d['jax']['ate_m']:.4f} +- {band(d['jax']['ate_m']):.4f}")
    if len(draws) < 3:  # with the noise-free knife edge among two draws a median says nothing
        return
    med = float(np.median([d["ate"] for d in draws]))
    med_jax = float(np.median([d["jax"]["ate_m"] for d in draws]))
    log(f"accuracy, {path}: median ATE over {len(draws)} draws {med:.5f} m, JAX {med_jax:.5f} m "
        f"(band +-{band(med_jax):.4f})")
    if abs(med - med_jax) > band(med_jax):
        raise AssertionError(f"{path}: median ATE {med:.4f} m outside the JAX band "
                             f"{med_jax:.4f} +- {band(med_jax):.4f}")


def second_run_and_profile(world, times, frames, imu, first, card) -> float:
    """A second full stereo-inertial run through a checkpoint: frames
    [0, SAVE_AT) in one system, save_map, load_map on the card,
    FusedSlam.from_state, the remaining frames in the resumed system. Its
    raw poses must equal `first`'s bit for bit before the checkpoint and
    stay within 1 mm of it after; the IMU state is carried (no second
    initialization). A torch.profiler window sits in the resumed part.
    Prints device time by kernel; returns the FAST/NMS kernel's device
    milliseconds per frame."""
    import tempfile

    import numpy as np

    from orbslam3_tpu_torch.map.checkpoint import load_map, save_map
    from orbslam3_tpu_torch.models.fused import BENCH_CFG, FusedSlam

    n = len(times)
    if not first.imu_init_frame < SAVE_AT:
        raise AssertionError(f"the checkpoint at frame {SAVE_AT} comes before the IMU "
                             f"initialized (frame {first.imu_init_frame})")
    # the window closes the run: every launch after the profiler attached costs more host time
    p0 = n - PROFILE_FRAMES
    step_ms = first.timing_report()["step"]["mean_ms"]
    head, _, _, _ = run_slice(world, times, frames, imu, BENCH_CFG, stop=SAVE_AT, finalize=False)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "checkpoint.npz")
        t0 = time.perf_counter()
        save_map(path, head.map, head.ts)
        t1 = time.perf_counter()
        st, ts = load_map(path, with_track_state=True)
        t2 = time.perf_counter()
        size = os.path.getsize(path)
    if st.kf_q.device.type != "cuda":
        raise AssertionError(f"load_map without a device argument loaded onto {st.kf_q.device}")
    resumed = FusedSlam.from_state(world.cam, BENCH_CFG, st, ts)
    log(f"checkpoint after frame {SAVE_AT - 1}: {size / 2**20:.2f} MiB, save_map "
        f"{(t1 - t0) * 1e3:.0f} ms, load_map onto the card {(t2 - t1) * 1e3:.0f} ms; resumed with "
        f"n_kf {resumed._n_kf}, IMU initialized {resumed.imu_initialized}  [{card}]")
    if not resumed.imu_initialized or resumed.device.type != "cuda":
        raise AssertionError("the resumed system lost the IMU state or left the card")
    _, _, _, (prof, wall) = run_slice(world, times, frames, imu, BENCH_CFG, slam=resumed,
                                      start=SAVE_AT, profile_at=p0)
    if resumed.imu_init_frame is not None or "imu_init" in resumed.timing:
        raise AssertionError("the resumed system initialized the IMU a second time")
    a, b, c = head.frame_outputs(), resumed.frame_outputs(), first.frame_outputs()
    same_head = bool(np.array_equal(a.p, c.p[:SAVE_AT]) and np.array_equal(a.q, c.q[:SAVE_AT]))
    same_tail = bool(np.array_equal(b.p, c.p[SAVE_AT:]) and np.array_equal(b.q, c.q[SAVE_AT:]))
    far = float(np.linalg.norm(b.p - c.p[SAVE_AT:], axis=1).max())
    log(f"reproducible: a second stereo-inertial run's raw poses equal the first run's bit for "
        f"bit over frames 0..{SAVE_AT - 1}: {same_head}; resumed from the checkpoint over frames "
        f"{SAVE_AT}..{n - 1}: bit for bit {same_tail}, largest position difference {far:.3e} m, "
        f"n_kf {int(resumed.map.n_kf)} (uninterrupted {int(first.map.n_kf)})")
    if not same_head:
        raise AssertionError("two stereo-inertial runs on the same frames gave different poses")
    if not far <= 1e-3 or b.p.shape != (n - SAVE_AT, 3):
        raise AssertionError(f"the resumed run leaves the uninterrupted one by {far} m (> 1 mm)")
    n_kfs = int(b.is_kf[p0 - SAVE_AT:p0 - SAVE_AT + PROFILE_FRAMES].sum())
    if n_kfs < 2:
        raise AssertionError(f"the profiler window holds {n_kfs} keyframes, fewer than 2")
    events = [e for e in prof.key_averages()
              if str(e.device_type).endswith("CUDA") and device_us(e) > 0]
    dev_us = sum(device_us(e) for e in events)
    events.sort(key=device_us, reverse=True)
    log(f"profile: stereo-inertial frames {p0}..{p0 + PROFILE_FRAMES - 1} ({n_kfs} VI-BA "
        f"keyframes), wall {wall * 1e3 / PROFILE_FRAMES:.2f} ms/frame, device busy "
        f"{dev_us / 1e3 / PROFILE_FRAMES:.2f} ms/frame "
        f"({100 * dev_us / 1e6 / max(wall, 1e-9):.1f}% of the window's wall with device tracing "
        f"on, {100 * dev_us / 1e3 / PROFILE_FRAMES / step_ms:.1f}% of the first run's untraced "
        f"step of {step_ms:.1f} ms; nothing else on the card)  [{card}]")
    for e in events[:14]:
        log(f"  {device_us(e) / 1e3 / PROFILE_FRAMES:8.3f} ms/frame "
            f"{e.count / PROFILE_FRAMES:8.1f}/frame  {e.key[:90]}")
    us_frame, per_frame = kernel_device_us(prof, PROFILE_FRAMES)
    log(f"profile: {KERNEL_NAME} {us_frame / 1e3:.5f} ms/frame in {per_frame:g} launch/frame "
        f"on the main path  [{card}]")
    if per_frame != LAUNCHES_PER_FRAME:
        raise AssertionError(f"the profiler saw {per_frame} {KERNEL_NAME} launches per frame, "
                             f"expected {LAUNCHES_PER_FRAME}")
    return us_frame


_DRAWS: dict = {}


def noisy(frames, seed: int):
    """Sensor-noise draw `seed` of the rendered frames, made once."""
    from orbslam3_tpu_torch.io.synthetic import perturb_frames

    if seed not in _DRAWS:
        _DRAWS[seed] = perturb_frames(frames, seed)
    return _DRAWS[seed]


def noise_draws(path, world, times, frames, imu, cfg, gt_p, card) -> dict:
    """A full run of one path under each sensor-noise draw; {seed: record}."""
    records = {}
    for seed in NOISE_SEEDS:
        slam, fps, _, _ = run_slice(world, times, noisy(frames, seed), imu, cfg)
        records[seed] = accuracy(slam, gt_p, len(times))
        log(f"  {path}, draw seed {seed}: {fps:.3f} frames/s, keyframes culled "
            f"{int(slam.map.n_kf) - int(slam.map.kf_valid.sum())}  [{card}]")
    return records


def stage_table(path: str, report: dict, card: str):
    """The step's host wall time by stage, from timing_report(): mean per
    call, calls, and share of the whole step's time over the timed frames."""
    step = report["step"]
    log(f"{path}: the step by stage, host wall over {step['calls']} frames "
        f"({step['mean_ms']:.1f} ms a frame)  [{card}]")
    for name, cell in sorted(report.items(), key=lambda kv: -kv[1]["total_s"]):
        if name.startswith("step."):
            log(f"  {name[5:]:22s} {cell['mean_ms']:9.2f} ms/call x {cell['calls']:4d} calls "
                f"= {100 * cell['total_s'] / max(step['total_s'], 1e-9):5.1f}% of the step")


def first_divergence(slam, ref) -> str:
    """Where a noise-free run first departs from the reference's per-frame
    record (keyframe decisions, match and inlier counts; positions by more
    than 1 mm), with the reference's margin to the keyframe gate there."""
    import numpy as np

    outs, pf = slam.frame_outputs(), ref["per_frame"]
    _, ps, _ = slam.trajectory_arrays()
    parts = []
    for name, got in (("is_kf", outs.is_kf.astype(int)), ("n_matches", outs.n_matches),
                      ("n_inliers", outs.n_inliers)):
        bad = np.flatnonzero(np.asarray(got) != np.asarray(pf[name]))
        parts.append(f"{name} from frame {bad[0]} (port {int(got[bad[0]])}, JAX "
                     f"{pf[name][bad[0]]})" if len(bad) else f"{name} never")
    far = np.flatnonzero(np.linalg.norm(ps - np.asarray(pf["p"]), axis=1) > 1e-3)
    parts.append(f"position by > 1 mm from frame {far[0]}" if len(far) else "position never")
    if "gate_margin" in pf:
        m = np.abs(np.asarray(pf["gate_margin"]))
        ok = np.asarray(pf["n_inliers"]) > 25
        near = [f"{i} ({pf['gate_margin'][i]:+.1f})" for i in np.flatnonzero((m <= 3.0) & ok)]
        parts.append("reference frames within 3 inliers of the keyframe gate: "
                     + (", ".join(near) or "none"))
    return "; ".join(parts)


def counted_run(path, world, times, frames, imu, cfg, chunk=1, **kw):
    """A run of one path with the kernel's launch counter set to 0 just
    before it and read just after: exactly one launch per dispatch, a frame
    at chunk=1 and a chunk of frames otherwise."""
    from orbslam3_tpu_torch.ops.fast_cuda import fast_nms

    fast_nms.launches = 0
    out = run_slice(world, times, frames, imu, cfg, chunk=chunk, **kw)
    launches = fast_nms.launches
    if launches * chunk != LAUNCHES_PER_FRAME * len(times):
        raise AssertionError(f"{path}: fast_nms launched {launches} times over {len(times)} "
                             f"frames, expected {LAUNCHES_PER_FRAME} per {chunk} frame(s)")
    return out, launches


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
    phase("0 the card, 1 build, 2 kernel")
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

    kern = kernel_phase(frames[0][0].astype(np.float32), frames[0][1].astype(np.float32))
    kern16 = kernel_phase_chunk(frames, world.cam.to("cuda"))
    log(f"  [{card}]")

    # ---- 3. the stereo path (SLICE_CFG): noise-free, then its noise draws
    phase("3 stereo path")
    from orbslam3_tpu_torch.models.fused import BENCH_CFG, SLICE_CFG

    data = os.path.join(ROOT, "orbslam3_tpu_torch", "data")
    with open(os.path.join(data, "slice_reference.json")) as f:
        ref_stereo = json.load(f)
    with open(os.path.join(data, "vi_reference.json")) as f:
        ref_vi = json.load(f)
    with open(os.path.join(data, "session_reference.json")) as f:
        ref_session = json.load(f)
    n = len(times)
    (slam, fps, syncs_per_frame, _), launches_stereo = counted_run(
        "stereo", world, times, frames, imu, SLICE_CFG)
    log(f"stereo: {n} frames, n_kf {int(slam.map.n_kf)} (JAX {ref_stereo['n_kf']}), "
        f"n_mp {int(slam.map.n_mp)} (JAX {ref_stereo['n_mp']})")
    log(f"stereo: {fps:.3f} frames/s after {WARMUP} warm-up frames, host syncs/frame "
        f"{syncs_per_frame:.3f}, peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB, fast_nms launches "
        f"{launches_stereo} ({launches_stereo / n:.1f}/frame)  [{card}]")
    log("stereo timing_report (host wall, ms/call): " + json.dumps(slam.timing_report()))
    stage_table("stereo", slam.timing_report(), card)
    gt_p, _ = world.gt_trajectory()
    records = {("stereo", None): accuracy(slam, gt_p, n)}
    log("stereo, noise-free against the reference: " + first_divergence(slam, ref_stereo))
    del slam
    for seed, rec in noise_draws("stereo", world, times, frames, imu, SLICE_CFG, gt_p,
                                 card).items():
        records[("stereo", seed)] = rec

    # ---- 4. the stereo-inertial path (BENCH_CFG): the main path
    phase("4 stereo-inertial path")
    (vi, fps, syncs_per_frame, _), launches = counted_run(
        "stereo-inertial", world, times, frames, imu, BENCH_CFG)
    peak = torch.cuda.max_memory_allocated()
    if not vi.imu_initialized or not bool(vi.ts.imu_ok):
        raise AssertionError("stereo-inertial: the IMU was not initialized by the end of the run")
    n_kf, n_mp = int(vi.map.n_kf), int(vi.map.n_mp)
    kf_live = int(vi.map.kf_valid.sum())
    jd = ref_vi["draws"][0]
    fmt = (lambda x: np.round(x.cpu().numpy().astype(np.float64), 5).tolist())
    log(f"stereo-inertial: {n} frames, n_kf {n_kf} (JAX {jd['n_kf']}), n_mp {n_mp} "
        f"(JAX {jd['n_mp']}), keyframes culled {n_kf - kf_live} (JAX "
        f"{jd['n_kf'] - jd['n_kf_valid']}), IMU refines {vi.imu_refines}  [{card}]")
    log(f"stereo-inertial: IMU initialized at frame {vi.imu_init_frame} (JAX "
        f"{jd['imu_init_frame']}), gravity {fmt(vi.ts.gravity_w)} (JAX {jd['gravity_w']}), "
        f"gyro bias {fmt(vi.ts.bg)}, accel bias {fmt(vi.ts.ba)}  [{card}]")
    log(f"stereo-inertial: {fps:.3f} frames/s after {WARMUP} warm-up frames, host syncs/frame "
        f"{syncs_per_frame:.3f}, peak device memory {peak / 2**20:.1f} MiB, fast_nms launches "
        f"{launches} ({launches / n:.1f}/frame)  [{card}]")
    log("stereo-inertial timing_report (host wall, ms/call): " + json.dumps(vi.timing_report()))
    stage_table("stereo-inertial", vi.timing_report(), card)
    records[("stereo-inertial", None)] = accuracy(vi, gt_p, n)
    log("stereo-inertial, noise-free against the reference: " + first_divergence(vi, ref_vi))

    phase("4b the same frames at chunk=8; compact_map at full capacity")
    launches_chunk, fps_chunk = chunk_run(world, times, frames, imu, vi, fps, card)
    compaction_check(vi, card)

    # ---- 5. the path's noise draws, the long session, the leaves of loop
    # closing; then a second full run through a checkpoint: equal poses, and a
    # profiler window after the IMU initialized (device time by kernel)
    phase("5 stereo-inertial noise draws")
    for seed, rec in noise_draws("stereo-inertial", world, times, frames, imu, BENCH_CFG, gt_p,
                                 card).items():
        records[("stereo-inertial", seed)] = rec
    phase("5b the long session: 16 keyframe rows, compaction by itself")
    session = session_run(world, times, frames, imu, gt_p, card)
    phase("5c the leaves of loop closing on the card")
    leaves_phase(vi, vi.cam, card)
    phase("5d the second run, through a checkpoint, with the profiler window")
    us_frame = second_run_and_profile(world, times, frames, imu, vi, card)
    del vi

    # ---- 6. both paths against their JAX references (last, so a failing run
    # still shows where its time went)
    phase("6 accuracy")
    draws = {}
    for path, ref in (("stereo", ref_stereo), ("stereo-inertial", ref_vi)):
        by_seed = {d["seed"]: d for d in ref["draws"]}
        draws[path] = [dict(seed=seed, jax=by_seed[seed], **records[(path, seed)])
                       for seed in (None,) + NOISE_SEEDS]
        log_accuracy(path, draws[path])
    for path in draws:
        check_accuracy(path, draws[path])
    check_session(session, ref_session)

    log(json.dumps({"kernels": [{
        "name": "fast_nms", "route": "cuda", "source": "orbslam3_tpu_torch/csrc/fast_nms.cu",
        "replaces": "orbslam3_tpu/ops/fast_pallas.py:147", "launches": launches,
        "launches_by_path": {"stereo": launches_stereo, "stereo_inertial": launches,
                             "stereo_inertial_chunk8": launches_chunk},
        "chunk8": {**kern16, "frames_per_s": fps_chunk, "chunk1_frames_per_s": fps},
        "library_ms": None, "profile_ms": us_frame / 1e3,
        "earlier_ms_is": "8 one-level launches of this kernel, the call pattern before the "
                         "levels were fused, timed in this run",
        **kern}]}))
    log(card)
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
