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
3. stereo path: FusedSlam(cam, SLICE_CFG) on cuda over the first
   STEREO_FRAMES frames of the 8 s, 20 Hz, 752x480 bench world
   (bench.py::HARD_WORLD), noise-free, against the recorded JAX reference
   (orbslam3_tpu_torch/data/slice_reference.json: where it first departs,
   ok_frac). The launch counter is set to 0 just before the run and must
   have grown by exactly 1 per frame (one launch for all pyramid levels)
   just after it;
4. stereo-inertial path, the main path: FusedSlam(cam, BENCH_CFG), built
   with no `device` argument (so it must pick the card itself), over the
   first MAIN_FRAMES frames of the same world with its IMU windows. Launch
   counter as in 3. Raises unless
   the IMU is initialized at the end and the trajectory is finite with one
   pose a frame. Prints frames/s after 8 warm-up frames, timing_report()
   and from it the step's host time by stage (front end, matching, RANSAC
   seed, visual and visual-inertial pose solve, flag read, keyframe insert,
   BA and VI-BA, triangulation, fusion, point statistics, culling), host
   syncs per frame, peak device memory, the frame at which the IMU
   initialized, gravity and biases, map sizes and keyframes culled. The run
   is saved (save_map) before frame SAVE_AT, off its clock. Then
   (a) the same frames with the loop closer as bench.py's
   fps_with_loop_closing runs it: chunk=8, service_every=8, warmup=True and
   the world's vocabulary (data/vocab_bench.npz, k=10, 4 levels): one
   FAST/NMS launch a chunk (11 over 88 frames), no correction and the IMU
   initialized after frame 63 as in the JAX reference
   (data/loop_reference.json), raw poses held to the chunk=1 run's (1 mm;
   whether they are equal bit for bit is printed), frames/s and the stage
   table beside chunk=1's, the loop service per keyframe by stage (host
   wall) and the warmup's wall time. Then compact_map on the run's final
   map at the full capacity shapes, on the card against the CPU (exact)
   with its invariants and its time. From here on the revisit world of 6
   renders in worker processes in the background, and the EuRoC fixtures
   of 8 are written the same way, so the times of 5b and 5c are taken
   under that load;
5. a long session on sensor-noise draw 1 of the stereo-inertial path:
   104 frames with a map of 16 keyframe rows, so that compaction and the
   keyframe pressure evictions fire by themselves, held to the JAX
   reference of the same configuration
   (orbslam3_tpu_torch/data/session_reference.json), the main path's
   accuracy under sensor noise (the band rule); the leaves of loop
   closing on the card against the CPU at real sizes (a k=10, 4-level
   vocabulary trained from the run's keyframe descriptors, sparse BoW
   vectors and scores, Sim3 RANSAC by reprojection at 256 hypotheses, the
   pose graph at K=256); the front end's and the IMU's leaves on one
   752x480 frame (detect_orb, one launch at B=1, bit for bit against the
   left of detect_orb_pair; the popcount Hamming distances, orientations,
   descriptors, subpixel_refine, process_stereo, integrate and
   information_9 against the CPU); last of all (5d, after phase 8) the main run's
   checkpoint loaded on the card (load_map) and resumed in a new system
   (FusedSlam.from_state) for the frames up to SECOND_STOP: raw poses within
   1 mm of the uninterrupted run (bit-equality is printed), no second IMU
   initialization; a torch.profiler window over the last 16 of them
   (visual-inertial pose solves and at least two VI-BA keyframes) gives
   device time by kernel, the FAST/NMS kernel's own time and launches per
   frame, and the device's busy share, of the window's wall time and of the
   main run's untraced step. The profiled run comes last: once the
   profiler has attached to the CUDA runtime every later launch of the
   process costs more host time;
6. loop closing, before the profiled run, with the EuRoC runs of 8 in two
   processes beside 6b-6d: (b) the revisit world of
   bench.py::build_revisit_world (24 s, a camera blackout at 10-13 s with an
   IMU bias step, a second lap over the first), its first REVISIT_FRAMES
   (392) of 480 frames, under BENCH_CFG with its vocabulary
   (data/vocab_revisit.npz), chunk=8, service_every=8, warmup=True,
   MapCapacity() (K=256, M=32768), held to the JAX reference of the same run
   over those frames (at least one correction, the
   count within 1 of the reference's, the first correction on a keyframe
   pair whose times are within 1 s of the reference's pair, as many merges,
   a finite trajectory with one pose a frame), printing ATE, LoopStats, the
   seams and per correction the host time of each stage, the host reads and
   the global BA's size; its relocalizations are printed beside the
   reference's, not held: the port's relocalization-mode rounds, read from
   its host mirrors after every round, are held to the JAX rule over its own
   per-frame tracker modes, and the rounds that differ from the reference's
   are printed with the port's modes at their snapshots; (c) the
   blackout-then-merge world of tests/test_fused_loop.py (384x256, 80
   frames, visual only): a merge into map 0, post-merge ATE < 0.15 m;
   (e) the relocalization world of tests/test_fused_loop.py (384x256, 80
   frames, a 2 s blackout, visual only) with its vocabulary
   (data/vocab_reloc.npz): no new map, at least one relocalization, the
   first on the reference's keyframe pair, OK share after the blackout
   > 0.9, post-blackout ATE < 0.15 m, the mirrors held to the rule and the
   rule over the reference's own modes giving the reference's rounds;
   (d) the first correction of (b) run again twice on its recorded input
   state: poses and points equal bit for bit to the run's, the second run
   with the device synchronized at each stage's end for the stages' device
   times; the verification of its query against its candidate and the three
   keyframes sharing the most points with it on the card with fed samples
   against the CPU (counts exact; the Sim3 and seam of those past the
   inlier gate within 1e-5); card
   times of the exhaustive detection product and of one global-BA step;
8. EuRoC ingest, started before 6b and finished before the profiled run:
   the native loader built with
   g++ from native/dataloader.cpp (a failed build raises with the
   compiler's message); the two fixtures of scripts/make_euroc_reference.py
   written by the port's writer (io/euroc_fixture.py): (ii) 8 s at 20 Hz,
   752x480, the published EuRoC MH calibration unscaled, and (iii) the
   24 s, 376x240 loop fixture; rectification of every pair of (ii) on the
   card against the CPU (flipped uint8 pixels a frame, which must be 0),
   the remap's CUDA-event time per stereo pair beside its bound and
   grid_sample's; then, in two spawned processes that run beside phase 6
   (the card is idle most of a step): (ii) through
   scripts/run_euroc_torch.py::run at chunk 1
   under the production configuration (SlamConfig(kf_max_frames=6)), one
   FAST/NMS launch a frame, held to its JAX record
   (orbslam3_tpu_torch/data/euroc_reference.json) with the band rule, ok_frac
   and the IMU's frame; (iii) with the JAX-trained vocabulary
   (data/euroc_loop_vocab.txt): corrections within 1 of the record's, the
   first pair's keyframe times within 1 s; (iii) again with a vocabulary
   the port trains on the card (detect_orb, one launch an image) and
   round-trips through DBoW2 text: the JAX test's bars (IMU initialized,
   >= 1 correction, ATE < 0.7 m); frames/s after 8 warm-up frames, the
   stage table and peak memory of each run;
   (f) distributed global BA on (d)'s recorded input state with the
   closer's table: `distributed_global_ba` over a one-rank NCCL group in
   this process equal to `global_ba` bit for bit, then two spawned ranks of
   a gloo group on CUDA tensors of the one card (NCCL refuses two ranks on
   one card): the ranks bit-equal and within 1e-4 of one rank; CUDA-event
   time per Gauss-Newton step beside the all_reduce's bytes;
9. the fleet (scripts/bench_fleet.py's configuration), in a spawned process
   beside phases 6b-6f: FLEET_SESSIONS sessions of a MultiSessionSlam on the
   one card, worlds SyntheticConfig(seed=s, n_landmarks=800) at 752x480 and
   20 Hz, SlamConfig(use_imu=True, kf_max_frames=6, ba_iters=3,
   ba_window=6), default capacities, chunk FLEET_CHUNK, FLEET_FRAMES frames a
   session and half of them for session 0 (a ragged stream). The launch
   counter set to 0 just before the fleet and read just after must equal
   the sessions with frames summed over the flushes; sessions 0 and 1 equal
   a lone FusedSlam(chunk=4, service_every=10**9) on their frames bit for
   bit; every session has two keyframes or more and a finite trajectory of
   its true length. Prints the aggregate tracked frames/s after the warm-up
   flush, per-session frames/s, peak memory and memory per session;
10. the entry points, in the same process after the fleet: entry() on the
   card against the CPU (n_inliers exact, q and p within 1e-5), then
   dryrun_multichip(2) on the card (two gloo ranks, a two-session fleet);
11. the host-orchestrated SlamSystem, (a) and (b) in a spawned process
   beside phases 6b-6f, each run built with no `device` (it must pick the
   card) and one FAST/NMS launch a frame (the counter set to 0 just before
   each run and read just after): (a) the production SlamConfig() (752x480,
   1024 features, 8 levels, MapCapacity()) over the bench world's first
   SLAM_SYSTEM_FRAMES (104) frames on sensor-noise draw SLAM_SYSTEM_SEED (1),
   held to the JAX record (orbslam3_tpu_torch/data/slam_system_reference.json,
   scripts/make_slam_system_reference.py) with the band rule, ok_frac, the
   IMU's frame and the maps created, then noise-free, printed beside the
   record; (b) the worlds of the JAX package's SlamSystem tests
   (SLAM_SYSTEM_WORLDS) held to each test's bars, the static world's reset
   to the record's; (c) in this process after phases 9-10, before 5d:
   scripts/profile_pipeline_torch.py at full width, each stage's host wall
   and device-inclusive milliseconds (CUDA events, the device synchronized
   at the stage's end), one launch a call in the stages that run the front
   end;
12. scripts/eval_suite_torch.py's runs (EVAL_RUNS: its stereo-inertial mode
   on seeds 11 and 23, its EuRoC-extrinsics mode on seed 11; 8 s, 160
   frames at 752x480, chunk 8) in a spawned process beside phases 5b-6f,
   each held to the JAX record (orbslam3_tpu_torch/data/eval_reference.json,
   scripts/make_eval_reference.py): the first and last frame's checksums,
   the IMU's frame within one chunk, ok_frac, one launch a dispatched
   chunk; ATE, RPE, keyframes, the first departing frame and frames/s
   printed beside the record;
7. accuracy of the odometry paths against their JAX references over the
   frames they ran (check_accuracy) and of the session (check_session).

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
CHUNK = 8  # bench.py's frames per dispatch
SAVE_AT = 64  # the main run is saved after frame 63 (the IMU initializes after 63) ...
SECOND_STOP = 88  # ... and resumed up to frame 87, the last 16 under the profiler
STEREO_FRAMES = 80  # the stereo path's frames (no production configuration runs it)
MAIN_FRAMES = 88  # the stereo-inertial path's frames at chunk 1 and, with the loop closer, 8
# bench.py::build_revisit_world: a full-turn pan every 16 s, 16 s-periodic
# position (the second lap revisits the first), noisy biased IMU, a camera
# blackout with an IMU bias step at 10 s
REVISIT_WORLD = dict(duration=24.0, n_landmarks=1500, seed=7, yaw_amp=0.0,
                     yaw_rate=2 * 3.141592653589793 / 16.0, pos_freq=(0.125, 0.1875, 0.25),
                     imu_noise=True, gyro_bias=(0.003, -0.002, 0.004),
                     accel_bias=(0.03, 0.02, -0.04), bias_step_t=10.0,
                     gyro_bias_step=(0.004, 0.003, -0.005), accel_bias_step=(0.15, -0.10, 0.10))
REVISIT_BLACKOUT = (10.0, 13.0)
# the revisit world's frames run on the card: past the reference's first
# correction (frame 343) and the port's, short of the 480 the world has
REVISIT_FRAMES = 392
# tests/test_fused_loop.py::test_blackout_then_merge
MERGE_WORLD = dict(width=384, height=256, fx=240.0, fy=240.0, n_landmarks=600, duration=8.0,
                   cam_hz=10.0, pos_amp=(1.0, 0.7, 0.25), yaw_amp=0.5)
MERGE_BLACKOUT = (2.5, 3.3)
MERGE_LOOP = dict(recent_gap=3, consistency_needed=2, covis_edge_weight_min=10,
                  bow_min_score_gate=False)
# tests/test_fused_loop.py::test_blackout_relocalizes_same_map
RELOC_WORLD = dict(MERGE_WORLD, pos_freq=(0.22, 0.3, 0.35), yaw_amp=0.8, yaw_freq=0.22)
RELOC_BLACKOUT = (2.5, 4.5)
RELOC_LOOP = dict(recent_gap=3, covis_edge_weight_min=10, bow_min_score_gate=False)
SESSION_FRAMES, SESSION_MAX_KF, SESSION_SEED = 104, 16, 1  # scripts/make_session_reference.py
LAUNCHES_PER_FRAME = 1  # one fast_nms_levels launch for the whole pyramid
# phase 11 (scripts/make_slam_system_reference.py records the JAX runs):
# SlamSystem under the production SlamConfig() on the bench world's first
# frames, and the worlds and configurations of the JAX package's SlamSystem
# tests, as (SyntheticConfig fields, SlamConfig fields with orb/cap/track as
# keyword dicts, camera blackout or None); "extrinsics" takes euroc_t_bc()
SLAM_SYSTEM_FRAMES, SLAM_SYSTEM_SEED = 104, 1
# phase 12: scripts/eval_suite_torch.py's runs (8 s, chunk 8) on seeds the
# other phases never run, held to data/eval_reference.json
# (scripts/make_eval_reference.py records the JAX runs)
EVAL_RUNS = (("inertial", 11), ("inertial", 23), ("extrinsics", 11))
_E2E_WORLD = dict(width=384, height=256, fx=240.0, fy=240.0, n_landmarks=600, duration=4.0,
                  cam_hz=10.0, pos_amp=(1.2, 0.8, 0.3))
_E2E_BIAS = dict(gyro_bias=(0.003, -0.002, 0.004), accel_bias=(0.03, 0.02, -0.04))
_E2E_CFG = dict(orb=dict(n_features=384, n_levels=4),
                cap=dict(max_kf=64, n_feat=384, max_mp=8192, max_obs=8),
                track=dict(p_local=2048), ba_points=1024, kf_max_frames=2)
SLAM_SYSTEM_WORLDS = {
    # tests/test_e2e_stereo.py, test_e2e_inertial.py, test_atlas.py,
    # test_extrinsics.py::test_e2e_inertial_with_euroc_extrinsics and the
    # static world of test_recovery.py::test_static_start_triggers_bad_imu_reset
    "stereo": (_E2E_WORLD, dict(_E2E_CFG, use_imu=False), None),
    "inertial": (dict(_E2E_WORLD, **_E2E_BIAS), dict(_E2E_CFG, use_imu=True, imu_init_kfs=8),
                 None),
    "atlas": (dict(_E2E_WORLD, duration=6.0),
              dict(_E2E_CFG, cap=dict(_E2E_CFG["cap"], max_kf=96), use_imu=False,
                   lost_timeout=0.3, min_kfs_keep_map=5), (2.0, 3.0)),
    "extrinsics": (dict(_E2E_WORLD, **_E2E_BIAS, extrinsics=True),
                   dict(_E2E_CFG, use_imu=True, imu_init_kfs=8), None),
    "static": (dict(width=256, height=192, fx=160.0, fy=160.0, n_landmarks=400, duration=13.0,
                    cam_hz=4.0, pos_amp=(0.0, 0.0, 0.0), yaw_amp=0.0, rp_amp=0.0),
               dict(orb=dict(n_features=256, n_levels=3),
                    cap=dict(max_kf=64, n_feat=256, max_mp=4096, max_obs=8),
                    track=dict(p_local=1024), ba_points=512, use_imu=True, kf_max_frames=2,
                    imu_init_kfs=6, bad_imu_timeout=8.0), None),
}


def slam_system_world(pkg, name: str):
    """SLAM_SYSTEM_WORLDS[name] built from either package's classes: `pkg`
    holds SyntheticConfig, SyntheticWorld, euroc_t_bc, SlamConfig,
    OrbConfig, MapCapacity and TrackConfig. Returns (world, SlamConfig,
    blackout)."""
    wkw, ckw, blackout = SLAM_SYSTEM_WORLDS[name]
    wkw = dict(wkw)
    if wkw.pop("extrinsics", False):
        wkw["q_bc"], wkw["p_bc"] = pkg["euroc_t_bc"]()
    ckw = dict(ckw, orb=pkg["OrbConfig"](**ckw["orb"]), cap=pkg["MapCapacity"](**ckw["cap"]),
               track=pkg["TrackConfig"](**ckw["track"]))
    return pkg["SyntheticWorld"](pkg["SyntheticConfig"](**wkw)), pkg["SlamConfig"](**ckw), blackout


def slam_system_inputs(world, blackout=None) -> list:
    """A test world's process_frame arguments, frame by frame, as the JAX
    tests make them: render_frame's float32 images (flat 127 in the
    blackout) and the IMU samples since the previous frame."""
    import numpy as np

    times = world.frame_times()
    blank = np.full((world.cfg.height, world.cfg.width), 127.0, np.float32)
    out = []
    for i, t in enumerate(times):
        dark = blackout is not None and blackout[0] <= t < blackout[1]
        left, right = (blank, blank) if dark else world.render_frame(t)
        out.append((left, right, *world.imu_window(times[i - 1] if i else t, t), float(t)))
    return out


def drive_slam_system(slam, inputs, hook=None) -> int | None:
    """process_frame over `inputs` (a SlamSystem of either package);
    returns the index of the frame after which the IMU was initialized.
    `hook(i)` runs after frame i."""
    init = None
    for i, args in enumerate(inputs):
        slam.process_frame(*args)
        if init is None and slam.imu_initialized:
            init = i
        if hook is not None:
            hook(i)
    return init


def slam_system_record(slam, world, imu_init_frame, blackout=None) -> dict:
    """What a SlamSystem run of either package ended with: the JAX tests'
    quantities (ATE over the trajectory against the ground truth's first
    frames, ok_frac, the gravity direction error, biases, maps created,
    the valid keyframes' map ids, the active map's keyframes, ok_frac after
    the blackout) and the per-frame record."""
    import numpy as np

    from orbslam3_tpu_torch.eval.metrics import ate_rmse
    from orbslam3_tpu_torch.io.synthetic import _qrot

    def host(x):
        return None if x is None else np.asarray(x.cpu() if hasattr(x, "is_cuda") else x)

    tr = slam.trajectory
    ts, ps, qs = slam.trajectory_arrays()
    gt_p, _ = world.gt_trajectory()
    ok = np.array([r.state == "Ok" for r in tr])
    q0, _ = world.gt_pose(0.0)
    g_true = _qrot(np.asarray(q0, np.float64) * [1, -1, -1, -1], np.array([0.0, 0.0, -9.81]))
    g = host(slam.gravity_w)
    g_err = (None if g is None else float(np.degrees(np.arccos(np.clip(
        g_true @ g / (np.linalg.norm(g_true) * np.linalg.norm(g)), -1.0, 1.0)))))
    m = slam.map
    valid = host(m.kf_valid)
    map_ids = host(m.kf_map_id)
    post = ts > blackout[1] + 0.5 if blackout is not None else np.ones(len(ts), bool)
    as_list = (lambda x: None if x is None else [float(v) for v in np.asarray(x, np.float64)])
    return dict(
        frames=len(tr), ate_m=float(ate_rmse(ps, gt_p[:len(ps)])), ok_frac=float(ok.mean()),
        ok_frac_post=float(ok[post].mean()) if post.any() else None,
        imu_initialized=bool(slam.imu_initialized), imu_init_frame=imu_init_frame,
        gravity_w=as_list(g), gravity_err_deg=g_err, bg=as_list(host(slam.bg)),
        ba=as_list(host(slam.ba)), n_maps_created=int(slam.n_maps_created),
        bad_imu_resets=int(getattr(slam, "bad_imu_resets", 0)),
        map_ids=sorted({int(x) for x in map_ids[valid]}),
        n_active=int(((map_ids == int(host(m.active_map))) & valid).sum()),
        n_kf=int(host(m.n_kf)), n_kf_valid=int(valid.sum()), n_mp=int(host(m.n_mp)),
        per_frame=dict(t=[float(r.t) for r in tr], state=[r.state for r in tr],
                       is_kf=[bool(r.is_keyframe) for r in tr],
                       n_matches=[int(r.n_matches) for r in tr],
                       n_inliers=[int(r.n_inliers) for r in tr],
                       p=[as_list(r.p) for r in tr], q=[as_list(r.q) for r in tr]))
# scripts/bench_fleet.py: 8 sessions, session 0 with half the frames, chunk 4
FLEET_SESSIONS, FLEET_FRAMES, FLEET_CHUNK = 8, 24, 4
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


def load_vocab(name: str):
    """A vocabulary the JAX references ran with (scripts/make_loop_reference.py)."""
    from orbslam3_tpu_torch.loop import vocab as vb

    return vb.load_npz(os.path.join(ROOT, "orbslam3_tpu_torch", "data", f"vocab_{name}.npz"))


def loop_slam(cam, cfg, vocab, chunk=CHUNK, service_every=8, loop_cfg=None, device=None):
    """FusedSlam with a loop closer, warmed up as bench.py builds it.
    Returns (slam, warmup seconds)."""
    import torch

    from orbslam3_tpu_torch.models.fused import FusedSlam

    t0 = time.perf_counter()
    kw = dict(device=device) if device else {}
    slam = FusedSlam(cam, cfg, vocabulary=vocab, chunk=chunk, service_every=service_every,
                     warmup=True, loop_cfg=loop_cfg, **kw)
    if slam.device.type == "cuda":
        torch.cuda.synchronize()
    return slam, time.perf_counter() - t0


def gba_text(gba) -> str:
    """A correction's global BA: the points it held, the table's slots,
    tiles and iterations."""
    if gba is None:
        return "none"
    return (f"{int(gba['points'])} points in a table of {gba['slots']} slots ({gba['tiles']} "
            f"tiles), {gba['iters']} iterations")


def loop_service_lines(path: str, slam, card: str):
    """The loop closer's service by stage, in host wall time (the device's
    work lands in the stage that next reads): per keyframe serviced
    (detection, BoW-only, packet and verification reads, verification) and
    per correction (each stage of loop_correct)."""
    rep = slam.timing_report()
    n_kf = sum(rep.get(k, {"calls": 0})["calls"] for k in ("loop_service", "loop_correct"))
    parts = [f"{k} {rep[k]['mean_ms']:.2f} ms x {rep[k]['calls']}" for k in
             ("loop_service", "loop_correct", "loop.detect", "loop.bow_only", "loop.packet_read",
              "loop.verify", "loop.verify_read") if k in rep]
    log(f"{path}: loop service over {n_kf} keyframe services (host wall, ms a call x calls): "
        + ", ".join(parts) + f"  [{card}]")
    for i, rec in enumerate(slam.loop_closer.corrections):
        stages = ", ".join(f"{k[:-3]} {v:.1f}" for k, v in rec.items() if k.endswith("_ms"))
        vi = {None: "not run", True: "accepted", False: "rejected"}[rec["vi_refine"]]
        log(f"{path}: correction {i + 1}: keyframe {rec['kf_id']} (t={rec['kf_time']:.2f} s) "
            f"against {rec['cand']} (t={rec['cand_time']:.2f} s) "
            f"({'merge' if rec['merge'] else 'loop'}{', relocalization' if rec['reloc'] else ''}), "
            f"seam {rec['seam_m']:.3f} m, {rec['host_reads']} host reads, global BA "
            f"{gba_text(rec['gba'])}, vi_refine {vi}; host wall ms: {stages}  [{card}]")


def reloc_rounds(modes, service_every: int, n_rounds: int) -> set:
    """The service rounds in relocalization mode that the JAX host's rule
    (orbslam3_tpu/models/fused.py:1098-1106) gives for a run's per-frame
    tracker modes: round r acts on the mode snapshotted at round r - 1,
    after frame service_every * (r - 1) - 1, and a RECENTLY_LOST snapshot at
    round s puts rounds s .. s + 3 in relocalization mode."""
    from orbslam3_tpu_torch.models.fused import MODE_RECENTLY_LOST

    out = set()
    for s in range(2, n_rounds + 1):
        f = service_every * (s - 1) - 1
        if f < len(modes) and modes[f] == MODE_RECENTLY_LOST:
            out.update(r for r in range(s, s + 4) if r <= n_rounds)
    return out


def mirror_recorder(rounds: dict):
    """A run_slice hook: after every service round, whether the port's
    host mirrors put it in relocalization mode."""
    def record(_i, slam):
        if slam._service_round:
            rounds[slam._service_round] = slam._service_round < slam._reloc_until
    return record


def hold_mirrors(path: str, slam, rounds: dict) -> set:
    """The port's relocalization-mode rounds, read from its mirrors, must
    be those the JAX rule gives for its own per-frame modes."""
    mirrored = {r for r, on in rounds.items() if on}
    rule = reloc_rounds(slam.modes(), slam.service_every, max(rounds))
    if mirrored != rule:
        raise AssertionError(f"{path}: relocalization-mode rounds {sorted(mirrored)} from the "
                             f"host mirrors, {sorted(rule)} by the JAX rule over the run's modes")
    return mirrored


def loop_bench_run(world, times, frames, imu, first, first_fps, card, ref):
    """(a) The main path's frames with the loop closer as bench.py's
    fps_with_loop_closing runs it (chunk=CHUNK, service_every=8, warmup,
    the world's vocabulary): one launch a chunk, no correction and the IMU
    at the JAX reference's frame, raw poses within 1 mm of the chunk=1 run
    `first` (equality bit for bit is printed)."""
    import numpy as np

    from orbslam3_tpu_torch.models.fused import BENCH_CFG

    n = len(times)
    slam, warm_s = loop_slam(world.cam, BENCH_CFG, load_vocab("bench"))
    (_, fps, syncs, _), launches = counted_run("stereo-inertial, loop closing", world, times,
                                               frames, imu, BENCH_CFG, chunk=CHUNK, slam=slam)
    a, b = slam.frame_outputs(), first.frame_outputs()
    same = bool(np.array_equal(a.p, b.p) and np.array_equal(a.q, b.q))
    d = np.linalg.norm(a.p - b.p, axis=1)
    moved = np.flatnonzero((a.p != b.p).any(axis=1) | (a.q != b.q).any(axis=1))
    st = slam.loop_closer.stats
    log(f"loop closing, bench world (chunk={CHUNK}, service_every=8, warmup {warm_s:.2f} s): {n} "
        f"frames in {len(slam.outs)} dispatches, fast_nms launches {launches} "
        f"({launches / len(slam.outs):g} a chunk), IMU initialized at frame {slam.imu_init_frame} "
        f"(chunk=1: {first.imu_init_frame}, JAX {ref['imu_init_frame']}), {st} (JAX "
        f"{ref['stats']}), raw poses equal chunk=1's bit for bit: {same}"
        + ("" if same else f" (first frame that differs {moved[0]}, largest position difference "
                           f"{d.max():.3e} m at frame {int(d.argmax())})"))
    log(f"loop closing, bench world: {fps:.3f} frames/s after {WARMUP} warm-up frames (chunk=1 "
        f"without loop closing in this process: {first_fps:.3f}), host syncs/frame {syncs:.3f}, "
        f"n_kf {int(slam.map.n_kf)} (chunk=1: {int(first.map.n_kf)}, JAX {ref['n_kf']})  [{card}]")
    log(f"loop closing, bench world timing_report (host wall, ms/call): "
        + json.dumps(slam.timing_report()))
    stage_table(f"stereo-inertial with loop closing, chunk={CHUNK}", slam.timing_report(), card)
    loop_service_lines("loop closing, bench world", slam, card)
    if launches != n // CHUNK or len(slam.outs) != n // CHUNK:
        raise AssertionError(f"loop closing, bench world: {launches} launches in "
                             f"{len(slam.outs)} dispatches over {n} frames")
    if slam.imu_init_frame != ref["imu_init_frame"] or not slam.imu_initialized:
        raise AssertionError(f"loop closing, bench world: IMU initialized at frame "
                             f"{slam.imu_init_frame}, the JAX reference at {ref['imu_init_frame']}")
    if st.corrected != ref["stats"]["corrected"]:
        raise AssertionError(f"loop closing, bench world: {st.corrected} corrections, the JAX "
                             f"reference {ref['stats']['corrected']}")
    if not d.max() <= 1e-3:
        raise AssertionError(f"loop closing, bench world: raw poses leave chunk=1's by {d.max()} m "
                             f"(> 1 mm)")
    return launches, fps, warm_s


def render_revisit_world() -> dict:
    """Start rendering the revisit world in a background thread (its worker
    processes are spawned and leave two cores to the main process); the
    result is taken with `take_rendered`."""
    import threading

    from orbslam3_tpu_torch.io.synthetic import SyntheticConfig, SyntheticWorld

    box = {}

    def work():
        try:
            t0 = time.perf_counter()
            world = SyntheticWorld(SyntheticConfig(**REVISIT_WORLD, **HARD_WORLD))
            times = world.frame_times()[:REVISIT_FRAMES]
            frames = world.render_sequence(times, blackout=REVISIT_BLACKOUT,
                                           workers=max((os.cpu_count() or 2) - 2, 1))
            box.update(world=world, times=times, frames=frames, seconds=time.perf_counter() - t0)
        except BaseException as e:  # handed to the main thread by take_rendered
            box["error"] = e

    box["thread"] = threading.Thread(target=work, daemon=True)
    box["thread"].start()
    return box


def take_rendered(box: dict):
    """(world, times, frames) of a render_revisit_world, waiting for it."""
    t0 = time.perf_counter()
    box["thread"].join()
    if "error" in box:
        raise box["error"]
    log(f"revisit world: {len(box['times'])} frames {box['world'].cfg.width}x"
        f"{box['world'].cfg.height} rendered in {box['seconds']:.1f} s in the background during "
        f"phases 5b-5c (waited {time.perf_counter() - t0:.1f} s for it here)")
    return box["world"], box["times"], box["frames"]


def revisit_run(card, ref, rendered):
    """(b) The revisit world under BENCH_CFG with its vocabulary, as
    bench.py's revisit pass runs it, over its first REVISIT_FRAMES frames,
    held to the JAX reference of the same run over those frames. Returns (slam, record, the first correction's recorded input and
    output, launches)."""
    import numpy as np
    import torch

    from orbslam3_tpu_torch.eval.metrics import ate_rmse
    from orbslam3_tpu_torch.geometry.sim3 import Sim3
    from orbslam3_tpu_torch.interop import to_device
    from orbslam3_tpu_torch.models.fused import BENCH_CFG, MODE_OK

    world, times, frames = take_rendered(rendered)
    imu = [world.imu_window(times[i - 1] if i > 0 else t, t) for i, t in enumerate(times)]
    slam, warm_s = loop_slam(world.cam, BENCH_CFG, load_vocab("revisit"))
    cl = slam.loop_closer
    # the first correction's input and output, which phase (d) runs again
    first = {}
    correct = cl._correct

    def recorded(st, kf_id, cand, S_rel, cam, **kw):
        if not first:
            first.update(st=to_device(st, "cpu"), kf_id=kf_id, cand=cand,
                         S=Sim3(*[a.clone() for a in S_rel]), kw=kw,
                         edges=list(cl._loop_edges),
                         gravity=None if cl.gravity_w is None else cl.gravity_w.clone())
        out = correct(st, kf_id, cand, S_rel, cam, **kw)
        if "out" not in first:
            first["out"] = to_device(out, "cpu")
        return out

    cl._correct = recorded
    rounds = {}
    torch.cuda.reset_peak_memory_stats()
    (_, fps, syncs, _), launches = counted_run("revisit", world, times, frames, imu, BENCH_CFG,
                                               chunk=CHUNK, slam=slam,
                                               hook=mirror_recorder(rounds))
    peak = torch.cuda.max_memory_allocated()
    cl._correct = correct
    n = len(times)
    gt_p, _ = world.gt_trajectory()
    _, ps, _ = slam.trajectory_arrays()
    _, ps_raw, _ = slam.trajectory_arrays(corrected=False)
    if ps.shape != (n, 3) or not np.all(np.isfinite(ps)):
        raise AssertionError(f"revisit: trajectory not finite or of shape {ps.shape}")
    st = cl.stats
    corr = cl.corrections
    rec = dict(ate=float(ate_rmse(ps, gt_p[:n])), ate_raw=float(ate_rmse(ps_raw, gt_p[:n])),
               ok_frac=float((slam.modes() == MODE_OK).mean()), stats=st._asdict(),
               n_kf=int(slam.map.n_kf), imu_init_frame=slam.imu_init_frame, fps=fps,
               syncs=syncs, peak_mib=peak / 2**20, warmup_s=warm_s,
               corrections=[dict(c) for c in corr])
    odo = ref["odometry"]
    log(f"revisit: {fps:.3f} frames/s after {WARMUP} warm-up frames, host syncs/frame "
        f"{syncs:.3f}, warmup {warm_s:.2f} s, fast_nms launches {launches}, peak device memory "
        f"{peak / 2**20:.1f} MiB (after its global BAs), IMU initialized at frame "
        f"{slam.imu_init_frame} (JAX {ref['imu_init_frame']}), n_kf {rec['n_kf']} (JAX "
        f"{ref['n_kf']}), compactions {slam.compactions} (JAX {ref['compactions']})  [{card}]")
    log(f"revisit: over {n} frames ATE with loop closing {rec['ate']:.4f} m, raw "
        f"{rec['ate_raw']:.4f} m, ok_frac {rec['ok_frac']:.4f}, {st} (JAX over its "
        f"{ref['n_frames']} frames: ATE {ref['ate_m']:.4f}, raw {ref['ate_raw_m']:.4f}, odometry "
        f"alone {odo['ate_m']:.4f}, ok_frac {ref['ok_frac']:.4f}, {ref['stats']})")
    for i, c in enumerate(ref["corrections"]):
        log(f"revisit, JAX correction {i + 1}: frame {c['frame']}, round {c['service_round']}, "
            f"keyframe {c['kf_id']} (t={c['kf_time']:.2f} s) against {c['cand']} "
            f"(t={c['cand_time']:.2f} s), {'merge' if c['merge'] else 'loop'}"
            f"{', relocalization' if c['reloc'] else ''}, seam {c['seam_m']:.3f} m, global BA "
            f"{c['gba']}, vi_refine {c['vi_refine']}")
    log("revisit timing_report (host wall, ms/call): " + json.dumps(slam.timing_report()))
    stage_table("revisit", slam.timing_report(), card)
    loop_service_lines("revisit", slam, card)
    rec["reloc_witness"] = reloc_witness("revisit", slam, rounds, ref)
    if launches != n // CHUNK:
        raise AssertionError(f"revisit: {launches} launches over {n} frames")
    ref_corr = [c for c in ref["corrections"] if c["frame"] < n]
    ref_n = len(ref_corr)
    if st.corrected < 1 or abs(st.corrected - ref_n) > 1:
        raise AssertionError(f"revisit: {st.corrected} corrections over {n} frames, the JAX "
                             f"reference {ref_n}")
    r0 = ref["corrections"][0]
    log(f"revisit: the first correction's query keyframe at t={corr[0]['kf_time']:.2f} s "
        f"({corr[0]['kf_time'] - r0['kf_time']:+.2f} s from the reference's), its candidate at "
        f"t={corr[0]['cand_time']:.2f} s ({corr[0]['cand_time'] - r0['cand_time']:+.2f} s); "
        f"relocalizations {st.relocalized} (JAX {ref['stats']['relocalized']}, not held: above)")
    if not (abs(corr[0]["kf_time"] - r0["kf_time"]) <= 1.0
            and abs(corr[0]["cand_time"] - r0["cand_time"]) <= 1.0):
        raise AssertionError(f"revisit: the first correction on keyframes at t="
                             f"{corr[0]['kf_time']:.2f} / {corr[0]['cand_time']:.2f} s, the "
                             f"reference's at {r0['kf_time']:.2f} / {r0['cand_time']:.2f} s")
    merges = sum(c["merge"] for c in corr)
    ref_merges = sum(c["merge"] for c in ref_corr)
    if merges != ref_merges:
        raise AssertionError(f"revisit: {merges} merges, the reference {ref_merges}")
    return slam, rec, first, launches


def reloc_witness(path: str, slam, rounds: dict, ref: dict) -> dict:
    """Where the port's relocalization mode departs from the reference's.
    The port's rounds in that mode, read from its host mirrors, are held to
    the JAX rule over its own per-frame tracker modes (reloc_rounds); the
    reference's rounds (from its service record) are printed beside them,
    with the port's tracker mode at each snapshot that could have put a
    round of the reference's alone in that mode. When the mirrors hold, a
    difference in rounds is a difference in the tracker's modes."""
    port = hold_mirrors(path, slam, rounds)
    jax_rounds = {e[1] for e in ref["services"] if e[0] == "kf" and e[4]}
    kf_rounds = {e[1] for e in ref["services"] if e[0] == "kf"}
    only_jax = sorted(jax_rounds - port)
    only_port = sorted((port & kf_rounds) - jax_rounds)
    modes = slam.modes()
    every = slam.service_every
    snaps = sorted({s for r in only_jax for s in range(max(r - 3, 2), r + 1)})
    at = {every * (s - 1) - 1: int(modes[every * (s - 1) - 1]) for s in snaps
          if every * (s - 1) - 1 < len(modes)}
    log(f"{path}: relocalization-mode rounds from the port's mirrors equal the JAX rule over "
        f"its per-frame modes ({len(port)} rounds); rounds in that mode, among those that "
        f"serviced a keyframe: only the reference's {only_jax}, only the port's {only_port}; the "
        f"port's tracker mode (2 = recently lost) at the snapshot frames that could have put the "
        f"reference's alone there: {at}")
    return dict(port_rounds=sorted(port), jax_rounds=sorted(jax_rounds), only_jax=only_jax,
                only_port=only_port, port_modes_at_snapshots=at)


def blackout_world_run(path, world_kw, blackout, vocab, loop_over, card, **cfg_kw):
    """A small world of tests/test_fused_loop.py (384x256, 8 s at 10 Hz,
    visual only) with a camera blackout, under that test's configuration
    and LoopConfig overrides, chunk 1, service_every=2. Returns (slam,
    times, post-blackout ATE, the keyframes' maps, launches, frames/s,
    relocalization-mode rounds from the mirrors)."""
    import numpy as np

    from orbslam3_tpu_torch.eval.metrics import ate_rmse
    from orbslam3_tpu_torch.frontend.orb import OrbConfig
    from orbslam3_tpu_torch.io.synthetic import SyntheticConfig, SyntheticWorld
    from orbslam3_tpu_torch.loop.closer import LoopConfig
    from orbslam3_tpu_torch.map.slam_map import MapCapacity
    from orbslam3_tpu_torch.models.slam import SlamConfig
    from orbslam3_tpu_torch.models.tracker import TrackConfig

    world = SyntheticWorld(SyntheticConfig(**world_kw))
    times = world.frame_times()
    blank = np.full((world.cfg.height, world.cfg.width), 127, np.uint8)
    frames = [(blank, blank) if blackout[0] <= t < blackout[1]
              else world.render_frame(t) for t in times]
    imu = [(np.zeros((0, 3)), np.zeros((0, 3)), np.zeros(0))] * len(times)
    cfg = SlamConfig(orb=OrbConfig(n_features=384, n_levels=4),
                     cap=MapCapacity(max_kf=96, n_feat=384, max_mp=8192, max_obs=8),
                     track=TrackConfig(p_local=2048), ba_points=1024, use_imu=False,
                     kf_max_frames=2, min_kfs_keep_map=5, **cfg_kw)
    slam, _ = loop_slam(world.cam, cfg, vocab, chunk=1, service_every=2,
                        loop_cfg=LoopConfig(**loop_over))
    rounds = {}
    (_, fps, _, _), launches = counted_run(path, world, times, frames, imu, cfg, slam=slam,
                                           hook=mirror_recorder(rounds))
    _, ps, _ = slam.trajectory_arrays()
    gt_p, _ = world.gt_trajectory()
    post = times > blackout[1] + 2.0
    ate_post = float(ate_rmse(ps[post], gt_p[post]))
    kv = slam.map.kf_valid.cpu().numpy()
    maps = set(slam.map.kf_map_id.cpu().numpy()[kv].tolist())
    log(f"{path}: {len(times)} frames, {slam.loop_closer.stats}, keyframes' maps {sorted(maps)}, "
        f"next_map_id {int(slam.map.next_map_id)}, post-blackout ATE {ate_post:.4f} m, "
        f"{fps:.3f} frames/s, fast_nms launches {launches}  [{card}]")
    loop_service_lines(path, slam, card)
    return slam, times, ate_post, maps, launches, fps, rounds


def merge_run(card):
    """(c) The blackout-then-merge world of tests/test_fused_loop.py, at its
    own size: a merge into map 0 and post-merge ATE < 0.15 m."""
    slam, _, ate_post, maps, launches, _, _ = blackout_world_run(
        "merge world", MERGE_WORLD, MERGE_BLACKOUT, load_vocab("merge"), MERGE_LOOP, card,
        lost_timeout=0.3)
    st = slam.loop_closer.stats
    if st.corrected < 1 or maps != {0} or not ate_post < 0.15:
        raise AssertionError(f"merge world: corrected {st.corrected}, maps {maps}, post-merge ATE "
                             f"{ate_post:.4f} m (needs >= 1, {{0}}, < 0.15)")
    return launches, ate_post


def reloc_run(card, ref) -> dict:
    """(e) The relocalization world of tests/test_fused_loop.py at its own
    size (fast motion, a 2 s blackout, lost_timeout=30 s: the atlas never
    spawns a map, lost keyframes are inserted), held to the test's bars and
    to the JAX run of data/loop_reference.json ("reloc"): no new map, at
    least one relocalization, the first one on the reference's keyframe
    pair, OK share after the blackout > 0.9, post-blackout ATE < 0.15 m;
    the port's relocalization-mode rounds follow its modes by the JAX rule,
    and the rule over the reference's own modes gives the reference's."""
    import numpy as np

    from orbslam3_tpu_torch.models.fused import MODE_OK

    slam, times, ate_post, maps, launches, fps, rounds = blackout_world_run(
        "relocalization world", RELOC_WORLD, RELOC_BLACKOUT, load_vocab("reloc"), RELOC_LOOP,
        card, lost_timeout=30.0, insert_kfs_lost_visual=True)
    st = slam.loop_closer.stats
    post = times > RELOC_BLACKOUT[1] + 2.0
    ok_post = float((slam.modes()[post] == MODE_OK).mean())
    port = hold_mirrors("relocalization world", slam, rounds)
    ref_rule = reloc_rounds(np.asarray(ref["modes"]), 2, max(e[1] for e in ref["services"]
                                                             if e[0] == "kf"))
    ref_on = {e[1] for e in ref["services"] if e[0] == "kf" and e[4]}
    ref_kf = {e[1] for e in ref["services"] if e[0] == "kf"}
    mine = [c for c in slam.loop_closer.corrections if c["reloc"]]
    want = next(c for c in ref["corrections"] if c["reloc"])
    log(f"relocalization world: {st} (JAX {ref['stats']}); first relocalization keyframe "
        + (f"{mine[0]['kf_id']} against {mine[0]['cand']}, seam {mine[0]['seam_m']:.3f} m"
           if mine else "none")
        + f" (JAX {want['kf_id']} against {want['cand']}, seam {want['seam_m']:.3f} m); OK share "
        f"after the blackout {ok_post:.4f}; relocalization-mode rounds {sorted(port)} (JAX "
        f"{sorted(ref_on)}); the JAX rule over the reference's own modes gives its rounds: "
        f"{ref_rule & ref_kf == ref_on}  [{card}]")
    if ref_rule & ref_kf != ref_on:
        raise AssertionError("reloc_rounds over the reference's modes does not give its rounds")
    if int(slam.map.next_map_id) != 1 or maps != {0}:
        raise AssertionError(f"relocalization world: next_map_id {int(slam.map.next_map_id)}, "
                             f"maps {maps} (a new map was spawned)")
    if st.relocalized < 1 or (mine[0]["kf_id"], mine[0]["cand"]) != (want["kf_id"], want["cand"]):
        raise AssertionError(f"relocalization world: {st.relocalized} relocalizations, the first "
                             f"on {[(c['kf_id'], c['cand']) for c in mine][:1]}, the reference's "
                             f"on ({want['kf_id']}, {want['cand']})")
    if not (ok_post > 0.9 and ate_post < 0.15):
        raise AssertionError(f"relocalization world: OK share {ok_post:.4f} (> 0.9), ATE "
                             f"{ate_post:.4f} m (< 0.15)")
    return dict(stats=st._asdict(), launches=launches, fps=fps, ate_post_m=ate_post,
                ok_post=ok_post, first_reloc=[mine[0]["kf_id"], mine[0]["cand"]],
                seam_m=mine[0]["seam_m"])


def loop_reproducibility(first, vocab, cfg, cam, card) -> dict:
    """(d) The revisit run's first correction again, twice, on its recorded
    input state on the card: poses and points equal bit for bit to the
    run's; the verification of its query (or of the newest keyframe with
    map points, where the query's row has none) against its candidate and
    the three keyframes sharing the most points with it, on the card with
    fed samples against the CPU (counts exact, the Sim3 and seam of the
    candidates past the inlier gate within 1e-5); card times of the exhaustive detection
    product at the full row count and of one global-BA step."""
    import torch

    from orbslam3_tpu_torch.interop import to_device
    from orbslam3_tpu_torch.loop import closer as lc
    from orbslam3_tpu_torch.loop.sim3 import draw_samples
    from orbslam3_tpu_torch.parallel.distributed_ba import global_ba, make_point_table

    class SyncedCloser(lc.LoopCloser):
        """The closer with the device synchronized at the end of each stage,
        so that a stage's time holds its device work (a measurement only)."""

        def _clock(self, name=None, t0=0.0):
            torch.cuda.synchronize()
            return super()._clock(name, t0)

    dev = torch.device("cuda")
    st = to_device(first["st"], dev)
    outs, recs = [], []
    for kind in (lc.LoopCloser, SyncedCloser):
        closer = kind(vocab.to(dev), cfg)
        closer._loop_edges = list(first["edges"])
        closer.gravity_w = first["gravity"]
        outs.append(to_device(closer._correct(st, first["kf_id"], first["cand"], first["S"], cam,
                                              **first["kw"]), "cpu"))
        recs.append(closer.corrections[-1])
    names = ("kf_q", "kf_p", "kf_v", "mp_pos")
    same = [all(torch.equal(getattr(o, k), getattr(first["out"], k)) for k in names) for o in outs]
    log(f"reproducible: the revisit run's first correction (keyframe {first['kf_id']} against "
        f"{first['cand']}, pose graph, seam fusion, global BA, vi_refine) run twice more on its "
        f"recorded input: poses and points equal to the run's bit for bit: {same}  [{card}]")
    if not all(same):
        raise AssertionError("two runs of _correct on one state gave other poses than the run's")
    stage_ms = {k[:-3]: v for k, v in recs[1].items() if k.endswith("_ms")}
    log(f"the same correction by stage, the device synchronized at each stage's end (ms): "
        + ", ".join(f"{k} {v:.1f}" for k, v in stage_ms.items())
        + f"; global BA {gba_text(recs[1]['gba'])}; {recs[1]['host_reads']} host reads  [{card}]")

    # the query against the correction's candidate and the three live
    # keyframes that share the most map points with it (well-conditioned
    # Sim3s); where the query's row holds no map point in the recorded state,
    # the newest live keyframe that holds some stands in for it
    kf_mp, live = first["st"].kf_mp.cpu().numpy(), first["st"].kf_valid.cpu().numpy()
    pts = [set(r[r >= 0].tolist()) if ok else set() for r, ok in zip(kf_mp, live)]
    kf = first["kf_id"]
    if not pts[kf]:
        kf = max(k for k in range(len(pts)) if pts[k])
    shared = sorted((-len(pts[kf] & pts[k]), k) for k in range(len(pts))
                    if pts[k] and k not in (kf, first["cand"]))
    cands = [first["cand"]] + [k for _, k in shared[:3]]
    samples = {}

    def fed(m):
        """The same draws for both devices, made on the CPU from the card's
        RANSAC masks."""
        if "s" not in samples:
            samples["s"] = torch.stack([draw_samples(m[c].cpu(), lc.N_HYP,
                                                     torch.Generator().manual_seed(c))
                                        for c in range(m.shape[0])])
        return samples["s"].to(m.device)

    got = lc._verify_program(st, kf, cands, cam, cfg.match_hamming_max, cfg.sim3_chi2,
                             cfg.reproj_radius, samples=fed)
    want = lc._verify_program(first["st"], kf, cands, cam.to("cpu"), cfg.match_hamming_max,
                              cfg.sim3_chi2, cfg.reproj_radius, samples=fed)
    for name, a, b in zip(("nm", "ninl", "nrp"), got[:3], want[:3]):
        if not torch.equal(a.cpu(), b):
            raise AssertionError(f"verification on the card: {name} {a.tolist()} != CPU "
                                 f"{b.tolist()}")
    # the Sim3 and seam of every candidate that passes the inlier gate (a
    # failed one's Sim3, from a handful of inliers, is never used)
    passed = want[1] >= cfg.min_sim3_inliers
    err = max((float((a.cpu() - b)[passed].abs().max())
               for a, b in zip((got[3], *got[4]), (want[3], *want[4]))),
              default=float("inf")) if bool(passed.any()) else float("inf")
    log(f"verification of keyframe {kf} against {cands} on the card with fed samples: nm "
        f"{got[0].tolist()}, ninl {got[1].tolist()}, nrp {got[2].tolist()} equal to the CPU's; "
        f"the Sim3 and seam of the {int(passed.sum())} past the inlier gate within {err:.1e} of "
        f"the CPU's  [{card}]")
    if not (bool(passed.any()) and err <= 1e-5):
        raise AssertionError(f"verification on the card: Sim3 / seam leave the CPU's by {err}")

    # card times of the hot operations: the exhaustive match counts over all
    # keyframe rows, and one GN step of global BA at the full point budget
    K = st.kf_valid.shape[0]
    det_ms = cuda_ms(lambda: lc._mutual_counts(st.kf_desc[kf], st.kf_feat_valid[kf],
                                               st.kf_desc, st.kf_feat_valid,
                                               cfg.match_hamming_max), 5)
    P = -(-min(cfg.gba_max_points, st.mp_pos.shape[0]) // cfg.gba_tile) * cfg.gba_tile
    pts, _ = make_point_table(st, P, cfg.gba_obs)
    opt = st.kf_valid & (torch.arange(K, device=dev) != first["cand"])
    gba_ms = cuda_ms(lambda: global_ba(pts, st.kf_q, st.kf_p, opt, cam, iters=1,
                                       tile=cfg.gba_tile), 2)
    n_pts = int(pts.pt_valid.sum())
    log(f"hot operations on the card (CUDA events): exhaustive match counts of one keyframe "
        f"against {K} rows {det_ms:.2f} ms; one global-BA step over {n_pts} points in "
        f"{P // cfg.gba_tile} tiles of {cfg.gba_tile}, {K} keyframes {gba_ms:.1f} ms  [{card}]")
    return dict(detect_ms=det_ms, gba_step_ms=gba_ms, gba_points=n_pts, correct_stage_ms=stage_ms)


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


def front_leaves(left, right, cam, card):
    """The front end's and the IMU's one-call leaves on the card against
    the same calls on the CPU, on one 752x480 frame: detect_orb (one image,
    one launch at B=1) bit for bit against the left of detect_orb_pair on
    the card; hamming_matrix_popcount and hamming_pairs exact and equal to
    hamming_matrix; orientations and descriptors (angles 1e-4 rad: the
    moment product sums in the card's order; descriptors on the card's
    angles exact); subpixel_refine 1e-6; process_stereo's
    depth flags exact; integrate and information_9 1e-5 / 1e-4 relative."""
    import numpy as np
    import torch

    from orbslam3_tpu_torch.frontend import orb, stereo
    from orbslam3_tpu_torch.imu import preintegration as pre
    from orbslam3_tpu_torch.ops import brief, fast, hamming, pyramid
    from orbslam3_tpu_torch.ops.fast_cuda import fast_nms_levels

    dev = torch.device(DEVICE)
    L, R = torch.from_numpy(left).to(dev), torch.from_numpy(right).to(dev)
    one = orb.detect_orb(L)
    pair_l, pair_r = orb.detect_orb_pair(L, R)
    for f in orb.Features._fields:
        if not torch.equal(getattr(one, f), getattr(pair_l, f)):
            raise AssertionError(f"leaves: detect_orb's {f} differs from detect_orb_pair's left "
                                 "on the card")
    a, b = pair_l.desc, pair_r.desc
    ham = hamming.hamming_matrix_popcount(a, b)
    if not (torch.equal(ham, hamming.hamming_matrix(a, b))
            and torch.equal(ham.cpu(), hamming.hamming_matrix_popcount(a.cpu(), b.cpu()))
            and torch.equal(hamming.hamming_pairs(a, b).cpu(),
                            hamming.hamming_pairs(a.cpu(), b.cpu()))):
        raise AssertionError("leaves: the popcount Hamming distances differ")
    lv0 = (one.octave == 0) & one.valid
    ys, xs = one.uv[lv0, 1].round().int(), one.uv[lv0, 0].round().int()
    ang = brief.orientations(L, ys, xs)
    ang_c = brief.orientations(L.cpu(), ys.cpu(), xs.cpu())
    err_ang = float((ang.cpu() - ang_c).abs().max())
    blurred = pyramid.blur(L[None])[0]
    desc = brief.descriptors(blurred, ys, xs, ang)
    desc_c = brief.descriptors(blurred.cpu(), ys.cpu(), xs.cpu(), ang.cpu())
    score = fast_nms_levels([L[None]], 20.0, 7.0)[0][0]
    dy, dx = fast.subpixel_refine(score, ys, xs)
    dy_c, dx_c = fast.subpixel_refine(score.cpu(), ys.cpu(), xs.cpu())
    err_sub = float(max((dy.cpu() - dy_c).abs().max(), (dx.cpu() - dx_c).abs().max()))
    sf = stereo.process_stereo(L, R, cam)
    sf_c = stereo.process_stereo(L.cpu(), R.cpu(), cam.to("cpu"))
    depth_same = float((sf.has_depth.cpu() == sf_c.has_depth).float().mean())
    rng = np.random.default_rng(0)
    g = rng.normal(0, 0.5, (24, 3)).astype(np.float32)
    acc = (rng.normal(0, 1.0, (24, 3)) + [0, 0, 9.81]).astype(np.float32)
    win = [torch.from_numpy(x) for x in pre.pad_imu_window(g, acc, np.full(24, 0.005, np.float32),
                                                             32)]
    z3 = torch.zeros(3)
    st_c = pre.integrate(*win, z3, z3)
    st = pre.integrate(*[w.to(dev) for w in win], z3.to(dev), z3.to(dev))
    err_imu = max(float(((x.cpu() - y).abs().max() / max(float(y.abs().max()), 1e-30)))
                  for x, y in zip(st, st_c))
    info, info_c = pre.information_9(st), pre.information_9(st_c)
    err_info = float((info.cpu() - info_c).abs().max() / info_c.abs().max())
    if not (err_ang <= 1e-4 and torch.equal(desc.cpu(), desc_c) and err_sub <= 1e-6
            and depth_same == 1.0 and err_imu <= 1e-5 and err_info <= 1e-4):
        raise AssertionError(f"leaves: card against CPU: angles {err_ang}, descriptors equal "
                             f"{torch.equal(desc.cpu(), desc_c)}, subpixel {err_sub}, depth flags "
                             f"equal {depth_same}, integrate {err_imu}, information_9 {err_info}")
    log(f"leaves: detect_orb on a 752x480 frame equals detect_orb_pair's left bit for bit on "
        f"the card ({int(one.valid.sum())} features); popcount Hamming exact; orientations "
        f"|card - CPU| {err_ang:.1e}, descriptors exact; subpixel_refine {err_sub:.1e}; "
        f"process_stereo depth flags equal ({int(sf.has_depth.sum())} with depth); integrate "
        f"{err_imu:.1e} relative, information_9 {err_info:.1e}  [{card}]")


# the EuRoC phase's device (a CPU rehearsal of it sets "cpu")
DEVICE = "cuda"


def sync():
    import torch

    if DEVICE == "cuda":
        torch.cuda.synchronize()


# scripts/make_euroc_reference.py's fixtures (ii) and (iii)
EUROC_FIXTURES = {"full": dict(duration=8.0, hz=20.0, scale=1.0, seed=7),
                  "loop": dict(duration=24.0, hz=10.0, scale=0.5, seed=7, revisit=True)}


def write_euroc_fixtures(workers: int = 2) -> dict:
    """Start writing fixtures (ii) and (iii) with the port's writer in a
    background thread (its rendering processes are spawned); the result is
    taken with `take_fixtures`."""
    import tempfile
    import threading

    from orbslam3_tpu_torch.io.euroc_fixture import write_fixture

    box = {"dir": tempfile.TemporaryDirectory()}

    def work():
        try:
            t0 = time.perf_counter()
            box["seqs"] = {name: os.path.dirname(write_fixture(
                os.path.join(box["dir"].name, name), workers=workers, **kw))
                for name, kw in EUROC_FIXTURES.items()}
            box["seconds"] = time.perf_counter() - t0
        except BaseException as e:  # handed to the main thread by take_fixtures
            box["error"] = e

    box["thread"] = threading.Thread(target=work, daemon=True)
    box["thread"].start()
    return box


def take_fixtures(box: dict) -> dict:
    """{name: sequence directory} of a write_euroc_fixtures, waiting for it."""
    t0 = time.perf_counter()
    box["thread"].join()
    if "error" in box:
        raise box["error"]
    log(f"EuRoC fixtures (ii) and (iii) written by the port's writer in {box['seconds']:.1f} s "
        f"in the background (waited {time.perf_counter() - t0:.1f} s for them here)")
    return box["seqs"]


def remap_check(seq: str, card: str) -> dict:
    """Rectification on the card over every stereo pair of a sequence,
    against the same remap on the CPU: the uint8 images the tracker gets
    (flips: pixels whose truncation differs), the floats, and the pixels
    within 1e-4 of an integer (where a flip could land); CUDA-event time of
    one stereo pair's remap, its bound, and grid_sample's time on the same
    pair (bilinear, zero padding, its own rounding)."""
    import numpy as np
    import torch

    from orbslam3_tpu_torch.io import native
    from orbslam3_tpu_torch.io.euroc import EurocDataset
    from orbslam3_tpu_torch.io.rectify import remap_bilinear
    from run_euroc_torch import rectified_camera

    ds = EurocDataset(seq)
    _, tables = rectified_camera(ds, DEVICE)
    tables_c = [t.cpu() for t in tables]
    flips, near, err = [], 0, 0.0
    for i in range(len(ds)):
        for img, (mx, my), (mx_c, my_c) in zip(ds.stereo_pair_u8(i), (tables[:2], tables[2:]),
                                                (tables_c[:2], tables_c[2:])):
            x = torch.from_numpy(img)
            out = remap_bilinear(x.to(DEVICE).float(), mx, my).cpu()
            out_c = remap_bilinear(x.float(), mx_c, my_c)
            err = max(err, float((out - out_c).abs().max()))
            near += int(((out_c - out_c.round()).abs() < 1e-4).sum())
            flips.append(int((out.to(torch.uint8) != out_c.to(torch.uint8)).sum()))
    left, right = [torch.from_numpy(x).to(DEVICE) for x in ds.stereo_pair_u8(len(ds) // 2)]

    def pair():
        remap_bilinear(left.float(), *tables[:2]).to(torch.uint8)
        remap_bilinear(right.float(), *tables[2:]).to(torch.uint8)

    ms = cuda_ms(pair, 100)
    h, w = left.shape
    grids = [torch.stack([mx / (w - 1) * 2 - 1, my / (h - 1) * 2 - 1], -1)[None]
             for mx, my in (tables[:2], tables[2:])]

    def library():
        for img, grid in zip((left, right), grids):
            torch.nn.functional.grid_sample(img.float()[None, None], grid, mode="bilinear",
                                            padding_mode="zeros", align_corners=True)

    lib_ms = cuda_ms(library, 100)
    # per image: the uint8 image and two float maps read, the uint8 image written
    nbytes = 2 * h * w * (1 + 8 + 1)
    rec = dict(frames=len(ds), flips_per_frame=float(np.sum(flips)) / len(ds),
               max_flips_image=max(flips), near_integer_pixels=near, max_abs_err=err, ms=ms,
               bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, library_ms=lib_ms,
               native_loader=native.available())
    log(f"EuRoC rectification: {rec['frames']} stereo pairs {w}x{h} remapped on the card and on "
        f"the CPU: {rec['flips_per_frame']:.3f} flipped uint8 pixels a frame (at most "
        f"{rec['max_flips_image']} in one image), {near} pixels within 1e-4 of an integer, "
        f"|card - CPU| {err:.1e} on 0..255; a stereo pair's remap {ms:.4f} ms by CUDA events "
        f"(bound {rec['bound_ms']:.4f} ms by bytes; grid_sample {lib_ms:.4f} ms)  [{card}]")
    if max(flips) > 0 or err > 1e-4:
        raise AssertionError(f"EuRoC rectification: the card's remap differs from the CPU's "
                             f"({max(flips)} flips in one image, {err} on the floats)")
    return rec


def euroc_run(path: str, tag: str, seq: str, profile: str, card: str, vocab_path=None,
              loop_cfg=None):
    """One sequence through scripts/run_euroc_torch.py::run on the card at
    chunk 1, with the launch counter set to 0 just before and read just
    after (one FAST/NMS launch a frame), frames/s after WARMUP frames and
    peak device memory. Returns its record."""
    import numpy as np
    import torch

    from orbslam3_tpu_torch.eval.metrics import ate_rmse
    from orbslam3_tpu_torch.io.euroc import EurocDataset
    from orbslam3_tpu_torch.models.fused import MODE_OK
    from orbslam3_tpu_torch.ops.fast_cuda import fast_nms
    from run_euroc_torch import run

    box = {}

    def on_frame(i, slam):
        box["slam"] = slam
        if i == WARMUP:
            sync()
            box["slam"].timing.clear()
            box["t0"] = time.perf_counter()
        if i == box.get("n"):
            sync()
            box["elapsed"] = time.perf_counter() - box["t0"]

    ds = EurocDataset(seq)
    box["n"] = len(ds)
    if DEVICE == "cuda":
        torch.cuda.reset_peak_memory_stats()
    fast_nms.launches = 0
    t0 = time.perf_counter()
    result = run(seq, os.path.join(os.path.dirname(seq), tag + "_out"), profile=profile,
                 vocab_path=vocab_path, loop_cfg=loop_cfg, device=DEVICE, hook=on_frame)
    wall = time.perf_counter() - t0
    launches = fast_nms.launches
    slam = box["slam"]
    _, ps, _ = slam.trajectory_arrays(corrected=True)
    _, ps_raw, _ = slam.trajectory_arrays(corrected=False)
    gt = ds.groundtruth_at_frames()
    n = len(ps)
    if ps.shape != (box["n"], 3) or not np.all(np.isfinite(ps)):
        raise AssertionError(f"{path}: trajectory not finite or of shape {ps.shape}")
    rec = dict(result, ate=float(ate_rmse(ps - ps[0], gt[:n])),
               ate_raw=float(ate_rmse(ps_raw - ps_raw[0], gt[:n])),
               ok_frac=float((slam.modes() == MODE_OK).mean()), imu_init_frame=slam.imu_init_frame,
               fps=(n - WARMUP) / box["elapsed"], wall_s=wall, launches=launches,
               peak_mib=(torch.cuda.max_memory_allocated() if DEVICE == "cuda" else 0) / 2**20)
    if slam.loop_closer is not None:
        rec["corrections"] = [{k: v for k, v in c.items() if not k.endswith("_ms")}
                              for c in slam.loop_closer.corrections]
    log(f"{path}: {n} frames {ds.cam0.resolution[0]}x{ds.cam0.resolution[1]}, {rec['fps']:.3f} "
        f"frames/s after {WARMUP} warm-up frames ({wall:.1f} s in all), fast_nms launches "
        f"{launches}, native loader {result['native_loader']}, peak device memory "
        f"{rec['peak_mib']:.1f} MiB, keyframes {result['keyframes']}, IMU initialized after frame "
        f"{slam.imu_init_frame}  [{card}]")
    log(f"{path} timing_report (host wall, ms/call): " + json.dumps(slam.timing_report()))
    stage_table(path, slam.timing_report(), card)
    if launches != LAUNCHES_PER_FRAME * n:
        raise AssertionError(f"{path}: fast_nms launched {launches} times over {n} frames")
    return rec


def check_euroc(path: str, rec: dict, ref: dict):
    """A EuRoC run against its JAX record: the band rule on the corrected
    and the raw trajectory, ok_frac, the IMU's frame."""
    log(f"accuracy, {path}: ATE {rec['ate']:.5f} m (JAX {ref['ate_corrected_m']:.5f}), raw "
        f"{rec['ate_raw']:.5f} m (JAX {ref['ate_raw_m']:.5f}), ok_frac {rec['ok_frac']:.4f} (JAX "
        f"{ref['ok_frac']:.4f}), keyframes {rec['keyframes']} (JAX {ref['keyframes']}), IMU "
        f"initialized after frame {rec['imu_init_frame']} (JAX {ref['imu_init_frame']})")
    if rec["imu_init_frame"] != ref["imu_init_frame"]:
        raise AssertionError(f"{path}: the IMU initialized after frame {rec['imu_init_frame']}, "
                             f"the reference after {ref['imu_init_frame']}")
    if rec["ok_frac"] < ref["ok_frac"] - 0.05:
        raise AssertionError(f"{path}: ok_frac {rec['ok_frac']:.4f} below the reference - 0.05")
    for mine, theirs in ((rec["ate"], ref["ate_corrected_m"]), (rec["ate_raw"], ref["ate_raw_m"])):
        if abs(mine - theirs) > band(theirs):
            raise AssertionError(f"{path}: ATE {mine:.4f} m outside the JAX band {theirs:.4f} +- "
                                 f"{band(theirs):.4f}")


def train_fixture_vocab(seq: str, out_path: str) -> dict:
    """tests/test_euroc_e2e.py::_train_fixture_vocab on the card with the
    port: detect_orb (one launch each) on every len // 12-th rectified left
    image, a k=10, 3-level vocabulary, written as DBoW2 text and loaded
    back (the load is held equal to the trained vocabulary)."""
    import numpy as np
    import torch

    from orbslam3_tpu_torch.frontend.orb import OrbConfig, detect_orb
    from orbslam3_tpu_torch.io.euroc import EurocDataset
    from orbslam3_tpu_torch.io.rectify import remap_bilinear
    from orbslam3_tpu_torch.loop import vocab as vb
    from orbslam3_tpu_torch.ops.fast_cuda import fast_nms
    from run_euroc_torch import rectified_camera

    t0 = time.perf_counter()
    ds = EurocDataset(seq)
    _, (mx0, my0, _, _) = rectified_camera(ds, DEVICE)
    oc = OrbConfig(n_features=384, n_levels=4)
    descs, docs = [], []
    launches0 = fast_nms.launches
    images = range(0, len(ds), max(len(ds) // 12, 1))
    for di, i in enumerate(images):
        left, _ = ds.stereo_pair_u8(i)
        f = detect_orb(remap_bilinear(torch.from_numpy(left).to(DEVICE).float(), mx0, my0), oc)
        d = f.desc[f.valid].cpu().numpy()
        if len(d):
            descs.append(d)
            docs.append(np.full(len(d), di))
    launches = fast_nms.launches - launches0
    voc = vb.train_vocabulary(np.concatenate(descs), k=10, levels=3, doc_ids=np.concatenate(docs))
    vb.save_dbow2_text(voc, out_path)
    back = vb.load_dbow2_text(out_path)
    same = (len(back.level_desc) == len(voc.level_desc)
            and all(torch.equal(torch.as_tensor(a), torch.as_tensor(b))
                    for a, b in zip(voc.level_desc, back.level_desc))
            and torch.allclose(torch.as_tensor(voc.idf), torch.as_tensor(back.idf), rtol=1e-6))
    if not same:
        raise AssertionError("the DBoW2 text round trip changed the vocabulary")
    log(f"EuRoC loop fixture: the port's vocabulary (k=10, 3 levels) from {len(images)} "
        f"rectified left images ({len(descs)} with features), {sum(len(d) for d in descs)} "
        f"descriptors, detect_orb launches {launches}, "
        f"through DBoW2 text ({os.path.getsize(out_path)} bytes) in "
        f"{time.perf_counter() - t0:.1f} s")
    if launches != LAUNCHES_PER_FRAME * len(images):
        raise AssertionError(f"detect_orb launched the kernel {launches} times for "
                             f"{len(images)} images")
    return dict(images=len(images), launches=launches)


def euroc_loop_jax_vocab(seq: str, ref: dict, card: str) -> dict:
    """Run (iii) with the JAX-trained vocabulary (data/euroc_loop_vocab.txt):
    corrections within 1 of the record's, the first pair's keyframe times
    within 1 s of the record's."""
    from orbslam3_tpu_torch.loop.closer import LoopConfig

    loop = euroc_run("EuRoC (iii) loop, JAX vocabulary", "loop_jax", seq, "small", card,
                     vocab_path=os.path.join(ROOT, ref["vocabulary"]),
                     loop_cfg=LoopConfig(bow_min_score_gate=False))
    got, want = loop["corrections"], ref["corrections"]
    for i, c in enumerate(want):
        log(f"EuRoC (iii), JAX correction {i + 1}: frame {c['frame']}, keyframe {c['kf_id']} "
            f"(t={c['kf_time']:.2f} s) against {c['cand']} (t={c['cand_time']:.2f} s), seam "
            f"{c['seam_m']:.3f} m")
    for i, c in enumerate(got):
        log(f"EuRoC (iii), correction {i + 1}: keyframe {c['kf_id']} (t={c['kf_time']:.2f} s) "
            f"against {c['cand']} (t={c['cand_time']:.2f} s), seam {c['seam_m']:.3f} m  [{card}]")
    log(f"EuRoC (iii) with the JAX vocabulary: ATE {loop['ate']:.4f} m (JAX "
        f"{ref['ate_corrected_m']:.4f}), raw {loop['ate_raw']:.4f} (JAX {ref['ate_raw_m']:.4f}), "
        f"ok_frac {loop['ok_frac']:.4f} (JAX {ref['ok_frac']:.4f}), IMU initialized after frame "
        f"{loop['imu_init_frame']} (JAX {ref['imu_init_frame']})  [{card}]")
    if not got or abs(len(got) - len(want)) > 1:
        raise AssertionError(f"EuRoC (iii): {len(got)} corrections, the JAX record {len(want)}")
    if not (abs(got[0]["kf_time"] - want[0]["kf_time"]) <= 1.0
            and abs(got[0]["cand_time"] - want[0]["cand_time"]) <= 1.0):
        raise AssertionError(f"EuRoC (iii): the first correction on keyframes at t="
                             f"{got[0]['kf_time']:.2f} / {got[0]['cand_time']:.2f} s, the "
                             f"record's at {want[0]['kf_time']:.2f} / {want[0]['cand_time']:.2f} s")
    return loop


def euroc_loop_own_vocab(seq: str, card: str) -> dict:
    """Run (iii) with a vocabulary the port trains on the card, round-tripped
    through DBoW2 text, held to the JAX test's bars (IMU initialized, at
    least one correction, ATE < 0.7 m)."""
    import tempfile

    from orbslam3_tpu_torch.loop.closer import LoopConfig

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "voc.txt")
        training = train_fixture_vocab(seq, path)
        own = euroc_run("EuRoC (iii) loop, the port's vocabulary", "loop_own", seq, "small", card,
                        vocab_path=path, loop_cfg=LoopConfig(bow_min_score_gate=False))
    log(f"EuRoC (iii) with the port's vocabulary: {own['loop_corrections']} corrections, ATE "
        f"{own['ate']:.4f} m (raw {own['ate_raw']:.4f}), IMU initialized {own['imu_initialized']}"
        f"  [{card}]")
    if not (own["imu_initialized"] and own["loop_corrections"] >= 1 and own["ate"] < 0.7):
        raise AssertionError(f"EuRoC (iii) with the port's vocabulary misses the JAX test's bars "
                             f"(IMU initialized, >= 1 correction, ATE < 0.7 m): {own}")
    return dict(loop_own_vocab=own, vocab_training=training)


def euroc_worker(task: str, seqs: dict, ref: dict, card: str, log_path: str, out_path: str,
                 settings: dict):
    """One EuRoC task in a spawned process: "full_and_loop" runs (ii), held
    to its record, then (iii) with the JAX vocabulary; "loop_own" trains the
    port's vocabulary and runs (iii) with it. Its log goes to log_path and
    its record, or the error, to out_path as JSON."""
    import traceback

    globals().update(settings)
    sys.stdout = open(log_path, "w", buffering=1)
    try:
        if task == "full_and_loop":
            full = euroc_run("EuRoC (ii) full width", "full", seqs["full"], "full", card)
            check_euroc("EuRoC (ii) full width", full, ref["full"])
            out = dict(full=full, loop_jax_vocab=euroc_loop_jax_vocab(seqs["loop"], ref["loop"],
                                                                      card))
        else:
            out = euroc_loop_own_vocab(seqs["loop"], card)
    except BaseException:
        out = {"error": traceback.format_exc()}
    with open(out_path, "w") as f:
        json.dump(out, f, default=str)


def euroc_start(fixtures: dict, ref: dict, card: str) -> dict:
    """EuRoC ingest on the card, started: the native loader built from the
    checkout, rectification of (ii) against the CPU here, then the runs in
    two spawned processes beside whatever this process runs next (the card
    is idle most of a step, the host has cores to spare): (ii) and (iii)
    with the JAX vocabulary in one, the port's vocabulary and (iii) with it
    in the other. `euroc_finish` waits for them and prints their logs."""
    import multiprocessing

    from orbslam3_tpu_torch.io import native

    t0 = time.perf_counter()
    native.build(force=True)
    log(f"native loader: built {native._LIB_PATH} with {native.COMPILER} in "
        f"{time.perf_counter() - t0:.2f} s")
    seqs = take_fixtures(fixtures)
    remap = remap_check(seqs["full"], card)
    ctx = multiprocessing.get_context("spawn")
    settings = dict(DEVICE=DEVICE, LAUNCHES_PER_FRAME=LAUNCHES_PER_FRAME)
    procs = {}
    for task in ("full_and_loop", "loop_own"):
        paths = [os.path.join(fixtures["dir"].name, f"{task}.{x}") for x in ("log", "json")]
        p = ctx.Process(target=euroc_worker, args=(task, seqs, ref, card, *paths, settings))
        p.start()
        procs[task] = (p, *paths)
    return dict(fixtures=fixtures, procs=procs, remap=remap, t0=time.perf_counter())


def euroc_finish(handle: dict, timeout_s: float = 900.0) -> dict:
    """Wait for the EuRoC processes, print their logs, and raise if either
    failed one of its holds."""
    t0 = time.perf_counter()
    out, errors = {"remap": handle["remap"]}, []
    try:
        for task, (p, log_path, out_path) in handle["procs"].items():
            p.join(max(timeout_s - (time.perf_counter() - t0), 1.0))
            if p.is_alive():
                errors.append(f"{task}: still running after {timeout_s:.0f} s")
                continue
            with open(log_path) as f:
                for line in f:
                    log(f"[EuRoC {task}] {line.rstrip()}")
            if not os.path.exists(out_path):
                errors.append(f"{task}: exited with code {p.exitcode} and no record")
                continue
            with open(out_path) as f:
                rec = json.load(f)
            if "error" in rec:
                errors.append(f"{task}:\n{rec['error']}")
            out.update(rec)
    finally:
        for p, _, _ in handle["procs"].values():
            if p.is_alive():
                p.terminate()
                p.join(10)
        handle["fixtures"]["dir"].cleanup()
    log(f"EuRoC runs: done {time.perf_counter() - handle['t0']:.1f} s after they started (waited "
        f"{time.perf_counter() - t0:.1f} s for them here)")
    if errors:
        raise AssertionError("EuRoC ingest failed:\n" + "\n".join(errors))
    return out


def fleet_run(card) -> dict:
    """Phase 9: scripts/bench_fleet.py's fleet on the card. FLEET_SESSIONS
    worlds SyntheticConfig(seed=s, n_landmarks=800) at 752x480, 20 Hz,
    FLEET_FRAMES frames a session and half of them for session 0 (a ragged
    stream), SlamConfig(use_imu=True, kf_max_frames=6, ba_iters=3,
    ba_window=6) at the default capacities, chunk 4, every session on the
    one card. Holds: FAST/NMS launches (counted from 0 just before the run)
    equal the sum over flushes of the sessions with frames; sessions 0 and 1
    equal a lone FusedSlam(chunk=4, service_every=10**9) on their frames bit
    for bit; every session has two keyframes or more and a finite
    trajectory of its true length."""
    import numpy as np
    import torch

    from orbslam3_tpu_torch.io.synthetic import SyntheticConfig, SyntheticWorld
    from orbslam3_tpu_torch.models.fused import FrameOut, FusedSlam
    from orbslam3_tpu_torch.models.slam import SlamConfig
    from orbslam3_tpu_torch.ops.fast_cuda import fast_nms
    from orbslam3_tpu_torch.parallel.multi_session import MultiSessionSlam

    D, n = FLEET_SESSIONS, FLEET_FRAMES
    t0 = time.perf_counter()
    worlds = [SyntheticWorld(SyntheticConfig(duration=n / 20.0, seed=s, n_landmarks=800))
              for s in range(D)]
    streams = []
    for s, w in enumerate(worlds):
        times = w.frame_times()[: n // 2 if s == 0 else n]
        frames = w.render_sequence(times, workers=2)
        imu = [w.imu_window(times[i - 1] if i > 0 else t, t) for i, t in enumerate(times)]
        streams.append((times, frames, imu))
    log(f"fleet: {D} worlds of {n} frames (session 0: {n // 2}) {worlds[0].cfg.width}x"
        f"{worlds[0].cfg.height} rendered in {time.perf_counter() - t0:.1f} s")
    cfg = SlamConfig(use_imu=True, kf_max_frames=6, ba_iters=3, ba_window=6)
    dev = torch.device(DEVICE)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    mem = (lambda: torch.cuda.memory_allocated(dev)) if dev.type == "cuda" else (lambda: 0)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    m0 = mem()
    ms = MultiSessionSlam(worlds[0].cam, cfg, n_sessions=D, chunk=FLEET_CHUNK,
                          devices=None if dev.type == "cuda" else [dev] * D)
    state_bytes = mem() - m0
    fast_nms.launches = 0
    warm = None
    t_start = time.perf_counter()
    for i in range(n):
        for s, (times, frames, imu) in enumerate(streams):
            if i < len(times):
                ms.process_frame(s, frames[i][0], frames[i][1], *imu[i], float(times[i]))
            if warm is None and ms.outs:  # after the first flush: the warm-up
                sync()
                warm = (time.perf_counter(), int(sum(v.sum() for _, _, v in ms.outs)))
    ms.finalize()
    sync()
    t_end = time.perf_counter()
    launches = fast_nms.launches
    expected = sum(int(v[s].any()) for _, _, v in ms.outs for s in range(D))
    total = int(sum(v.sum() for _, _, v in ms.outs))
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    if launches != LAUNCHES_PER_FRAME * expected or sum(ms.launches) != expected:
        raise AssertionError(f"fleet: fast_nms launched {launches} times, expected one a session "
                             f"a flush with frames: {expected} (the fleet counts {ms.launches})")
    n_kf = [int(ms.session_state(s)[0].n_kf) for s in range(D)]
    for s, (times, _, _) in enumerate(streams):
        ts_, ps, qs = ms.trajectory_arrays(s)
        if len(ps) != len(times) or not (np.isfinite(ps).all() and np.isfinite(qs).all()):
            raise AssertionError(f"fleet session {s}: {len(ps)} poses for {len(times)} frames, "
                                 f"finite {np.isfinite(ps).all()}")
        if n_kf[s] < 2:
            raise AssertionError(f"fleet session {s}: {n_kf[s]} keyframes")
    agg = (total - warm[1]) / (t_end - warm[0])
    per = [len(streams[s][0]) / ms.step_s[s] for s in range(D)]
    log(f"fleet: {D} sessions on {sorted({str(d) for d in ms.devices})}, {total} frames in "
        f"{len(ms.outs)} flushes, fast_nms launches {launches} (= sessions with frames summed "
        f"over the flushes), keyframes {n_kf}  [{card}]")
    log(f"fleet: aggregate {agg:.3f} tracked frames/s after the warm-up flush ({warm[1]} frames), "
        f"{total / (t_end - t_start):.3f} over the whole run; per session (frames over its own "
        f"step wall) {[round(x, 3) for x in per]} frames/s  [{card}]")
    log(f"fleet: peak device memory {peak / 2**20:.1f} MiB ({peak / 2**20 / D:.1f} MiB a "
        f"session), the sessions' state {state_bytes / 2**20:.1f} MiB ({state_bytes / 2**20 / D:.1f}"
        f" MiB a session)  [{card}]")
    equal = []
    for s in (0, 1):
        times, frames, imu = streams[s]
        lone = FusedSlam(worlds[s].cam, cfg, chunk=FLEET_CHUNK, service_every=10**9, device=dev)
        for i, t in enumerate(times):
            lone.process_frame(frames[i][0], frames[i][1], *imu[i], float(t))
        lone.flush()
        a, b = ms.frame_outputs(s), lone.frame_outputs()
        same = all(np.array_equal(getattr(a, f), getattr(b, f)) for f in FrameOut._fields)
        same = same and all(torch.equal(x, y) for x, y in zip(ms.session_state(s)[0], lone.map)
                            if isinstance(x, torch.Tensor))
        equal.append(same)
        if not same:
            raise AssertionError(f"fleet session {s} differs from a lone FusedSlam on its frames")
    log(f"fleet: sessions 0 and 1 equal a lone FusedSlam(chunk={FLEET_CHUNK}, "
        f"service_every=10**9) on their frames bit for bit (outputs and map): {equal}  [{card}]")
    return dict(sessions=D, frames=total, flushes=len(ms.outs), launches=launches,
                aggregate_fps=agg, whole_run_fps=total / (t_end - t_start),
                per_session_fps=per, peak_mib=peak / 2**20, state_mib=state_bytes / 2**20,
                n_kf=n_kf, host_syncs=ms.host_syncs)


def fleet_and_entry(card: str) -> dict:
    """Phases 9 and 10: the fleet, then the entry points."""
    out = fleet_run(card)
    phase("10 the entry points: entry() against the CPU, dryrun_multichip(2)")
    out["entry"] = entry_phase(card)
    return out


def phase_worker(task: str, args: tuple, log_path: str, out_path: str, settings: dict):
    """globals()[task](*args) in a spawned process: its log to log_path,
    its record or the error to out_path as JSON."""
    import traceback

    globals().update(settings)
    sys.stdout = open(log_path, "w", buffering=1)
    try:
        out = globals()[task](*args)
    except BaseException:
        out = {"error": traceback.format_exc()}
    with open(out_path, "w") as f:
        json.dump(out, f, default=str)


def phase_start(task: str, *args) -> dict:
    """Start globals()[task](*args) in a spawned process beside whatever
    this process runs next; `phase_finish` waits for it."""
    import multiprocessing
    import tempfile

    d = tempfile.TemporaryDirectory()
    paths = [os.path.join(d.name, f"{task}.{x}") for x in ("log", "json")]
    p = multiprocessing.get_context("spawn").Process(
        target=phase_worker, args=(task, args, *paths,
                                   dict(DEVICE=DEVICE, LAUNCHES_PER_FRAME=LAUNCHES_PER_FRAME)))
    p.start()
    return dict(proc=p, paths=paths, dir=d, t0=time.perf_counter(), task=task)


def phase_finish(handle: dict, tag: str, timeout_s: float = 600.0) -> dict:
    """Wait for a spawned phase, print its log under `tag`, raise if it
    failed a hold."""
    t0 = time.perf_counter()
    p, (log_path, out_path) = handle["proc"], handle["paths"]
    try:
        p.join(timeout_s)
        if p.is_alive():
            raise AssertionError(f"{tag}: still running after {timeout_s:.0f} s")
        with open(log_path) as f:
            for line in f:
                log(f"[{tag}] {line.rstrip()}")
        if not os.path.exists(out_path):
            raise AssertionError(f"{tag}: exited with code {p.exitcode} and no record")
        with open(out_path) as f:
            rec = json.load(f)
    finally:
        if p.is_alive():
            p.terminate()
            p.join(10)
        handle["dir"].cleanup()
    log(f"{tag}: done {time.perf_counter() - handle['t0']:.1f} s after it started (waited "
        f"{time.perf_counter() - t0:.1f} s for it here)")
    if "error" in rec:
        raise AssertionError(f"{tag} failed:\n" + rec["error"])
    return rec


def slam_system_run(path: str, world, inputs, cfg, blackout=None) -> dict:
    """Phase 11: one run of the port's SlamSystem, built with no `device`
    (it must pick the card itself), with the FAST/NMS launch count set to 0
    just before it and held to one a frame just after. Returns
    slam_system_record's record with the launches, frames/s after WARMUP
    frames, host syncs a frame and peak device memory."""
    import numpy as np
    import torch

    from orbslam3_tpu_torch.models.slam import SlamSystem
    from orbslam3_tpu_torch.ops.fast_cuda import fast_nms

    on_card = DEVICE == "cuda"
    slam = SlamSystem(world.cam, cfg) if on_card else SlamSystem(world.cam, cfg, device=DEVICE)
    if on_card and slam.device.type != "cuda":
        raise AssertionError(f"{path}: SlamSystem without a device argument runs on {slam.device}")
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    clock = {}

    def hook(i):
        if i == WARMUP - 1:
            sync()
            clock.update(t0=time.perf_counter(), syncs=slam.host_syncs)

    fast_nms.launches = 0
    init = drive_slam_system(slam, inputs, hook=hook)
    sync()
    launches = fast_nms.launches
    wall = time.perf_counter() - clock["t0"]
    if launches != LAUNCHES_PER_FRAME * len(inputs):
        raise AssertionError(f"{path}: fast_nms launched {launches} times over {len(inputs)} "
                             f"frames, expected {LAUNCHES_PER_FRAME} a frame")
    rec = slam_system_record(slam, world, init, blackout)
    ps = np.asarray(rec["per_frame"]["p"], np.float64)
    if not np.isfinite(ps).all():
        raise AssertionError(f"{path}: the trajectory is not finite")
    timed = len(inputs) - WARMUP
    rec.update(launches=launches, fps=timed / wall, host_syncs_per_frame=(
        slam.host_syncs - clock["syncs"]) / timed, peak_mib=(
        torch.cuda.max_memory_allocated() / 2**20 if on_card else 0.0))
    return rec


def log_slam_system(path: str, rec: dict, ref: dict, card: str):
    imu = (f", IMU after frame {rec['imu_init_frame']} (JAX {ref['imu_init_frame']})"
           if rec["imu_initialized"] or ref["imu_initialized"] else "")
    g = (f", gravity error {rec['gravity_err_deg']:.3f} deg (JAX {ref['gravity_err_deg']:.3f})"
         if rec["gravity_err_deg"] is not None and ref["gravity_err_deg"] is not None else "")
    log(f"{path}: {rec['frames']} frames tracked, ATE {rec['ate_m']:.5f} m (JAX "
        f"{ref['ate_m']:.5f}), ok_frac {rec['ok_frac']:.4f} (JAX {ref['ok_frac']:.4f}){imu}{g}, "
        f"maps {rec['n_maps_created']} (JAX {ref['n_maps_created']}), bad-IMU resets "
        f"{rec['bad_imu_resets']} (JAX {ref['bad_imu_resets']}), n_kf {rec['n_kf']} (JAX "
        f"{ref['n_kf']}); {rec['fps']:.3f} frames/s after {WARMUP} warm-up frames, host syncs/frame "
        f"{rec['host_syncs_per_frame']:.3f}, fast_nms launches {rec['launches']}, peak device "
        f"memory {rec['peak_mib']:.1f} MiB  [{card}]")


def slam_system_full(card: str, frames, ref: dict) -> dict:
    """Phase 11 (a): SlamSystem under the production SlamConfig() on the
    bench world's first SLAM_SYSTEM_FRAMES frames, on sensor-noise draw
    SLAM_SYSTEM_SEED, held to the JAX record of that draw: ATE within
    max(0.02 m, 0.5 ATE_jax), ok_frac >= the record's - 0.05, the IMU
    initialized after the record's frame, as many maps; then on the
    noise-free frames, printed beside the record, not held (a knife edge,
    ROADMAP queue 3 item 4)."""
    import numpy as np

    from orbslam3_tpu_torch.io.synthetic import perturb_frames
    from orbslam3_tpu_torch.models.slam import SlamConfig

    n = SLAM_SYSTEM_FRAMES
    world, times, frames, imu = build_world(frames[:n])
    times, imu = times[:n], imu[:n]
    draws = {d["seed"]: d for d in ref["draws"]}
    out = {}
    for seed in (SLAM_SYSTEM_SEED, None):
        fr = frames if seed is None else perturb_frames(frames, seed)
        inputs = [(left, right, *imu[i], float(times[i])) for i, (left, right) in enumerate(fr)]
        path = f"SlamSystem, SlamConfig(), {n} frames of the bench world, draw {seed}"
        rec = slam_system_run(path, world, inputs, SlamConfig())
        jax_rec = draws[seed]
        log_slam_system(path, rec, jax_rec, card)
        if seed is not None:
            if abs(rec["ate_m"] - jax_rec["ate_m"]) > band(jax_rec["ate_m"]):
                raise AssertionError(f"{path}: ATE {rec['ate_m']:.5f} m outside the band of the "
                                     f"JAX record's {jax_rec['ate_m']:.5f}")
            if rec["ok_frac"] < jax_rec["ok_frac"] - 0.05:
                raise AssertionError(f"{path}: ok_frac {rec['ok_frac']:.4f} below the JAX "
                                     f"record's {jax_rec['ok_frac']:.4f} - 0.05")
            if rec["imu_init_frame"] != jax_rec["imu_init_frame"]:
                raise AssertionError(f"{path}: IMU initialized after frame "
                                     f"{rec['imu_init_frame']}, the JAX record after "
                                     f"{jax_rec['imu_init_frame']}")
            if rec["n_maps_created"] != jax_rec["n_maps_created"]:
                raise AssertionError(f"{path}: {rec['n_maps_created']} maps, the JAX record "
                                     f"{jax_rec['n_maps_created']}")
        pf, jpf = rec.pop("per_frame"), jax_rec["per_frame"]
        differ = [i for i in range(min(len(pf["state"]), len(jpf["state"])))
                  if (pf["is_kf"][i], pf["n_inliers"][i]) != (jpf["is_kf"][i],
                                                               jpf["n_inliers"][i])]
        far = np.flatnonzero(np.linalg.norm(np.asarray(pf["p"]) - np.asarray(jpf["p"])[
            :len(pf["p"])], axis=1) > 1e-3)
        log(f"{path}: first departure from the JAX record: keyframe or inlier count at frame "
            f"{differ[0] if differ else None}, position by > 1 mm at frame "
            f"{int(far[0]) if len(far) else None}")
        out["draw1" if seed is not None else "noise_free"] = rec
    return out


def slam_system_worlds(card: str, ref: dict) -> dict:
    """Phase 11 (b): the JAX package's SlamSystem tests, each world at its
    own size and held to that test's bars (tests/test_e2e_stereo.py,
    test_e2e_inertial.py, test_atlas.py, test_extrinsics.py::
    test_e2e_inertial_with_euroc_extrinsics), and the static world of
    tests/test_recovery.py run through SlamSystem: bad_imu_resets and
    imu_initialized equal to the JAX record's."""
    import numpy as np

    from orbslam3_tpu_torch.frontend.orb import OrbConfig
    from orbslam3_tpu_torch.io.synthetic import SyntheticConfig, SyntheticWorld, euroc_t_bc
    from orbslam3_tpu_torch.map.slam_map import MapCapacity
    from orbslam3_tpu_torch.models.slam import SlamConfig
    from orbslam3_tpu_torch.models.tracker import TrackConfig

    pkg = dict(SyntheticConfig=SyntheticConfig, SyntheticWorld=SyntheticWorld,
               euroc_t_bc=euroc_t_bc, SlamConfig=SlamConfig, OrbConfig=OrbConfig,
               MapCapacity=MapCapacity, TrackConfig=TrackConfig)
    out = {}
    for name in SLAM_SYSTEM_WORLDS:
        world, cfg, blackout = slam_system_world(pkg, name)
        inputs = slam_system_inputs(world, blackout)
        path = f"SlamSystem, the {name} test's world"
        rec = slam_system_run(path, world, inputs, cfg, blackout)
        rec.pop("per_frame")
        log_slam_system(path, rec, ref[name], card)
        bars = []
        if name in ("stereo", "inertial", "extrinsics"):
            bars += [("ok_frac > 0.9", rec["ok_frac"] > 0.9),
                     ("ATE < " + ("0.05" if name == "stereo" else "0.06"),
                      rec["ate_m"] < (0.05 if name == "stereo" else 0.06))]
        if name in ("inertial", "extrinsics"):
            bars += [("IMU initialized", rec["imu_initialized"]),
                     ("gravity within 5 deg", rec["imu_initialized"]
                      and rec["gravity_err_deg"] < 5.0)]
        if name == "inertial":
            bars.append(("bg within 1.5e-2", rec["imu_initialized"] and bool(np.all(np.abs(
                np.asarray(rec["bg"]) - np.asarray(world.cfg.gyro_bias)) <= 1.5e-2))))
        if name == "atlas":
            bars += [(">= 2 maps created", rec["n_maps_created"] >= 2),
                     (">= 2 map ids among the valid keyframes", len(rec["map_ids"]) >= 2),
                     (">= 3 keyframes in the active map", rec["n_active"] >= 3),
                     ("ok_frac > 0.8 after the blackout", rec["ok_frac_post"] > 0.8)]
        if name == "static":
            bars += [("bad_imu_resets as the JAX record",
                      rec["bad_imu_resets"] == ref[name]["bad_imu_resets"]),
                     ("imu_initialized as the JAX record",
                      rec["imu_initialized"] == ref[name]["imu_initialized"])]
        failed = [b for b, ok in bars if not ok]
        log(f"{path}: bars {[b for b, _ in bars]}: " + ("all held" if not failed else
                                                         f"FAILED {failed}"))
        if failed:
            raise AssertionError(f"{path}: failed {failed}")
        out[name] = rec
    return out


def slam_system_phase(card: str, frames) -> dict:
    """Phase 11 (a) and (b), in a spawned process beside phase 6."""
    with open(os.path.join(ROOT, "orbslam3_tpu_torch", "data",
                           "slam_system_reference.json")) as f:
        ref = json.load(f)
    phase("11 (a) SlamSystem at full width against data/slam_system_reference.json")
    full = slam_system_full(card, frames, ref["full"])
    phase("11 (b) SlamSystem on the worlds of the JAX package's SlamSystem tests")
    return dict(full=full, worlds=slam_system_worlds(card, ref["worlds"]))


def eval_phase(card: str) -> dict:
    """Phase 12, in a spawned process beside phases 5b-6f: EVAL_RUNS through
    scripts/eval_suite_torch.py::run_slam on the card, each held to its JAX
    record: the same first and last frame, the IMU initialized after a frame
    within one chunk of the record's, ok_frac >= the record's - 0.05, one
    FAST/NMS launch a dispatched chunk, corrections within 1 of the record's
    where the mode closes loops. ATE, RPE, keyframes, the first frame that
    leaves the record and frames/s are printed beside the record, not held:
    these noise-free worlds are knife edges (PERF.md section 6)."""
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import eval_suite_torch as es

    from orbslam3_tpu_torch.ops.fast_cuda import fast_nms

    ref = es.load_reference()
    out, failed = {}, []
    for mode, seed in EVAL_RUNS:
        path = f"eval {mode} seed {seed}"
        t0 = time.perf_counter()
        frames = es._get_world(seed, 8.0, mode, workers=2)[2]
        render_s = time.perf_counter() - t0
        fast_nms.launches = 0
        slam, row = es.run_slam(seed, 8.0, mode, chunk=CHUNK, device=DEVICE)
        launches = fast_nms.launches
        rec, want = es.port_record(slam, frames), ref["runs"][f"{mode}:{seed}"]
        dispatches = len(slam.outs)
        log(f"{path}: ATE {row['ate_m']:.5f} m (JAX {want['ate_m']:.5f}), RPE@20 "
            f"{row['rpe_m']:.5f} m {row['rpe_rad']:.5f} rad (JAX {want['rpe_m']:.5f} m "
            f"{want['rpe_rad']:.5f} rad), keyframes {row['keyframes']} (JAX "
            f"{want['keyframes']}), IMU after frame {rec['imu_init_frame']} (JAX "
            f"{want['imu_init_frame']}), ok_frac {rec['ok_frac']:.4f} (JAX "
            f"{want['ok_frac']:.4f}), loops {row['loops']} (JAX {want['loops']})")
        log(f"{path}: first departure from the record: {es.first_departure(rec, want)}")
        log(f"{path}: {row['fps']:.3f} frames/s after {es.WARM} warm-up frames, fast_nms "
            f"launches {launches} over {dispatches} dispatches, rendered in {render_s:.1f} s  "
            f"[{card}]")
        if rec["checksum"] != want["checksum"]:
            failed.append(f"{path}: frame checksums {rec['checksum']}, the record's "
                          f"{want['checksum']}")
        got_f, want_f = rec["imu_init_frame"], want["imu_init_frame"]
        if (got_f is None) != (want_f is None) or (
                want_f is not None and abs(got_f - want_f) > CHUNK):
            failed.append(f"{path}: IMU initialized after frame {got_f}, the record's {want_f}")
        if not rec["ok_frac"] >= want["ok_frac"] - 0.05:
            failed.append(f"{path}: ok_frac {rec['ok_frac']}, the record's {want['ok_frac']}")
        if launches != LAUNCHES_PER_FRAME * dispatches or dispatches * CHUNK < rec["n_frames"]:
            failed.append(f"{path}: fast_nms launched {launches} times in {dispatches} "
                          f"dispatches over {rec['n_frames']} frames")
        if want["loops"] is not None and abs(row["loops"] - want["loops"]) > 1:
            failed.append(f"{path}: {row['loops']} corrections, the record's {want['loops']}")
        out[f"{mode}:{seed}"] = dict(row, launches=launches, dispatches=dispatches,
                                     imu_init_frame=got_f, ok_frac=rec["ok_frac"],
                                     first_departure=es.first_departure(rec, want))
        del slam
    if failed:
        raise AssertionError("; ".join(failed))
    return out


def profile_phase(card: str) -> dict:
    """Phase 11 (c): scripts/profile_pipeline_torch.py at full width on the
    card: each stage's host wall and device-inclusive milliseconds; the
    stages that run the front end launch FAST/NMS once a call, the others
    never."""
    import profile_pipeline_torch

    out = profile_pipeline_torch.profile(None if DEVICE == "cuda" else DEVICE,
                                         log=lambda m: log(f"  {m}  [{card}]"))
    front = {"detect_orb(left)", "process_stereo", "full process_frame"}
    bad = {k: v["launches"] for k, v in out.items()
           if v["launches"] != LAUNCHES_PER_FRAME * (k in front)}
    if bad:
        raise AssertionError(f"profile: FAST/NMS launches a call {bad}, expected "
                             f"{LAUNCHES_PER_FRAME} for {sorted(front)} and 0 elsewhere")
    return out


def distributed_gba_phase(first, cfg, cam, card) -> dict:
    """Phase 6f: distributed global BA on the card, on the recorded input
    state of the revisit world's first correction, with the closer's table
    (gba_max_points, gba_tile, gba_obs, gba_iters). One rank of an NCCL group
    in this process against global_ba, bit for bit; then two spawned ranks
    of a gloo group on CUDA tensors of the one card: the ranks bit-equal and
    within 1e-4 of the one rank. CUDA-event times per Gauss-Newton step
    beside the bytes the all_reduce sums."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from orbslam3_tpu_torch.interop import to_device
    from orbslam3_tpu_torch.parallel.distributed_ba import (
        distributed_global_ba,
        global_ba,
        make_point_table,
    )
    from orbslam3_tpu_torch.parallel.ranks import free_port, gba_rank, run_ranks

    dev = torch.device("cuda")
    st = to_device(first["st"], dev)
    K = st.kf_valid.shape[0]
    P = -(-min(cfg.gba_max_points, st.mp_pos.shape[0]) // cfg.gba_tile) * cfg.gba_tile
    pts, _ = make_point_table(st, P, cfg.gba_obs)
    opt = st.kf_valid & (torch.arange(K, device=dev) != first["cand"])
    it, tile = cfg.gba_iters, cfg.gba_tile
    args = (pts, st.kf_q, st.kf_p, opt, cam)
    one = global_ba(*args, iters=it, tile=tile)
    one_ms = cuda_ms(lambda: global_ba(*args, iters=it, tile=tile), 2) / it
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_port()}", world_size=1,
                            rank=0, device_id=torch.device("cuda", torch.cuda.current_device()))
    try:
        nccl = distributed_global_ba(*args, iters=it, tile=tile)
        nccl_ms = cuda_ms(lambda: distributed_global_ba(*args, iters=it, tile=tile), 2) / it
    finally:
        dist.destroy_process_group()
    same = [torch.equal(a, b) for a, b in zip(nccl, one)]
    bytes_ = (36 * K * K + 6 * K) * 4
    n_pts = int(pts.pt_valid.sum())
    log(f"distributed global BA, one NCCL rank against global_ba on the revisit world's first "
        f"correction ({n_pts} points in a table of {P} slots, tiles of {tile}, {K} keyframes, "
        f"{it} iterations): q, p, Xw equal bit for bit {same}; per Gauss-Newton step "
        f"{nccl_ms:.1f} ms (global_ba {one_ms:.1f} ms), all_reduce of {bytes_} bytes "
        f"(6K x 6K + 6K floats) a step  [{card}]")
    if not all(same):
        raise AssertionError("distributed_global_ba on one NCCL rank differs from global_ba")
    problem = {f: getattr(pts, f).cpu().numpy() for f in pts._fields}
    problem.update(q=st.kf_q.cpu().numpy(), p=st.kf_p.cpu().numpy(), opt_cam=opt.cpu().numpy(),
                   cam=cam.to("cpu"))
    t0 = time.perf_counter()
    outs = run_ranks(gba_rank, 2, (problem, it, tile, "cuda", 2), backend="gloo")
    wall = time.perf_counter() - t0
    for k in ("q", "p", "Xw"):
        if not np.array_equal(outs[0][k], outs[1][k]):
            raise AssertionError(f"distributed global BA: the two gloo ranks' {k} differ")
    err = max(float(np.abs(outs[0][k] - a.cpu().numpy()).max())
              for k, a in zip(("q", "p", "Xw"), one))
    two_ms = [o["ms"][-1] / it for o in outs]
    log(f"distributed global BA, two gloo ranks on CUDA tensors of the one card (spawned, "
        f"{wall:.1f} s with start-up): ranks equal bit for bit, {err:.2e} from one rank; per "
        f"Gauss-Newton step {[round(x, 1) for x in two_ms]} ms (ranks 0, 1), all_reduce of "
        f"{bytes_} bytes a step through the host  [{card}]")
    if err > 1e-4:
        raise AssertionError(f"distributed global BA: two ranks leave one rank by {err}")
    return dict(points=n_pts, slots=P, tile=tile, keyframes=K, iters=it,
                one_rank_nccl_step_ms=nccl_ms, global_ba_step_ms=one_ms,
                two_rank_gloo_step_ms=two_ms, allreduce_bytes=bytes_, two_rank_max_err=err)


def entry_phase(card) -> dict:
    """Phase 10: entry() on the card against the CPU (n_inliers exact, q and
    p within 1e-5), then dryrun_multichip(2) on the card."""
    import numpy as np
    import torch

    from orbslam3_tpu_torch.entry import dryrun_multichip, entry

    fn, args = entry()
    if args[1].device.type != "cuda":
        raise AssertionError("entry() did not pick the card")
    got = [x.cpu().numpy() for x in fn(*args)]
    fn_c, args_c = entry(device="cpu")
    want = [x.numpy() for x in fn_c(*args_c)]
    err = max(float(np.abs(a - b).max()) for a, b in zip(got[:2], want[:2]))
    log(f"entry(): q, p within {err:.1e} of the CPU's, n_inliers {int(got[2])} (CPU "
        f"{int(want[2])})  [{card}]")
    if err > 1e-5 or int(got[2]) != int(want[2]):
        raise AssertionError("entry() on the card leaves the CPU's result")
    t0 = time.perf_counter()
    dryrun_multichip(2)
    wall = time.perf_counter() - t0
    log(f"dryrun_multichip(2) on the card in {wall:.1f} s  [{card}]")
    torch.cuda.synchronize()
    return dict(entry_err=err, n_inliers=int(got[2]), dryrun_s=wall)


def run_slice(world, times, frames, imu, cfg, device=None, profile_at=None, chunk=1,
              slam=None, start=0, stop=None, finalize=True, hook=None):
    """FusedSlam.process_frame over frames [start, stop), on the device
    FusedSlam picks itself (the card) unless `device` names one, in a new
    system unless `slam` is given. With `profile_at`, frames [profile_at,
    profile_at + PROFILE_FRAMES) run under torch.profiler. `hook(i, slam)`
    runs before frame i, after the last frame and after finalize, off the
    clock.
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
    paused = 0.0
    i = start
    while i < n:
        if i == start + WARMUP:
            sync()
            slam.timing.clear()
            if slam.loop_closer is not None:
                slam.loop_closer.timing.clear()
            syncs0 = slam.host_syncs
            if on_card:
                torch.cuda.reset_peak_memory_stats()
            paused = 0.0
            t_start = time.perf_counter()
        if hook is not None:
            t0 = time.perf_counter()
            hook(i, slam)
            paused += time.perf_counter() - t0
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
    if hook is not None:
        t0 = time.perf_counter()
        hook(n, slam)
        paused += time.perf_counter() - t0
    if finalize:
        slam.finalize()
    sync()
    elapsed = time.perf_counter() - t_start - paused
    if hook is not None and finalize:
        hook(n, slam)
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


def prefix_record(ref: dict, n: int, gt_p) -> dict:
    """A noise-free JAX reference over its first n frames, from its
    per-frame record: ATE, ok_frac, keyframes inserted, the IMU's frame."""
    import numpy as np

    from orbslam3_tpu_torch.eval.metrics import ate_rmse

    pf = ref["per_frame"]
    init = ref.get("imu_init_frame")
    return dict(ate_m=float(ate_rmse(np.asarray(pf["p"][:n], np.float32), gt_p[:n])),
                ok_frac=float(np.mean(np.asarray(pf["mode"][:n]) == 1)),
                n_kf=int(np.sum(pf["is_kf"][:n])),
                imu_init_frame=init if init is not None and init < n else None)


def check_accuracy(path: str, draws):
    """One path of the port against its JAX reference over the same frames
    (the noise-free draw; the main path's accuracy under sensor noise is
    held by the session, phase 5b).

    Every draw keeps ok_frac within 0.05 of the reference's, initializes the
    IMU at the reference's frame (never, on the stereo path); every
    stereo-inertial draw ends within 2 keyframe rows of the reference's
    count. The noise-free ATE is reported, not held: on the stereo path the
    reference sits on an exact float32 tie of the keyframe gate (frame 56,
    133 inliers against 0.7 * 190), and a single BRIEF bit that float32
    rounding flips on the way decides the branch; on the stereo-inertial
    path the same front-end bits meet a keyframe gate that the reference
    passes by 2.1 inliers (frame 88); fed the JAX front end's features the
    port stays on the reference's branch (scripts/vi_backend_witness.py,
    PERF.md); `first_divergence` prints where."""
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


def checkpoint_saver(path: str, box: dict):
    """A run_slice hook that saves the run (save_map) before frame SAVE_AT."""
    from orbslam3_tpu_torch.map.checkpoint import save_map

    def save(i, slam):
        if i == SAVE_AT:
            t0 = time.perf_counter()
            save_map(path, slam.map, slam.ts)
            box.update(save_ms=(time.perf_counter() - t0) * 1e3, bytes=os.path.getsize(path),
                       imu_initialized=slam.imu_initialized)
    return save


def resume_and_profile(world, times, frames, imu, first, path, saved, card) -> float:
    """The main run resumed from its checkpoint after frame SAVE_AT - 1:
    load_map on the card, FusedSlam.from_state, frames [SAVE_AT,
    SECOND_STOP) in the resumed system. Its raw poses must stay within 1 mm
    of the uninterrupted run's (bit-equality is printed); the IMU state is
    carried (no second initialization). A torch.profiler window closes the
    resumed part.
    Prints device time by kernel; returns the FAST/NMS kernel's device
    milliseconds per frame."""
    import numpy as np

    from orbslam3_tpu_torch.map.checkpoint import load_map
    from orbslam3_tpu_torch.models.fused import BENCH_CFG, FusedSlam

    n = SECOND_STOP
    if not (first.imu_init_frame < SAVE_AT and saved.get("imu_initialized")):
        raise AssertionError(f"the checkpoint at frame {SAVE_AT} comes before the IMU "
                             f"initialized (frame {first.imu_init_frame})")
    # the window closes the run: every launch after the profiler attached costs more host time
    p0 = n - PROFILE_FRAMES
    step_ms = first.timing_report()["step"]["mean_ms"]
    t0 = time.perf_counter()
    st, ts = load_map(path, with_track_state=True)
    load_ms = (time.perf_counter() - t0) * 1e3
    if st.kf_q.device.type != "cuda":
        raise AssertionError(f"load_map without a device argument loaded onto {st.kf_q.device}")
    resumed = FusedSlam.from_state(world.cam, BENCH_CFG, st, ts)
    log(f"checkpoint of the main run after frame {SAVE_AT - 1}: {saved['bytes'] / 2**20:.2f} MiB, "
        f"save_map {saved['save_ms']:.0f} ms (off the run's clock), load_map onto the card "
        f"{load_ms:.0f} ms; resumed with n_kf {resumed._n_kf}, IMU initialized "
        f"{resumed.imu_initialized}  [{card}]")
    if not resumed.imu_initialized or resumed.device.type != "cuda":
        raise AssertionError("the resumed system lost the IMU state or left the card")
    _, _, _, (prof, wall) = run_slice(world, times, frames, imu, BENCH_CFG, slam=resumed,
                                      start=SAVE_AT, stop=n, profile_at=p0)
    if resumed.imu_init_frame is not None or "imu_init" in resumed.timing:
        raise AssertionError("the resumed system initialized the IMU a second time")
    b, c = resumed.frame_outputs(), first.frame_outputs()
    same_tail = bool(np.array_equal(b.p, c.p[SAVE_AT:n]) and np.array_equal(b.q, c.q[SAVE_AT:n]))
    far = float(np.linalg.norm(b.p - c.p[SAVE_AT:n], axis=1).max())
    log(f"reproducible: the main run resumed from its checkpoint over frames {SAVE_AT}..{n - 1}: "
        f"raw poses equal the uninterrupted run's bit for bit {same_tail}, largest position "
        f"difference {far:.3e} m, n_kf {int(resumed.map.n_kf)} (uninterrupted, at frame "
        f"{len(times) - 1}: {int(first.map.n_kf)})")
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

    outs = slam.frame_outputs()
    _, ps, _ = slam.trajectory_arrays()
    pf = {k: v[:len(ps)] for k, v in ref["per_frame"].items()}
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
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
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
    with open(os.path.join(data, "loop_reference.json")) as f:
        ref_loop = json.load(f)
    n = STEREO_FRAMES
    (slam, fps, syncs_per_frame, _), launches_stereo = counted_run(
        "stereo", world, times[:n], frames[:n], imu[:n], SLICE_CFG)
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

    # ---- 4. the stereo-inertial path (BENCH_CFG): the main path
    phase("4 stereo-inertial path")
    import tempfile

    n = MAIN_FRAMES
    main_frames = times[:n], frames[:n], imu[:n]
    ckpt_dir = tempfile.TemporaryDirectory()
    ckpt, saved = os.path.join(ckpt_dir.name, "checkpoint.npz"), {}
    (vi, fps, syncs_per_frame, _), launches = counted_run(
        "stereo-inertial", world, *main_frames, BENCH_CFG, hook=checkpoint_saver(ckpt, saved))
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

    phase("4b (a) the same frames with the loop closer at chunk=8; compact_map at full capacity")
    launches_chunk, fps_chunk, warm_a = loop_bench_run(world, *main_frames, vi, fps, card,
                                                       ref_loop["bench"])
    compaction_check(vi, card)
    # the revisit world renders in the background from here on: the times of
    # phases 5b and 5c are taken under that load, those before it are not
    revisit_frames = render_revisit_world()
    fixtures = write_euroc_fixtures()
    # phase 12 renders its own worlds first, so it starts here, beside 5b-6f
    phase("12 scripts/eval_suite_torch.py's runs, started in a spawned process beside phases "
          "5b-6f")
    eval_handle = phase_start("eval_phase", card)

    # ---- 5. the long session and the leaves of loop closing; the main run
    # resumed from its checkpoint comes last (a profiler window after the IMU
    # initialized: device time by kernel)
    phase("5b the long session: 16 keyframe rows, compaction by itself")
    m = SESSION_FRAMES
    session = session_run(world, times[:m], frames[:m], imu[:m], gt_p, card)
    phase("5c the leaves of loop closing and of the front end on the card")
    leaves_phase(vi, vi.cam, card)
    front_leaves(frames[0][0].astype(np.float32), frames[0][1].astype(np.float32), vi.cam, card)

    # ---- 6. loop closing: the revisit world, the merge world, the
    # relocalization world, the first correction again on its recorded state
    phase("8 EuRoC ingest, started: native loader, rectification; the runs in two processes "
          "beside phases 6b-6d")
    with open(os.path.join(data, "euroc_reference.json")) as f:
        euroc_handle = euroc_start(fixtures, json.load(f), card)
    phase("9 the fleet, then 10 the entry points, started in a spawned process beside phases "
          "6b-6f")
    fleet_handle = phase_start("fleet_and_entry", card)
    phase("11 (a), (b) SlamSystem, started in a spawned process beside phases 6b-6f")
    ss_handle = phase_start("slam_system_phase", card, frames[:SLAM_SYSTEM_FRAMES])

    phase(f"6b loop closing: the revisit world ({REVISIT_FRAMES} frames)")
    rv, rv_rec, rv_first, launches_revisit = revisit_run(card, ref_loop["revisit"],
                                                         revisit_frames)
    rv_cam, rv_cfg = rv.cam, rv.loop_closer.cfg
    del rv
    phase("6c loop closing: the merge world")
    launches_merge, ate_merge = merge_run(card)
    phase("6e loop closing: the relocalization world")
    reloc = reloc_run(card, ref_loop["reloc"])
    phase("6d loop closing: the first correction again, its verification against the CPU")
    hot = loop_reproducibility(rv_first, load_vocab("revisit"), rv_cfg, rv_cam, card)
    phase("6f distributed global BA: one NCCL rank, two gloo ranks on the card")
    dgba = distributed_gba_phase(rv_first, rv_cfg, rv_cam, card)
    del rv_first

    phase("8 EuRoC ingest: the runs' results")
    euroc = euroc_finish(euroc_handle)
    phase("9, 10 the fleet and the entry points: their results")
    fleet = phase_finish(fleet_handle, "fleet")
    entries = fleet.pop("entry")
    phase("11 (a), (b) SlamSystem: their results")
    slam_sys = phase_finish(ss_handle, "SlamSystem", timeout_s=900.0)
    phase("12 scripts/eval_suite_torch.py's runs: their results")
    evals = phase_finish(eval_handle, "eval", timeout_s=900.0)
    phase("11 (c) scripts/profile_pipeline_torch.py at full width: the stages, host wall and "
          "device-inclusive")
    stages = profile_phase(card)

    phase("5d the main run resumed from its checkpoint, with the profiler window (last)")
    us_frame = resume_and_profile(world, *main_frames, vi, ckpt, saved, card)
    ckpt_dir.cleanup()
    del vi

    # ---- 7. the odometry paths against their JAX references (last, so a
    # failing run still shows where its time went)
    phase("7 accuracy")
    draws = {}
    for path, ref, n_run in (("stereo", ref_stereo, STEREO_FRAMES),
                             ("stereo-inertial", ref_vi, MAIN_FRAMES)):
        draws[path] = [dict(seed=None, jax=prefix_record(ref, n_run, gt_p),
                            **records[(path, None)])]
        log_accuracy(path, draws[path])
    for path in draws:
        check_accuracy(path, draws[path])
    check_session(session, ref_session)

    log(json.dumps({"kernels": [{
        "name": "fast_nms", "route": "cuda", "source": "orbslam3_tpu_torch/csrc/fast_nms.cu",
        "replaces": "orbslam3_tpu/ops/fast_pallas.py:147", "launches": launches_revisit,
        "launches_by_path": {"stereo": launches_stereo, "stereo_inertial": launches,
                             "loop_bench_chunk8": launches_chunk,
                             "loop_revisit_chunk8": launches_revisit,
                             "loop_merge": launches_merge, "loop_reloc": reloc["launches"],
                             "euroc_full_width": euroc["full"]["launches"],
                             "euroc_loop_jax_vocab": euroc["loop_jax_vocab"]["launches"],
                             "euroc_loop_own_vocab": euroc["loop_own_vocab"]["launches"],
                             "detect_orb_vocab_training": euroc["vocab_training"]["launches"],
                             "fleet": fleet["launches"],
                             "slam_system_draw1": slam_sys["full"]["draw1"]["launches"],
                             "slam_system_noise_free":
                                 slam_sys["full"]["noise_free"]["launches"],
                             **{f"slam_system_{k}": v["launches"]
                                for k, v in slam_sys["worlds"].items()},
                             "eval": sum(v["launches"] for v in evals.values()),
                             "profile_pipeline_process_frame": round(
                                 stages["full process_frame"]["launches"]
                                 * stages["full process_frame"]["calls"])},
        "chunk8": {**kern16, "frames_per_s": fps_chunk, "chunk1_frames_per_s": fps},
        "loop": {"bench_warmup_s": warm_a, "revisit": {k: v for k, v in rv_rec.items()
                                                        if k != "corrections"},
                 "merge_post_ate_m": ate_merge, "reloc": reloc, **hot},
        "euroc": {"remap": euroc["remap"], **{
            k: {f: euroc[k][f] for f in ("fps", "wall_s", "ate", "ate_raw", "ok_frac",
                                         "imu_init_frame", "keyframes", "peak_mib")}
            for k in ("full", "loop_jax_vocab", "loop_own_vocab")}},
        "fleet": {k: v for k, v in fleet.items() if k != "launches"},
        "distributed_gba": dgba, "entry": entries,
        "slam_system": {"full": slam_sys["full"], "worlds": {
            k: {f: v[f] for f in ("fps", "ate_m", "ok_frac", "imu_init_frame", "n_maps_created",
                                  "bad_imu_resets", "peak_mib")}
            for k, v in slam_sys["worlds"].items()}, "stages_ms": stages},
        "eval": evals,
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
