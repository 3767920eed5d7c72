"""The JAX package's behaviour scenarios, run on the torch port.

Each scenario is the world, configuration and constructor arguments of one
of the JAX package's `slow` end-to-end tests, letter for letter, with its
event (a camera blackout, a poisoned tracker state) made through the port's
own API:

  blackout_bridge      tests/test_recovery.py::test_blackout_bridged_with_imu_keyframes
  poisoned_ransac      tests/test_recovery.py::test_poisoned_motion_model_recovers_via_ransac
  static_bad_imu       tests/test_recovery.py::test_static_start_triggers_bad_imu_reset
  imu_refine           tests/test_imu_refine.py::test_imu_refinement_phases_fire_and_hold_gravity
  hover_cull           tests/test_kf_cull.py::test_hover_bounds_keyframe_count
  kf_capacity_guard    tests/test_fused.py::test_keyframe_capacity_guard
  long_run_compacts    tests/test_compaction.py::test_fused_long_run_compacts
  long_run_evicts      the same world at max_mp=LONG_RUN_EVICTS_MAX_MP, where the
                       stale-point eviction fires in the JAX run
  orbvoc_scale         tests/test_vocab_scale.py::test_orbvoc_scale_load_and_descent

and two at full width (752x480, 1024 features, 8 levels) on
bench.py::HARD_WORLD under BENCH_CFG, built with no `device`, their events
after the IMU initializes:

  blackout_bridge_full   frames blank over 4.0-4.7 s, 120 frames
  poisoned_ransac_full   test_recovery.py's poison at t = 4.0 s, 120 frames

scripts/make_scenario_reference.py runs every scenario through the JAX
package on the CPU and writes orbslam3_tpu_torch/data/scenario_reference.json
(and the RANSAC-seed draws of the poisoned runs beside it); `holds` checks a
port run against the JAX test's own bars and the record's structural facts.
chip_smoke.py (phase 13) runs every scenario on the card, and
tests/test_torch_scenarios_slow.py on the CPU.
"""
from __future__ import annotations

import hashlib
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

DATA = os.path.join(ROOT, "orbslam3_tpu_torch", "data")
REFERENCE = os.path.join(DATA, "scenario_reference.json")
DRAWS = os.path.join(DATA, "scenario_draws.npz")

# bench.py::HARD_WORLD (chip_smoke.HARD_WORLD), the bench world of 8 s at 20 Hz
HARD_WORLD = dict(texture="textured", exposure_drift=0.3, image_noise_std=3.0,
                  salt_pepper_frac=0.002, motion_blur_samples=3, exposure_time=0.02)
BENCH_WORLD = dict(duration=8.0, n_landmarks=1500, **HARD_WORLD)
# models/fused.py::BENCH_CFG (bench.py's odometry configuration)
BENCH_CFG = dict(use_imu=True, kf_max_frames=6, ba_iters=3, ba_window=6, lost_timeout=5.0)

_SMALL = dict(width=384, height=256, fx=240.0, fy=240.0, n_landmarks=600, duration=5.0,
              cam_hz=10.0, pos_amp=(1.2, 0.8, 0.3))
_ORB = dict(n_features=384, n_levels=4)
_CAP = dict(max_kf=64, n_feat=384, max_mp=8192, max_obs=8)
_SMALL_CFG = dict(orb=_ORB, cap=_CAP, track=dict(p_local=2048), ba_points=1024)
_COMPACT_WORLD = dict(width=256, height=192, fx=160.0, fy=160.0, n_landmarks=400, duration=6.0,
                      cam_hz=10.0, pos_amp=(0.5, 0.4, 0.2))
_COMPACT_CFG = dict(orb=dict(n_features=256, n_levels=3),
                    cap=dict(max_kf=16, n_feat=256, max_mp=2048, max_obs=8),
                    track=dict(p_local=1024), ba_points=512, use_imu=False, kf_max_frames=2,
                    new_mp_budget=128, kf_cull_redundancy=0.5)
# long_run_compacts' world at a max_mp where the stale-point eviction fires,
# the local map's p_local cut to it (the tracker takes at most max_mp
# points). None of 640-1920 evicts in the JAX run; 512-635 do
# (make_scenario_reference.py --probe-evicts). This world turns a last-bit
# change into centimetres of drift from frame 21 on, and the eviction is a
# knife edge above 576: at 635 and 608 the JAX run evicts 9 points, the JAX
# run with the camera's fx one float32 ulp away (scripts/scenario_witness.py)
# none at 635, and the port's CPU run none at 608; at 576 all three evict
# (9, 5, 12)
LONG_RUN_EVICTS_MAX_MP = 576
# test_recovery.py:110-118: ~31 degrees and 1 m off, a wrong motion model
POISON = dict(axis_angle=(0.0, 0.5, 0.2), dp=(0.8, -0.6, 0.4),
              motion_axis_angle=(0.2, -0.1, 0.3), motion_dp=(0.5, 0.5, -0.3))

# name -> world (SyntheticConfig fields, or "bench"), cfg (SlamConfig fields
# with orb/cap/track as dicts, or BENCH_CFG's), FusedSlam's service_every,
# whether process_frame gets the IMU windows, frames (None: all), and the
# event: a blackout (t0, t1) of blank 127 frames or a poison time
SCENARIOS = {
    "blackout_bridge": dict(
        source="tests/test_recovery.py:20", world=_SMALL,
        cfg=dict(_SMALL_CFG, use_imu=True, kf_max_frames=2, imu_init_kfs=8, lost_timeout=1.5),
        service_every=4, imu=True, blackout=(3.0, 3.7)),
    "poisoned_ransac": dict(
        source="tests/test_recovery.py:80", world=_SMALL,
        cfg=dict(_SMALL_CFG, use_imu=False, kf_max_frames=2, lost_timeout=2.0),
        service_every=4, imu=False, poison_t=3.0),
    "static_bad_imu": dict(
        source="tests/test_recovery.py:144",
        world=dict(width=256, height=192, fx=160.0, fy=160.0, n_landmarks=400, duration=13.0,
                   cam_hz=4.0, pos_amp=(0.0, 0.0, 0.0), yaw_amp=0.0, rp_amp=0.0),
        cfg=dict(orb=dict(n_features=256, n_levels=3),
                 cap=dict(max_kf=64, n_feat=256, max_mp=4096, max_obs=8),
                 track=dict(p_local=1024), ba_points=512, use_imu=True, kf_max_frames=2,
                 imu_init_kfs=6, bad_imu_timeout=8.0),
        service_every=4, imu=True),
    "imu_refine": dict(
        source="tests/test_imu_refine.py:18",
        world=dict(_SMALL, duration=7.0, gyro_bias=(0.004, -0.003, 0.002),
                   accel_bias=(0.04, -0.03, 0.02)),
        cfg=dict(_SMALL_CFG, cap=dict(_CAP, max_kf=96), use_imu=True, kf_max_frames=2,
                 imu_init_kfs=6, imu_init_min_time=0.8),
        service_every=4, imu=True),
    "hover_cull": dict(
        source="tests/test_kf_cull.py:84",
        world=dict(width=384, height=256, fx=240.0, fy=240.0, n_landmarks=500, duration=8.0,
                   cam_hz=10.0, pos_amp=(0.08, 0.06, 0.03), yaw_amp=0.05, rp_amp=0.02),
        cfg=dict(_SMALL_CFG, use_imu=False, kf_max_frames=2),
        service_every=4, imu=False),
    "kf_capacity_guard": dict(
        source="tests/test_fused.py:58",
        world=dict(width=384, height=256, fx=240.0, fy=240.0, n_landmarks=400, duration=2.0,
                   cam_hz=10.0),
        cfg=dict(orb=dict(n_features=256, n_levels=3),
                 cap=dict(max_kf=4, n_feat=256, max_mp=2048, max_obs=8),
                 track=dict(p_local=1024), ba_points=512, use_imu=False, kf_max_frames=1),
        service_every=8, imu=False),
    "long_run_compacts": dict(
        source="tests/test_compaction.py:131", world=_COMPACT_WORLD, cfg=_COMPACT_CFG,
        service_every=4, imu=False),
    "long_run_evicts": dict(
        source="tests/test_compaction.py:131 at max_mp=LONG_RUN_EVICTS_MAX_MP",
        world=_COMPACT_WORLD,
        cfg=dict(_COMPACT_CFG, cap=dict(_COMPACT_CFG["cap"], max_mp=LONG_RUN_EVICTS_MAX_MP),
                 track=dict(p_local=LONG_RUN_EVICTS_MAX_MP)),
        service_every=4, imu=False),
    "blackout_bridge_full": dict(
        source="bench.py::HARD_WORLD, BENCH_CFG", world="bench", cfg="bench", service_every=8,
        imu=True, frames=120, blackout=(4.0, 4.7)),
    "poisoned_ransac_full": dict(
        source="bench.py::HARD_WORLD, BENCH_CFG", world="bench", cfg="bench", service_every=8,
        imu=True, frames=120, poison_t=4.0),
}
RUNS = tuple(SCENARIOS)
ORBVOC = "orbvoc_scale"
ORBVOC_K, ORBVOC_L, ORBVOC_QUERIES = 10, 6, 1024


def build(pkg: dict, name: str):
    """SCENARIOS[name]'s world and SlamConfig from either package's classes:
    `pkg` holds SyntheticConfig, SyntheticWorld, SlamConfig, OrbConfig,
    MapCapacity and TrackConfig. Returns (world, SlamConfig, frame times)."""
    spec = SCENARIOS[name]
    wkw = BENCH_WORLD if spec["world"] == "bench" else spec["world"]
    if spec["cfg"] == "bench":
        cfg = pkg["SlamConfig"](**BENCH_CFG)
    else:
        ckw = dict(spec["cfg"])
        ckw.update(orb=pkg["OrbConfig"](**ckw["orb"]), cap=pkg["MapCapacity"](**ckw["cap"]),
                   track=pkg["TrackConfig"](**ckw["track"]))
        cfg = pkg["SlamConfig"](**ckw)
    world = pkg["SyntheticWorld"](pkg["SyntheticConfig"](**wkw))
    times = world.frame_times()
    if spec.get("frames"):
        times = times[:spec["frames"]]
    return world, cfg, times


def port_pkg() -> dict:
    from orbslam3_tpu_torch.frontend.orb import OrbConfig
    from orbslam3_tpu_torch.io.synthetic import SyntheticConfig, SyntheticWorld
    from orbslam3_tpu_torch.map.slam_map import MapCapacity
    from orbslam3_tpu_torch.models.slam import SlamConfig
    from orbslam3_tpu_torch.models.tracker import TrackConfig

    return dict(SyntheticConfig=SyntheticConfig, SyntheticWorld=SyntheticWorld,
                SlamConfig=SlamConfig, OrbConfig=OrbConfig, MapCapacity=MapCapacity,
                TrackConfig=TrackConfig)


def render(world, times, name: str, workers: int = 2) -> list:
    """The scenario's frames as process_frame gets them: uint8 stereo pairs,
    flat 127 inside its blackout (render_frame's float32 images truncated to
    uint8, as FusedSlam does)."""
    return world.render_sequence(times, blackout=SCENARIOS[name].get("blackout"),
                                 workers=workers)


_WORLDS: dict = {}


def _pool_init(worlds: dict):
    global _WORLDS
    _WORLDS = worlds


def _render_task(task):
    name, t = task
    return tuple(x.astype(np.uint8) for x in _WORLDS[name].render_frame(t))


def render_many(names, workers: int = 4, bench_frames=None) -> dict:
    """`render` for several scenarios at once, in one pool of spawned worker
    processes: {name: frames}. The bench-world scenarios take `bench_frames`
    (the bench world's rendered uint8 pairs, from frame 0) where given,
    blank inside their blackout, instead of rendering them again."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    pkg = port_pkg()
    worlds, tasks, out = {}, [], {}
    for name in names:
        world, _, times = build(pkg, name)
        blackout = SCENARIOS[name].get("blackout")
        dark = [blackout is not None and blackout[0] <= t < blackout[1] for t in times]
        blank = np.full((world.cfg.height, world.cfg.width), 127, np.uint8)
        if SCENARIOS[name]["world"] == "bench" and bench_frames is not None:
            out[name] = [(blank, blank) if d else bench_frames[i] for i, d in enumerate(dark)]
            continue
        worlds[name] = world
        out[name] = [(blank, blank) if d else None for d in dark]
        tasks += [(name, i, t) for i, (t, d) in enumerate(zip(times, dark)) if not d]
    if tasks:
        with ProcessPoolExecutor(workers, mp_context=multiprocessing.get_context("spawn"),
                                 initializer=_pool_init, initargs=(worlds,)) as ex:
            pairs = ex.map(_render_task, [(n, t) for n, _, t in tasks], chunksize=4)
            for (name, i, _), pair in zip(tasks, pairs):
                out[name][i] = pair
    return out


def checksum(img) -> str:
    """The first 8 hex digits of the SHA-256 of an image's uint8 bytes."""
    return hashlib.sha256(np.ascontiguousarray(img, dtype=np.uint8).tobytes()).hexdigest()[:8]


def poison(slam, arr, quat):
    """test_recovery.py:110-118 on a FusedSlam of either package: the tracker's
    pose ~31 degrees and 1 m off, a wrong motion model. `arr` makes a float32
    vector of the package (on the system's device), `quat` is its quaternion
    module. The buffered frames are dispatched first (`flush`), so that the
    state mutated is the one after the last frame."""
    slam.flush()
    dq = quat.from_axis_angle(arr(POISON["axis_angle"]))
    slam.ts = slam.ts._replace(
        q=quat.normalize(quat.mul(slam.ts.q, dq)),
        p=slam.ts.p + arr(POISON["dp"]),
        motion_dq=quat.from_axis_angle(arr(POISON["motion_axis_angle"])),
        motion_dp=arr(POISON["motion_dp"]))


def drive(slam, world, times, frames, name: str, arr, quat, n: int | None = None) -> dict:
    """process_frame over the scenario's first `n` frames (all by default)
    on a FusedSlam of either package, its event included, then `flush` (as
    the JAX tests end). Returns the
    frames after which the IMU initialized, each bad-IMU reset, each IMU
    refine and each compaction pass happened (host counters read after each
    frame)."""
    spec = SCENARIOS[name]
    poison_t = spec.get("poison_t")
    none3, none1 = np.zeros((0, 3)), np.zeros(0)
    events = dict(imu_init_frame=None, reset_frames=[], refine_frames=[], compaction_frames=[])
    counts = dict(reset_frames="bad_imu_resets", refine_frames="imu_refines",
                  compaction_frames="compactions")
    seen = {k: 0 for k in counts}
    poisoned = False
    for i, t in enumerate(times[:n]):
        if poison_t is not None and not poisoned and t >= poison_t:
            poison(slam, arr, quat)
            poisoned = True
        left, right = frames[i]
        if spec["imu"]:
            g, a, d = world.imu_window(times[i - 1] if i > 0 else t, t)
        else:
            g, a, d = none3, none3, none1
        slam.process_frame(left, right, g, a, d, float(t))
        if events["imu_init_frame"] is None and slam.imu_initialized:
            events["imu_init_frame"] = i
        for k, attr in counts.items():
            c = int(getattr(slam, attr, 0))
            events[k] += [i] * (c - seen[k])
            seen[k] = c
    slam.flush()
    return events


def _host(x):
    return np.asarray(x.cpu() if hasattr(x, "is_cuda") else x)


def record(slam, world, times, frames, name: str, events: dict) -> dict:
    """What a scenario run of either package's FusedSlam ended with: per
    frame t, tracker mode, keyframe flag, inliers, raw pose and the left
    image's checksum; at the end the IMU (initialized, frame, gravity,
    biases), the host services' counters, the keyframe rows, the atlas
    size, and the JAX test's quantities (ATE of the raw poses against the
    ground truth, OK shares, the gravity direction's error)."""
    from orbslam3_tpu_torch.eval.metrics import ate_rmse
    from orbslam3_tpu_torch.io.synthetic import _qrot

    spec = SCENARIOS[name]
    ts_, outs, _ = slam._flat_outs()
    ts_ = np.asarray(ts_, np.float64)
    if isinstance(outs, list):  # the JAX package: one FrameOut a frame
        outs = type(outs[0])(*[np.stack([np.asarray(getattr(o, f)) for o in outs])
                               for f in outs[0]._fields])
    modes = np.asarray(outs.mode).astype(int)
    ps = np.asarray(outs.p, np.float64)
    gt_p, _ = world.gt_trajectory()
    gt_p = gt_p[:len(ps)]
    m = slam.map
    valid = _host(m.kf_valid)
    q0, _ = world.gt_pose(0.0)
    g_true = _qrot(np.asarray(q0, np.float64) * [1, -1, -1, -1], np.array([0.0, 0.0, -9.81]))
    g = _host(slam.ts.gravity_w).astype(np.float64)
    g_err = float(np.degrees(np.arccos(np.clip(
        g_true @ g / (np.linalg.norm(g_true) * np.linalg.norm(g)), -1.0, 1.0))))
    ok = modes == 1
    rec = dict(
        frames=len(ts_), ate_m=float(ate_rmse(ps, gt_p)), ok_frac=float(ok.mean()),
        imu_initialized=bool(slam.imu_initialized), **events,
        imu_refines=int(getattr(slam, "imu_refines", 0)),
        bad_imu_resets=int(getattr(slam, "bad_imu_resets", 0)),
        compactions=int(slam.compactions),
        kf_evictions=int(getattr(slam, "kf_evictions", 0)),
        mp_evictions=int(getattr(slam, "mp_evictions", 0)),
        map_evictions=int(getattr(slam, "map_evictions", 0)),
        n_kf=int(_host(m.n_kf)), n_kf_valid=int(valid.sum()), n_mp=int(_host(m.n_mp)),
        next_map_id=int(_host(m.next_map_id)),
        gravity_w=g.tolist(), gravity_err_deg=g_err,
        bg=_host(slam.ts.bg).astype(np.float64).tolist(),
        ba=_host(slam.ts.ba).astype(np.float64).tolist())
    if "blackout" in spec:
        b0, b1 = spec["blackout"]
        inside = (ts_ >= b0) & (ts_ < b1)
        post = ts_ > b1 + 0.4
        rec.update(blackout_kfs=int(np.asarray(outs.is_kf)[inside].sum()),
                   ok_frac_post=float(ok[post].mean()) if post.any() else None)
    if "poison_t" in spec:
        tail = ts_ >= spec["poison_t"] + 0.5
        rec.update(ok_frac_post=float(ok[tail].mean()) if tail.any() else None,
                   ate_tail_m=float(ate_rmse(ps[tail], gt_p[tail])) if tail.sum() >= 3 else None)
    rec["per_frame"] = dict(
        t=ts_.tolist(), mode=modes.tolist(), is_kf=np.asarray(outs.is_kf).astype(int).tolist(),
        n_inliers=np.asarray(outs.n_inliers).astype(int).tolist(),
        p=np.round(ps, 7).tolist(), q=np.round(np.asarray(outs.q, np.float64), 7).tolist(),
        checksum=[checksum(f[0]) for f in frames[:len(ts_)]])
    return rec


def test_bars(name: str, rec: dict, world_cfg) -> list:
    """The JAX test's own bars on a scenario record, as (label, held)."""
    if name == "blackout_bridge":
        return [("IMU initialized", rec["imu_initialized"]),
                ("next_map_id == 1", rec["next_map_id"] == 1),
                (">= 1 keyframe inside the blackout", rec["blackout_kfs"] >= 1),
                ("ok_frac after the blackout > 0.8", rec["ok_frac_post"] > 0.8),
                ("ATE < 0.12 m", rec["ate_m"] < 0.12)]
    if name == "poisoned_ransac":
        return [("ok_frac from 0.5 s after the poison > 0.9", rec["ok_frac_post"] > 0.9),
                ("ATE from 0.5 s after the poison < 0.12 m", rec["ate_tail_m"] < 0.12)]
    if name == "static_bad_imu":
        return [("IMU not initialized", not rec["imu_initialized"]),
                (">= 1 bad-IMU reset", rec["bad_imu_resets"] >= 1)]
    if name == "imu_refine":
        return [("IMU initialized", rec["imu_initialized"]),
                (">= 1 IMU refine", rec["imu_refines"] >= 1),
                ("gravity within 3 deg", rec["gravity_err_deg"] < 3.0),
                ("bg within 1.2e-2", bool(np.all(np.abs(np.asarray(rec["bg"]) - np.asarray(
                    world_cfg.gyro_bias)) <= 1.2e-2)))]
    if name == "hover_cull":
        return [("ok_frac > 0.9", rec["ok_frac"] > 0.9),
                ("<= 16 live keyframes", rec["n_kf_valid"] <= 16),
                ("culling fired (n_kf > live)", rec["n_kf"] > rec["n_kf_valid"])]
    if name == "kf_capacity_guard":
        return [("n_kf <= 4", rec["n_kf"] <= 4),
                ("the last 5 frames tracked", all(m != 0 for m in rec["per_frame"]["mode"][-5:]))]
    if name in ("long_run_compacts", "long_run_evicts"):
        return [(">= 1 compaction", rec["compactions"] >= 1),
                ("ok_frac > 0.85", rec["ok_frac"] > 0.85), ("n_kf <= 16", rec["n_kf"] <= 16)]
    return []  # the full-width runs: held to their record alone


def band(ate_jax: float) -> float:
    """PERF.md section 2's band: within max(0.02 m, 0.5 ATE_jax)."""
    return max(0.02, 0.5 * ate_jax)


def record_facts(name: str, rec: dict, ref: dict) -> list:
    """The JAX record's structural facts on a port record, as (label, held):
    the atlas size and bad-IMU resets as the record's, the IMU's frame
    within one service round of it, a refine, keyframes inside the blackout,
    a compaction and each kind of eviction wherever the record has them,
    ok_frac >= the record's - 0.05, and ATE by the band rule."""
    se = SCENARIOS[name]["service_every"]
    out = [(f"next_map_id {ref['next_map_id']} as the record", rec["next_map_id"]
            == ref["next_map_id"]),
           (f"bad_imu_resets {ref['bad_imu_resets']} as the record", rec["bad_imu_resets"]
            == ref["bad_imu_resets"]),
           (f"imu_initialized {ref['imu_initialized']} as the record", rec["imu_initialized"]
            == ref["imu_initialized"])]
    if ref["imu_init_frame"] is not None:
        out.append((f"IMU after a frame within {se} of the record's {ref['imu_init_frame']}",
                    rec["imu_init_frame"] is not None
                    and abs(rec["imu_init_frame"] - ref["imu_init_frame"]) <= se))
    if ref["reset_frames"]:
        out.append((f"first bad-IMU reset within {se} frames of the record's "
                    f"{ref['reset_frames'][0]}", bool(rec["reset_frames"]) and abs(
                        rec["reset_frames"][0] - ref["reset_frames"][0]) <= se))
    if ref["imu_refines"] >= 1:
        out.append((">= 1 IMU refine as the record", rec["imu_refines"] >= 1))
    if ref.get("blackout_kfs", 0) >= 1:
        out.append((">= 1 dead-reckoning keyframe in the blackout as the record",
                    rec["blackout_kfs"] >= 1))
    for k in ("compactions", "kf_evictions", "mp_evictions", "map_evictions"):
        if ref[k] >= 1:
            out.append((f"{k} >= 1 as the record ({ref[k]})", rec[k] >= 1))
    out.append((f"ok_frac >= the record's {ref['ok_frac']:.4f} - 0.05",
                rec["ok_frac"] >= ref["ok_frac"] - 0.05))
    out.append((f"ATE within {band(ref['ate_m']):.4f} m of the record's {ref['ate_m']:.5f}",
                abs(rec["ate_m"] - ref["ate_m"]) <= band(ref["ate_m"])))
    return out


def holds(name: str, rec: dict, ref: dict, world_cfg) -> list:
    """Every hold of a scenario run: the JAX test's bars on the port's run,
    the JAX test's bars on the record (a record that fails its own test's
    bars cannot stand in for it), and the record's structural facts."""
    return (test_bars(name, rec, world_cfg)
            + [("the JAX record meets the test's bars", all(ok for _, ok in test_bars(
                name, ref, world_cfg)))]
            + record_facts(name, rec, ref))


def first_departure(rec: dict, ref: dict, pos_tol: float = 5e-3) -> str:
    """The first frame where a run leaves its record: the left image, or
    the tracker mode, keyframe flag or inlier count, or the position by
    more than `pos_tol`; 'none' if it never does."""
    pf, rf = rec["per_frame"], ref["per_frame"]
    for i in range(min(len(pf["mode"]), len(rf["mode"]))):
        if pf["checksum"][i] != rf["checksum"][i]:
            return f"frame {i} (left image checksum)"
        got = [pf[k][i] for k in ("mode", "is_kf", "n_inliers")]
        want = [rf[k][i] for k in ("mode", "is_kf", "n_inliers")]
        if got != want:
            return f"frame {i} (mode, keyframe, inliers: port {got}, JAX {want})"
        dp = float(np.linalg.norm(np.subtract(pf["p"][i], rf["p"][i])))
        if dp > pos_tol:
            return f"frame {i} (position {dp:.4f} m away)"
    return "none"


# ---------------------------------------------------------------- ORBvoc
def orbvoc_text(path: str):
    """tests/test_vocab_scale.py's synthesized ORBvoc.txt-shaped DBoW2 text
    (k=10, L=6: 1,111,110 nodes, 10^6 leaves, random descriptors from
    default_rng(1), leaf weight 1.0) written to `path`. Returns the 1024
    query descriptors the test draws next from the same generator."""
    k, L = ORBVOC_K, ORBVOC_L
    rng = np.random.default_rng(1)
    n_nodes = sum(k ** (lv + 1) for lv in range(L))
    descs = rng.integers(0, 256, (n_nodes, 32), dtype=np.uint8)
    offsets = [1]
    for lv in range(L):
        offsets.append(offsets[-1] + k ** (lv + 1))
    idx = 0
    with open(path, "w") as f:
        f.write(f"{k} {L} 0 0\n")
        for lv in range(L):
            n_lv = k ** (lv + 1)
            parents = (np.zeros(n_lv, np.int64) if lv == 0
                       else offsets[lv - 1] + np.arange(n_lv) // k)
            leaf = 1 if lv == L - 1 else 0
            rows = np.concatenate([parents[:, None], np.full((n_lv, 1), leaf),
                                   descs[idx:idx + n_lv].astype(np.int64)], axis=1)
            idx += n_lv
            np.savetxt(f, rows, fmt=" ".join(["%d"] * 34) + (" 1.0" if leaf else " 0.0"))
    return rng.integers(0, 256, (ORBVOC_QUERIES, 32), dtype=np.uint8)


def orbvoc_port(path: str, queries, device, timer=None) -> dict:
    """load_dbow2_text, quantize of the queries, bow_sparse and the
    self-score on `device`. `timer(fn)` returns (result, ms); wall time by
    default. Returns leaves, sparse ids and weights, score and times."""
    import torch

    from orbslam3_tpu_torch.loop import vocab as vb

    if timer is None:
        def timer(fn):
            t0 = time.perf_counter()
            out = fn()
            return out, 1e3 * (time.perf_counter() - t0)

    voc, load_ms = timer(lambda: vb.load_dbow2_text(path).to(device))
    q = torch.from_numpy(queries).to(device)
    ok = torch.ones(len(queries), dtype=torch.bool, device=device)
    leaves, quant_ms = timer(lambda: vb.quantize(voc, q, ok))
    ids, w = vb.bow_sparse(voc, leaves)
    s = vb.score_sparse_many(voc, ids, w, ids[None], w[None])
    return dict(n_leaves=int(voc.n_leaves), leaves=leaves.cpu().numpy().tolist(),
                ids=ids.cpu().numpy().tolist(), w=w.cpu().numpy().tolist(),
                self_score=float(s[0]), load_ms=load_ms, quantize_ms=quant_ms)


def orbvoc_holds(rec: dict, ref: dict) -> list:
    """The JAX test's bars and the record's leaf ids, as (label, held)."""
    n = ORBVOC_K ** ORBVOC_L
    leaves = np.asarray(rec["leaves"])
    return [(f"{n} leaves", rec["n_leaves"] == n),
            ("every leaf id in [0, 10^6)", bool(((leaves >= 0) & (leaves < n)).all())),
            ("self-score 1.0 within 1e-4", abs(rec["self_score"] - 1.0) <= 1e-4),
            ("leaf ids equal the record's", rec["leaves"] == ref["leaves"]),
            ("sparse ids equal the record's", rec["ids"] == ref["ids"])]


# ---------------------------------------------------------------- port runs
def load_reference(path: str = REFERENCE) -> dict:
    with open(path) as f:
        return json.load(f)


def run_port(name: str, device=None, n: int | None = None, frames=None, workers: int = 2):
    """The scenario on the port's FusedSlam: built with no `device` unless
    one is given (the card then), rendered here unless `frames` are given.
    Returns (FusedSlam, record, world)."""
    import torch

    from orbslam3_tpu_torch.geometry import quat
    from orbslam3_tpu_torch.models.fused import FusedSlam

    world, cfg, times = build(port_pkg(), name)
    if frames is None:
        frames = render(world, times, name, workers)
    kw = {} if device is None else dict(device=device)
    slam = FusedSlam(world.cam, cfg, service_every=SCENARIOS[name]["service_every"], **kw)

    def arr(x):
        return torch.tensor(x, dtype=torch.float32, device=slam.device)

    events = drive(slam, world, times, frames, name, arr, quat, n=n)
    return slam, record(slam, world, times, frames, name, events), world
