"""Record the JAX SlamSystem runs that the torch port's SlamSystem is held to.

Runs the JAX package's host-orchestrated SlamSystem (orbslam3_tpu/models/
slam.py) on the CPU over:

  full     the bench world (bench.py::HARD_WORLD, 752x480 stereo at 20 Hz,
           seed 7, with its IMU windows), its first SLAM_SYSTEM_FRAMES (104)
           frames, under the production SlamConfig() (IMU on, 1024 features,
           8 levels, MapCapacity() K=256 N=1024 M=32768): once on the rendered
           frames and once on sensor-noise draw SLAM_SYSTEM_SEED (1)
           (perturb_frames);
  stereo, inertial, atlas, extrinsics, static
           the worlds and configurations of the JAX package's SlamSystem
           tests (tests/test_e2e_stereo.py, test_e2e_inertial.py,
           test_atlas.py, test_extrinsics.py::
           test_e2e_inertial_with_euroc_extrinsics) and the static world of
           tests/test_recovery.py::test_static_start_triggers_bad_imu_reset,
           run through SlamSystem (chip_smoke.SLAM_SYSTEM_WORLDS).

The bench world's frames are rendered by the torch port's numpy copy of the
world (chip_smoke.build_world), as chip_smoke.py renders them; the test
worlds by the JAX package's, as its tests render them. For each run it writes chip_smoke.
slam_system_record: the per-frame state string, keyframe flag, match and
inlier counts, position and attitude; the ATE, ok_frac, the frame after
which the IMU initialized, gravity_w, the biases, n_maps_created,
bad_imu_resets, the map ids of the valid keyframes and the map sizes, to
orbslam3_tpu_torch/data/slam_system_reference.json. chip_smoke.py (phase
11) holds the port's SlamSystem on the card to this record.

    JAX_PLATFORMS=cpu python scripts/make_slam_system_reference.py [full|stereo|...]

With names, only those runs are made, in this process, and merged into the
existing file; without, each run is made in a process of its own (about 13
minutes in all on 8 CPU cores).
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

OUT = os.path.join(ROOT, "orbslam3_tpu_torch", "data", "slam_system_reference.json")


def jax_classes() -> dict:
    from orbslam3_tpu.frontend.orb import OrbConfig
    from orbslam3_tpu.io.synthetic import SyntheticConfig, SyntheticWorld, euroc_t_bc
    from orbslam3_tpu.map.slam_map import MapCapacity
    from orbslam3_tpu.models.slam import SlamConfig
    from orbslam3_tpu.models.tracker import TrackConfig

    return dict(SyntheticConfig=SyntheticConfig, SyntheticWorld=SyntheticWorld,
                euroc_t_bc=euroc_t_bc, SlamConfig=SlamConfig, OrbConfig=OrbConfig,
                MapCapacity=MapCapacity, TrackConfig=TrackConfig)


def run_full() -> dict:
    import numpy as np

    import chip_smoke
    from orbslam3_tpu.io.synthetic import SyntheticConfig, SyntheticWorld
    from orbslam3_tpu.models.slam import SlamConfig, SlamSystem
    from orbslam3_tpu_torch.io.synthetic import perturb_frames

    n = chip_smoke.SLAM_SYSTEM_FRAMES
    world, times, frames, imu = chip_smoke.build_world()
    times, frames, imu = times[:n], frames[:n], imu[:n]
    cam = SyntheticWorld(SyntheticConfig(duration=chip_smoke.DURATION, n_landmarks=1500,
                                         **chip_smoke.HARD_WORLD)).cam
    draws = []
    for seed in (None, chip_smoke.SLAM_SYSTEM_SEED):
        fr = frames if seed is None else perturb_frames(frames, seed)
        inputs = [(l.astype(np.float32), r.astype(np.float32), *imu[i], float(times[i]))
                  for i, (l, r) in enumerate(fr)]
        slam = SlamSystem(cam, SlamConfig())
        t0 = time.perf_counter()
        init = chip_smoke.drive_slam_system(slam, inputs)
        wall = time.perf_counter() - t0
        rec = chip_smoke.slam_system_record(slam, world, init)
        draws.append(dict(seed=seed, cpu_wall_s=round(wall, 1), **rec))
        print(f"full, draw {seed}: ATE {rec['ate_m']:.5f} m, ok_frac {rec['ok_frac']:.4f}, "
              f"IMU after frame {init}, n_kf {rec['n_kf']}, maps {rec['n_maps_created']}, "
              f"{wall:.0f} s", flush=True)
    return dict(world=dict(duration_s=chip_smoke.DURATION, width=world.cfg.width,
                           height=world.cfg.height, seed=world.cfg.seed,
                           n_landmarks=world.cfg.n_landmarks, hard_world=chip_smoke.HARD_WORLD),
                config="SlamConfig()", n_frames=n,
                noise="perturb_frames(frames, seed, frac=1e-3)", draws=draws)


def run_world(name: str) -> dict:
    import chip_smoke
    from orbslam3_tpu.models.slam import SlamSystem

    world, cfg, blackout = chip_smoke.slam_system_world(jax_classes(), name)
    inputs = chip_smoke.slam_system_inputs(world, blackout)
    slam = SlamSystem(world.cam, cfg)
    t0 = time.perf_counter()
    init = chip_smoke.drive_slam_system(slam, inputs)
    wall = time.perf_counter() - t0
    rec = chip_smoke.slam_system_record(slam, world, init, blackout)
    print(f"{name}: ATE {rec['ate_m']:.5f} m, ok_frac {rec['ok_frac']:.4f}, IMU "
          f"{rec['imu_initialized']} after frame {init}, maps {rec['n_maps_created']}, bad-IMU "
          f"resets {rec['bad_imu_resets']}, {wall:.0f} s", flush=True)
    return dict(cpu_wall_s=round(wall, 1), **rec)


def main():
    import chip_smoke

    if not sys.argv[1:]:
        # one process a run: the JAX SlamSystem compiles every eager
        # operation it dispatches, and one process holding all the runs'
        # executables ran out of mappable memory
        if os.path.exists(OUT):
            os.remove(OUT)
        for name in ["full", *chip_smoke.SLAM_SYSTEM_WORLDS]:
            subprocess.run([sys.executable, os.path.abspath(__file__), name], check=True)
        return
    import jax

    rec = {}
    if os.path.exists(OUT):
        with open(OUT) as f:
            rec = json.load(f)
    rec.update(backend=jax.default_backend(),
               note="accuracy reference only; the CPU wall time is not a speed figure")
    for name in sys.argv[1:]:
        if name == "full":
            rec["full"] = run_full()
        else:
            rec.setdefault("worlds", {})[name] = run_world(name)
        with open(OUT, "w") as f:
            json.dump(rec, f, separators=(",", ":"))
    print(f"wrote {OUT} ({os.path.getsize(OUT)} bytes)")


if __name__ == "__main__":
    main()
