"""Record the JAX reference for the torch port's long-session path.

Runs the JAX package's FusedSlam at chunk=1 on the first N_FRAMES frames of
the bench world (bench.py::HARD_WORLD, 752x480 stereo, 20 Hz, seed 7, with
its IMU windows) under bench.py's odometry configuration with a map of 16
keyframe rows (orbslam3_tpu_torch/models/fused.py::BENCH_CFG with
cap=MapCapacity(max_kf=16)): the capacity margin (12 rows) is reached near
frame 70, so compaction and the keyframe pressure evictions fire by
themselves through the host services. Once on the rendered frames and once
on each sensor-noise draw of them (perturb_frames, seeds NOISE_SEEDS).
Writes, for every draw, ok_frac, the ATE of the corrected and of the raw
trajectory, the counters (compactions, kf_evictions, mp_evictions,
map_evictions), the keyframe rows in use after each compaction pass, the
final map sizes and the frame at which the IMU initialized, to
orbslam3_tpu_torch/data/session_reference.json. chip_smoke.py holds the
port's run on the GPU against this record.

    JAX_PLATFORMS=cpu python scripts/make_session_reference.py
"""
from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "orbslam3_tpu_torch", "data", "session_reference.json")
DURATION = 8.0
N_FRAMES = 104
MAX_KF = 16
NOISE_SEEDS = (1, 2)


def main():
    import jax

    from bench import HARD_WORLD, build_world
    from orbslam3_tpu.eval.metrics import ate_rmse
    from orbslam3_tpu.map.slam_map import MapCapacity
    from orbslam3_tpu.models.fused import MODE_OK, FusedSlam
    from orbslam3_tpu.models.slam import SlamConfig
    from orbslam3_tpu_torch.io.synthetic import perturb_frames

    cfg = SlamConfig(use_imu=True, kf_max_frames=6, ba_iters=3, ba_window=6, lost_timeout=5.0,
                     cap=MapCapacity(max_kf=MAX_KF))
    world, times, frames, imu = build_world(DURATION)
    times, frames, imu = times[:N_FRAMES], frames[:N_FRAMES], imu[:N_FRAMES]
    gt_p, _ = world.gt_trajectory()

    def run(frames_):
        slam = FusedSlam(world.cam, cfg)
        n_kf_after = []
        compact_once = slam._compact_once

        def counted():
            compact_once()
            n_kf_after.append(int(slam.map.n_kf))

        slam._compact_once = counted
        t0 = time.perf_counter()
        init_frame = None
        for i, t in enumerate(times):
            g, a, d = imu[i]
            slam.process_frame(frames_[i][0], frames_[i][1], g, a, d, float(t))
            if init_frame is None and slam.imu_initialized:
                init_frame = i
        slam.finalize()
        jax.block_until_ready(slam.ts.q)
        wall = time.perf_counter() - t0
        _, ps, _ = slam.trajectory_arrays(corrected=True)
        _, ps_raw, _ = slam.trajectory_arrays(corrected=False)
        modes = slam.modes()
        return {"ok_frac": float((modes == MODE_OK).mean()),
                "ate_m": float(ate_rmse(ps, gt_p[: len(ps)])),
                "ate_raw_m": float(ate_rmse(ps_raw, gt_p[: len(ps)])),
                "n_kf": int(slam.map.n_kf), "n_mp": int(slam.map.n_mp),
                "n_kf_valid": int(np.asarray(slam.map.kf_valid).sum()),
                "keyframes_inserted": int(sum(int(o.is_kf) for o in slam._flat_outs()[1])),
                "compactions": int(slam.compactions),
                "n_kf_after_pass": n_kf_after,
                "kf_evictions": int(getattr(slam, "kf_evictions", 0)),
                "mp_evictions": int(getattr(slam, "mp_evictions", 0)),
                "map_evictions": int(getattr(slam, "map_evictions", 0)),
                "imu_initialized": bool(slam.imu_initialized), "imu_init_frame": init_frame,
                "cpu_wall_s": round(wall, 1)}

    draws = [{"seed": None, **run(frames)}]
    for seed in NOISE_SEEDS:
        draws.append({"seed": seed, **run(perturb_frames(frames, seed))})
    rec = {
        "world": {"duration_s": DURATION, "cam_hz": world.cfg.cam_hz,
                  "width": world.cfg.width, "height": world.cfg.height,
                  "seed": world.cfg.seed, "n_landmarks": world.cfg.n_landmarks,
                  "hard_world": HARD_WORLD},
        "config": "BENCH_CFG._replace(cap=MapCapacity(max_kf=16)), chunk=1, service_every=8",
        "n_frames": N_FRAMES,
        "backend": jax.default_backend(),
        "note": "accuracy reference only; the CPU wall time is not a speed figure",
        "noise": "perturb_frames(frames, seed, frac=1e-3)",
        "draws": draws,
    }
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    head = json.dumps({k: v for k, v in rec.items() if k != "draws"}, indent=1)
    body = ",\n".join(f"  {json.dumps(d)}" for d in draws)
    with open(OUT, "w") as f:
        f.write(head[:-2] + ',\n "draws": [\n' + body + "\n ]\n}\n")
    print(json.dumps(rec))


if __name__ == "__main__":
    main()
