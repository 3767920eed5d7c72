"""Record the JAX reference for the torch port's stereo-inertial path.

Runs the JAX package's FusedSlam at chunk=1 on the bench world
(bench.py::HARD_WORLD, 752x480 stereo, 8 s at 20 Hz, seed 7, with its IMU
windows) under bench.py's odometry configuration
(orbslam3_tpu_torch/models/fused.py::BENCH_CFG): once on the rendered
frames, and once on each sensor-noise draw of them
(orbslam3_tpu_torch/io/synthetic.py::perturb_frames, seeds NOISE_SEEDS).
Writes ok_frac, ATE, map sizes, the frame at which the IMU initialized and
the gravity estimate of every draw, and the per-frame record of the
noise-free run, to orbslam3_tpu_torch/data/vi_reference.json. chip_smoke.py
holds the port's runs on the GPU, draw by draw, against this record.

The record also lists the frames of the noise-free run whose inlier count
sits within one of the keyframe policy's decay gate
(kf_inlier_ratio * ref_inliers), so a reader can see whether that run is a
knife edge like the stereo slice's (scripts/make_slice_reference.py).

    JAX_PLATFORMS=cpu python scripts/make_vi_reference.py
"""
from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "orbslam3_tpu_torch", "data", "vi_reference.json")
DURATION = 8.0
NOISE_SEEDS = (1, 2)


def gate_margins(outs, cfg):
    """Per frame, n_inliers - kf_inlier_ratio * ref_inliers in float32 (the
    decay gate of models/policy.py::keyframe_wanted), where ref_inliers is
    the match count of the last keyframe insert (n_stereo for an anchor)."""
    margins, ref, prev_mode = [], 1, 0
    for o in outs:
        margins.append(float(np.float32(int(o.n_inliers))
                             - np.float32(cfg.kf_inlier_ratio) * np.float32(ref)))
        if bool(o.is_kf):
            # a keyframe inserted from the not-initialized mode is a map anchor
            ref = max(int(o.n_stereo) if prev_mode == 0 else int(o.n_matches), 1)
        prev_mode = int(o.mode)
    return margins


def main():
    import jax

    from bench import HARD_WORLD, build_world
    from orbslam3_tpu.eval.metrics import ate_rmse
    from orbslam3_tpu.models.fused import MODE_OK, FusedSlam
    from orbslam3_tpu.models.slam import SlamConfig
    from orbslam3_tpu_torch.io.synthetic import perturb_frames

    cfg = SlamConfig(use_imu=True, kf_max_frames=6, ba_iters=3, ba_window=6, lost_timeout=5.0)
    world, times, frames, imu = build_world(DURATION)
    gt_p, _ = world.gt_trajectory()

    def run(frames_):
        slam = FusedSlam(world.cam, cfg)
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
        _, ps, _ = slam.trajectory_arrays()
        modes = slam.modes()
        draw = {"ok_frac": float((modes == MODE_OK).mean()),
                "ate_m": float(ate_rmse(ps, gt_p[: len(ps)])),
                "n_kf": int(slam.map.n_kf), "n_mp": int(slam.map.n_mp),
                "n_kf_valid": int(np.asarray(slam.map.kf_valid).sum()),
                "imu_initialized": bool(slam.imu_initialized), "imu_init_frame": init_frame,
                "gravity_w": np.asarray(slam.ts.gravity_w, np.float64).round(5).tolist(),
                "bias_g": np.asarray(slam.ts.bg, np.float64).round(6).tolist(),
                "bias_a": np.asarray(slam.ts.ba, np.float64).round(6).tolist()}
        return slam, ps, modes, draw, wall

    slam, ps, modes, clean, wall = run(frames)
    _, outs, _ = slam._flat_outs()
    draws = [{"seed": None, **clean}]
    for seed in NOISE_SEEDS:
        draws.append({"seed": seed, **run(perturb_frames(frames, seed))[3]})
    margins = gate_margins(outs, cfg)
    rec = {
        "world": {"duration_s": DURATION, "cam_hz": world.cfg.cam_hz,
                  "width": world.cfg.width, "height": world.cfg.height,
                  "seed": world.cfg.seed, "n_landmarks": world.cfg.n_landmarks,
                  "hard_world": HARD_WORLD},
        "config": "BENCH_CFG: SlamConfig(use_imu=True, kf_max_frames=6, ba_iters=3, "
                  "ba_window=6, lost_timeout=5.0), chunk=1, service_every=8",
        "n_frames": int(len(times)),
        **clean,
        "backend": jax.default_backend(),
        "note": "accuracy reference only; the CPU wall time is not a speed figure",
        "cpu_wall_s": round(wall, 1),
        "noise": "perturb_frames(frames, seed, frac=1e-3)",
        "near_gate_frames": [i for i, m in enumerate(margins)
                             if abs(m) <= 1.0 and int(modes[i]) == MODE_OK
                             and int(outs[i].n_inliers) > cfg.kf_min_inliers],
        "draws": draws,
        "per_frame": {
            "mode": modes.tolist(),
            "is_kf": [int(o.is_kf) for o in outs],
            "n_features": [int(o.n_features) for o in outs],
            "n_matches": [int(o.n_matches) for o in outs],
            "n_inliers": [int(o.n_inliers) for o in outs],
            "gate_margin": [round(m, 4) for m in margins],
            "p": np.round(ps.astype(np.float64), 5).tolist(),
        },
    }
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    with open(OUT, "w") as f:
        f.write(dumps(rec) + "\n")
    print(json.dumps({k: v for k, v in rec.items() if k != "per_frame"}))


def dumps(rec: dict) -> str:
    """Indented JSON with each draw and each per-frame list on one line."""
    head = json.dumps({k: v for k, v in rec.items() if k not in ("draws", "per_frame")},
                      indent=1)
    draws = ",\n".join(f"  {json.dumps(d)}" for d in rec["draws"])
    rows = ",\n".join(f"  {json.dumps(k)}: {json.dumps(v)}" for k, v in rec["per_frame"].items())
    return (head[:-2] + ',\n "draws": [\n' + draws + '\n ],\n "per_frame": {\n' + rows
            + "\n }\n}")


if __name__ == "__main__":
    main()
