"""Record the JAX reference for the torch port's stereo slice.

Runs the JAX package's FusedSlam on the bench world (bench.py::HARD_WORLD,
752x480 stereo, 8 s at 20 Hz, seed 7) with the slice configuration the
torch port supports (orbslam3_tpu_torch/models/fused.py::SLICE_CFG): once on
the rendered frames, and once on each sensor-noise draw of them
(orbslam3_tpu_torch/io/synthetic.py::perturb_frames, seeds NOISE_SEEDS).
Writes ok_frac, ATE and map sizes of every draw, and the per-frame record
(mode, keyframe flag, match and inlier counts, corrected position) of the
noise-free run, to orbslam3_tpu_torch/data/slice_reference.json.
chip_smoke.py holds the port's runs on the GPU, draw by draw, against this
record.

Why several draws: on the noise-free frames the reference sits on an exact
float32 tie of the keyframe gate (frame 56: 133 inliers against
0.7 * 190), so one match more or less anywhere before it picks the other
branch; the draws show where the reference lands when the input moves by
sensor-level noise.

    JAX_PLATFORMS=cpu python scripts/make_slice_reference.py
"""
from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "orbslam3_tpu_torch", "data", "slice_reference.json")
DURATION = 8.0
NOISE_SEEDS = (1, 2, 3, 4)


def main():
    import jax

    from bench import HARD_WORLD, build_world
    from orbslam3_tpu.eval.metrics import ate_rmse
    from orbslam3_tpu.models.fused import MODE_OK, FusedSlam
    from orbslam3_tpu.models.slam import SlamConfig
    from orbslam3_tpu_torch.io.synthetic import perturb_frames

    cfg = SlamConfig(use_imu=False, ransac_fallback=False, triangulate_mono=False,
                     fuse_neighbors=False, update_point_stats=False,
                     kf_cull_redundancy=0.0)
    world, times, frames, imu = build_world(DURATION)
    gt_p, _ = world.gt_trajectory()

    def run(frames_):
        slam = FusedSlam(world.cam, cfg)
        t0 = time.perf_counter()
        for i, t in enumerate(times):
            g, a, d = imu[i]
            slam.process_frame(frames_[i][0], frames_[i][1], g, a, d, float(t))
        slam.finalize()
        jax.block_until_ready(slam.ts.q)
        wall = time.perf_counter() - t0
        _, ps, _ = slam.trajectory_arrays()
        modes = slam.modes()
        draw = {"ok_frac": float((modes == MODE_OK).mean()),
                "ate_m": float(ate_rmse(ps, gt_p[: len(ps)])),
                "n_kf": int(slam.map.n_kf), "n_mp": int(slam.map.n_mp)}
        return slam, ps, modes, draw, wall

    slam, ps, modes, clean, wall = run(frames)
    _, outs, _ = slam._flat_outs()
    draws = [{"seed": None, **clean}]
    for seed in NOISE_SEEDS:
        draws.append({"seed": seed, **run(perturb_frames(frames, seed))[3]})
    rec = {
        "world": {"duration_s": DURATION, "cam_hz": world.cfg.cam_hz,
                  "width": world.cfg.width, "height": world.cfg.height,
                  "seed": world.cfg.seed, "n_landmarks": world.cfg.n_landmarks,
                  "hard_world": HARD_WORLD},
        "config": "SLICE_CFG: SlamConfig(use_imu=False, ransac_fallback=False, "
                  "triangulate_mono=False, fuse_neighbors=False, "
                  "update_point_stats=False, kf_cull_redundancy=0.0)",
        "n_frames": int(len(times)),
        **clean,
        "backend": jax.default_backend(),
        "note": "accuracy reference only; the CPU wall time is not a speed figure",
        "cpu_wall_s": round(wall, 1),
        "noise": "perturb_frames(frames, seed, frac=1e-3)",
        "draws": draws,
        "per_frame": {
            "mode": modes.tolist(),
            "is_kf": [int(o.is_kf) for o in outs],
            "n_features": [int(o.n_features) for o in outs],
            "n_matches": [int(o.n_matches) for o in outs],
            "n_inliers": [int(o.n_inliers) for o in outs],
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
