"""Is the port's stereo-inertial back end faithful to the JAX package's?

The port's noise-free run of the bench world under BENCH_CFG leaves the
branch of the recorded JAX reference (orbslam3_tpu_torch/data/vi_reference.json)
while its sensor-noise draws stay on it. This script separates the two
possible causes. It runs the port's FusedSlam on the CPU over the same world
(752x480 stereo, 8 s at 20 Hz, with its IMU windows) twice:

  jax-features   every frame's features, stereo depths and body points come
                 from the JAX package's front end (models/fused.py::_frontend,
                 jitted on the CPU); everything after the front end (IMU
                 prediction, matching, RANSAC seed, visual and visual-inertial
                 pose solves, IMU initialization, BA and VI-BA, triangulation,
                 fusion, point statistics, culling) is the port's;
  own-features   the port's own front end, as chip_smoke.py runs it.

and prints each run's ATE, keyframe counts, IMU-initialization frame and the
first frame at which its per-frame record departs from the reference's. If the
first run stays on the reference's branch and the second leaves it, the
difference comes from the front end's descriptor bits and not from the
visual-inertial solves.

    JAX_PLATFORMS=cpu python scripts/vi_backend_witness.py [jax-features|own-features ...]

About 15 minutes for both runs on 4 CPU threads; accuracy only, no time printed
here is a speed figure.
"""
from __future__ import annotations

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(which):
    import jax
    import numpy as np
    import torch

    import chip_smoke
    from orbslam3_tpu.io.synthetic import SyntheticConfig as JSyntheticConfig
    from orbslam3_tpu.io.synthetic import SyntheticWorld as JSyntheticWorld
    from orbslam3_tpu.models import fused as jfused
    from orbslam3_tpu.models.slam import SlamConfig as JSlamConfig
    from orbslam3_tpu_torch.interop import from_numpy_tree
    from orbslam3_tpu_torch.models import fused as tfused

    torch.set_num_threads(4)
    world, times, frames, imu = chip_smoke.build_world()
    gt_p, _ = world.gt_trajectory()
    n = len(times)
    with open(os.path.join(ROOT, "orbslam3_tpu_torch", "data", "vi_reference.json")) as f:
        ref = json.load(f)
    jd = ref["draws"][0]

    jcam = JSyntheticWorld(JSyntheticConfig(duration=chip_smoke.DURATION, n_landmarks=1500,
                                            **chip_smoke.HARD_WORLD)).cam
    jcfg = JSlamConfig(use_imu=True, kf_max_frames=6, ba_iters=3, ba_window=6, lost_timeout=5.0)
    jax_frontend = jax.jit(lambda left, right: jfused._frontend(left, right, jcam, jcfg))
    own_frontend = tfused._frontend

    def from_jax(left_u8, right_u8, cam, cfg):
        fe = jax_frontend(left_u8.numpy(), right_u8.numpy())
        return tuple(from_numpy_tree(jax.tree.map(np.asarray, x)) for x in fe)

    for name in which:
        tfused._frontend = from_jax if name == "jax-features" else own_frontend
        slam, _, _, _ = chip_smoke.run_slice(world, times, frames, imu, tfused.BENCH_CFG,
                                             device="cpu")
        acc = chip_smoke.accuracy(slam, gt_p, n)
        print(f"{name}: ATE {acc['ate']:.5f} m (JAX {jd['ate_m']:.5f}), ok_frac "
              f"{acc['ok_frac']:.4f}, n_kf {acc['n_kf']} (JAX {jd['n_kf']}), keyframes valid "
              f"{int(slam.map.kf_valid.sum())} (JAX {jd['n_kf_valid']}), n_mp "
              f"{int(slam.map.n_mp)} (JAX {jd['n_mp']}), IMU initialized at frame "
              f"{slam.imu_init_frame} (JAX {jd['imu_init_frame']})", flush=True)
        print(f"{name}: first departures from the reference: "
              + chip_smoke.first_divergence(slam, ref), flush=True)
    tfused._frontend = own_frontend


if __name__ == "__main__":
    main(sys.argv[1:] or ["jax-features", "own-features"])
