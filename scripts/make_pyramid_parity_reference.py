"""Front-end parity of the PyTorch port against the JAX package on the CPU.

Renders the bench world (bench.py's HARD_WORLD, 1500 landmarks, 8 s at
20 Hz: 160 stereo frames of 752x480) and runs both packages' pyramid and
ORB front end on every frame. Prints one JSON line: the resize weights
that differ at each level transition of the 752x480 pyramid (the port's
taps against the matrix XLA:CPU builds, read by resizing an identity),
pixels that differ on each pyramid level (summed over the left images),
and ORB features whose position, octave, validity or BRIEF descriptor
differ (over both images of every frame; a descriptor counts once however
many of its bits differ).

Usage: JAX_PLATFORMS=cpu python scripts/make_pyramid_parity_reference.py [--frames 160]
"""
import sys, os; sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import argparse
import json
import time

import numpy as np

HARD_WORLD = dict(texture="textured", exposure_drift=0.3, image_noise_std=3.0,
                  salt_pepper_frac=0.002, motion_blur_samples=3, exposure_time=0.02)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=160)
    args = ap.parse_args()
    import jax
    import jax.numpy as jnp
    import torch

    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(1)
    from orbslam3_tpu.frontend import orb as jorb
    from orbslam3_tpu.ops import pyramid as jpyr
    from orbslam3_tpu_torch.frontend import orb as torb
    from orbslam3_tpu_torch.io.synthetic import SyntheticConfig, SyntheticWorld
    from orbslam3_tpu_torch.ops import pyramid as tpyr

    weights = {}
    shapes = tpyr.level_shapes(480, 752, 8, 1.2)
    for (h0, w0), (h1, w1) in zip(shapes, shapes[1:]):
        for m, n in ((h0, h1), (w0, w1)):
            want = np.asarray(jax.jit(lambda x: jpyr.resize_bilinear(x, (n, m)))(
                jnp.eye(m, dtype=jnp.float32))).T
            idx, wt = tpyr._resize_taps_np(m, n)
            got = np.zeros_like(want)
            for t in range(idx.shape[1]):
                np.add.at(got, (idx[:, t], np.arange(n)), wt[:, t])
            weights[f"{m}->{n}"] = [int((got != want).sum()), int((want != 0).sum())]
    world = SyntheticWorld(SyntheticConfig(duration=8.0, n_landmarks=1500, **HARD_WORLD))
    times = world.frame_times()[: args.frames]
    t0 = time.perf_counter()
    cfg_j, cfg_t = jorb.OrbConfig(), torb.OrbConfig()
    pyr_j = jax.jit(lambda x: jpyr.build_pyramid(x, cfg_j.n_levels, cfg_j.scale_factor))
    orb_j = jax.jit(lambda l, r: jorb.detect_orb_pair(l, r, cfg_j))
    px = np.zeros(cfg_j.n_levels, np.int64)
    feats = desc = 0
    frames_with_desc = 0
    for t in times:
        left, right = (np.asarray(x).astype(np.uint8).astype(np.float32)
                       for x in world.render_frame(float(t)))
        lj = pyr_j(jnp.asarray(left))
        lt = tpyr.build_pyramid(torch.from_numpy(left), cfg_t.n_levels, cfg_t.scale_factor)
        px += [int((np.asarray(a) != b.numpy()).sum()) for a, b in zip(lj, lt)]
        fj = jax.tree.map(np.asarray, orb_j(jnp.asarray(left), jnp.asarray(right)))
        ft = torb.detect_orb_pair(torch.from_numpy(left), torch.from_numpy(right), cfg_t)
        n_desc = 0
        for a, b in zip(fj, ft):
            same_kp = ((np.asarray(a.uv) == b.uv.numpy()).all(-1)
                       & (np.asarray(a.octave) == b.octave.numpy())
                       & (np.asarray(a.valid) == b.valid.numpy()))
            feats += int((~same_kp).sum())
            d = (np.asarray(a.desc) != b.desc.numpy()).any(-1) & np.asarray(a.valid) & same_kp
            n_desc += int(d.sum())
        desc += n_desc
        frames_with_desc += n_desc > 0
    print(json.dumps(dict(
        weights_differing_of_nonzero=weights, frames=len(times), image="752x480", levels_pixels_differing=px.tolist(),
        keypoints_differing=feats, descriptors_differing=desc,
        frames_with_a_differing_descriptor=frames_with_desc,
        seconds=round(time.perf_counter() - t0, 1))), flush=True)


if __name__ == "__main__":
    main()
