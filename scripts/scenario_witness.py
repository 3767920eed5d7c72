"""Is a scenario's departure from its JAX record float32 rounding that the world amplifies?

For a scenario of scripts/scenarios_torch.py this script runs, on the CPU:

  jax-ulp   the JAX package's FusedSlam five times, with one of the
            camera's fx, fy, cx, cy and bf moved one float32 ulp up: how
            far a last-bit change alone carries the world;
  fed       the port's FusedSlam with every frame's features, stereo depths
            and body points taken from the JAX front end
            (models/fused.py::_frontend_chunk, jitted on the CPU) and, where
            the record has them, the JAX run's RANSAC-seed draws
            (data/scenario_draws.npz): everything after the front end is the
            port's.

and prints, for each against the recorded JAX run
(data/scenario_reference.json), the first frame that departs (a tracker
mode, keyframe flag or inlier count, or a position more than 5 mm away),
the position difference every other frame, and the compaction passes,
stale-point evictions and map points at the end; then the first frame at
which a `jax-ulp` run is more than 5 mm from the record. If `fed` departs no
sooner and no further than the `jax-ulp` runs do, the departure is rounding
that the world amplifies, not a fault of the port's back end or host
services.

    JAX_PLATFORMS=cpu python scripts/scenario_witness.py NAME [jax-ulp fed]

CPU minutes for long_run_compacts (60 frames at 256x192): jax-ulp ~3, fed
~2; no time printed here is a speed figure.
"""
from __future__ import annotations

import contextlib
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import numpy as np  # noqa: E402

import scenarios_torch as sc  # noqa: E402


@contextlib.contextmanager
def fed_front_end(name: str):
    """The port's front end replaced by the JAX package's `_frontend_chunk`,
    jitted on the CPU for the scenario's camera and configuration; its
    results (features, stereo depths, body points) go into the port's
    types as numpy."""
    import jax

    import make_scenario_reference as mk
    from orbslam3_tpu.models import fused as jfused
    from orbslam3_tpu_torch.interop import from_numpy_tree
    from orbslam3_tpu_torch.models import fused as tfused

    jworld, jcfg, _ = sc.build(mk.jax_pkg(), name)
    jcam = jworld.cam
    jax_chunk = jax.jit(lambda lefts, rights: jfused._frontend_chunk(lefts, rights, jcam, jcfg))

    def frontend_chunk(lefts_u8, rights_u8, cam, cfg):
        fe = jax_chunk(lefts_u8.numpy(), rights_u8.numpy())
        return tuple(from_numpy_tree(jax.tree.map(np.asarray, x)) for x in fe)

    own = tfused._frontend_chunk
    tfused._frontend_chunk = frontend_chunk
    try:
        yield
    finally:
        tfused._frontend_chunk = own


@contextlib.contextmanager
def fed_draws(name: str):
    """The port's RANSAC seed fed the JAX run's draws at the frames where the
    record has them, by the swap of scripts/revisit_witness.py: `_ransac_seed`
    notes the frame's time and `robust_pose_3d3d` takes that frame's
    recorded draws; other frames keep the port's own generator (their seed
    is masked out unless the fallback runs, and a fallback the record lacks
    departs in the per-frame counts)."""
    import torch

    from orbslam3_tpu_torch.models import fused as tfused

    table = {}
    with np.load(sc.DRAWS) as z:
        if f"{name}.t" in z.files:
            table = {float(t): d.astype(np.int64)
                     for t, d in zip(z[f"{name}.t"], z[f"{name}.draws"])}
    seed, robust = tfused._ransac_seed, tfused.robust_pose_3d3d
    box = {}

    def ransac_seed(t):
        box["t"] = float(np.float32(t))
        return seed(t)

    def robust_pose(Xw, Xb, valid, bf, fx, generator=None, draws=None, n_hyp=128, **kw):
        d = table.get(box["t"])
        if d is None:
            return robust(Xw, Xb, valid, bf, fx, generator=generator, n_hyp=n_hyp, **kw)
        return robust(Xw, Xb, valid, bf, fx, draws=torch.from_numpy(d).to(Xw.device),
                      n_hyp=n_hyp, **kw)

    tfused._ransac_seed, tfused.robust_pose_3d3d = ransac_seed, robust_pose
    try:
        yield
    finally:
        tfused._ransac_seed, tfused.robust_pose_3d3d = seed, robust


ULP_FIELDS = ("fx", "fy", "cx", "cy", "bf")


def jax_ulp(name: str, field: str) -> dict:
    """The scenario's JAX run with the camera's `field` one float32 ulp up."""
    import jax.numpy as jnp

    import make_scenario_reference as mk
    from orbslam3_tpu.geometry import quat
    from orbslam3_tpu.models.fused import FusedSlam

    spec = sc.SCENARIOS[name]
    world, cfg, times = sc.build(mk.jax_pkg(), name)
    frames = mk.spawn_render(world, times, spec.get("blackout"))
    up = np.nextafter(np.float32(getattr(world.cam, field)), np.float32(np.inf))
    slam = FusedSlam(world.cam._replace(**{field: jnp.float32(up)}), cfg,
                     service_every=spec["service_every"])
    events = sc.drive(slam, world, times, frames, name, lambda x: jnp.asarray(x, jnp.float32),
                      quat)
    return sc.record(slam, world, times, frames, name, events)


def fed(name: str) -> dict:
    import torch

    torch.set_num_threads(4)
    with fed_front_end(name), fed_draws(name):
        return sc.run_port(name, device="cpu", workers=4)[1]


def compare(which: str, rec: dict, ref: dict):
    """Print the run against the record; returns its per-frame position
    difference."""
    dp = np.linalg.norm(np.asarray(rec["per_frame"]["p"]) - np.asarray(ref["per_frame"]["p"]),
                        axis=1)
    print(f"{which}: first departure {sc.first_departure(rec, ref)}; position difference (m) "
          "every other frame: " + ", ".join(f"{i}: {dp[i]:.1e}" for i in range(0, len(dp), 2)),
          flush=True)
    print(f"{which}: compactions {rec['compactions']} (JAX {ref['compactions']}), stale-point "
          f"evictions {rec['mp_evictions']} ({ref['mp_evictions']}), map points {rec['n_mp']} "
          f"({ref['n_mp']}), ATE {rec['ate_m']:.4f} m ({ref['ate_m']:.4f})", flush=True)
    return dp


def main(name: str, which: list) -> int:
    ref = sc.load_reference()["scenarios"][name]
    if "fed" in which:
        compare("fed", fed(name), ref)
    if "jax-ulp" in which:
        far = [np.flatnonzero(compare(f"jax-ulp {f}", jax_ulp(name, f), ref) > 5e-3)
               for f in ULP_FIELDS]
        first = min((int(x[0]) for x in far if len(x)), default=None)
        print(f"jax-ulp: the first frame at which a JAX run one ulp apart is more than 5 mm "
              f"from the record: {first}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1], sys.argv[2:] or ["jax-ulp", "fed"]))
