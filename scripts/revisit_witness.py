"""Does the port's tracker leave the revisit world's blackout as JAX's does?

On the revisit world (bench.py::build_revisit_world: 24 s, 752x480 at
20 Hz, noisy biased IMU, a camera blackout at 10-13 s with an IMU bias
step) under BENCH_CFG with the loop closer (chunk=8, service_every=8,
warmup, data/vocab_revisit.npz), the port's tracker on the card reads OK at
the snapshots after the blackout where the recorded JAX run
(data/loop_reference.json, `revisit`) is recently lost. This script runs,
on the CPU, over the world's first `frames` frames:

  jax       the JAX package's FusedSlam;
  jax-ulp   the same with every accelerometer sample moved by one float32
            ulp: how far float32 rounding alone carries this world;
  fed       the port's FusedSlam with every chunk's features, stereo depths
            and body points taken from the JAX front end
            (models/fused.py::_frontend_chunk, jitted on the CPU) and the
            RANSAC seed's draws taken from JAX's key: everything after the
            front end is the port's.

It prints, for `jax-ulp` and `fed` against `jax`, the per-frame position
difference every 8 frames and the first frames whose keyframe decision,
inlier count, keyframe count or tracker mode differ; and for every run and
the recorded reference, the service rounds in relocalization mode, the
keyframes serviced and the corrections (whether `jax` reproduces the
reference's keyframe services).
If `fed` departs from `jax` no sooner and no further than `jax-ulp` does,
the departure is float32 rounding that this world amplifies, not a fault of
the port's tracker or back end.

    JAX_PLATFORMS=cpu python scripts/revisit_witness.py [frames] [jax jax-ulp fed ... | none]

`frames` defaults to 176; 352 reaches past the reference's first correction
(frame 343). Records are kept as JSON in the directory REVISIT_WITNESS_DIR
names (the system's temporary directory by default), so a later call
compares without running again. CPU minutes at 176 frames: jax ~4, jax-ulp
~4, fed ~7; accuracy only, no time printed here is a speed figure.
"""
from __future__ import annotations

import json
import os
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

FIELDS = ("n_matches", "n_inliers", "mode", "is_kf", "n_kf", "p")
JAX_CFG = dict(use_imu=True, kf_max_frames=6, ba_iters=3, ba_window=6, lost_timeout=5.0)


def out_path(which: str, n: int) -> str:
    d = os.environ.get("REVISIT_WITNESS_DIR", tempfile.gettempdir())
    return os.path.join(d, f"revisit_witness_{which}_{n}.json")


def jax_vocab():
    """data/vocab_revisit.npz as the JAX package's Vocabulary."""
    import jax.numpy as jnp

    from orbslam3_tpu.loop.vocab import Vocabulary
    from orbslam3_tpu_torch.loop.vocab import load_npz

    tv = load_npz(os.path.join(ROOT, "orbslam3_tpu_torch", "data", "vocab_revisit.npz"))

    def conv(x):
        if isinstance(x, tuple):
            return tuple(conv(a) for a in x)
        return jnp.asarray(x.numpy()) if hasattr(x, "numpy") else x

    return Vocabulary(*[conv(getattr(tv, f)) for f in Vocabulary._fields])


def feed_jax_front_end(tfused, jcam):
    """Patch the port's fused step to take the JAX front end's features
    and JAX's RANSAC-seed draws. Returns a function that undoes it."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    from orbslam3_tpu.models import fused as jfused
    from orbslam3_tpu.models.slam import SlamConfig
    from orbslam3_tpu_torch.interop import from_numpy_tree

    jcfg = SlamConfig(**JAX_CFG)
    jax_chunk = jax.jit(lambda lefts, rights: jfused._frontend_chunk(lefts, rights, jcam, jcfg))

    def frontend_chunk(lefts_u8, rights_u8, cam, cfg):
        fe = jax_chunk(lefts_u8.numpy(), rights_u8.numpy())
        return tuple(from_numpy_tree(jax.tree.map(np.asarray, x)) for x in fe)

    box = {}
    seed, robust = tfused._ransac_seed, tfused.robust_pose_3d3d

    def ransac_seed(t):
        box["t"] = t
        return seed(t)

    def robust_pose(Xw, Xb, valid, bf, fx, generator=None, draws=None, n_hyp=128, **kw):
        # models/fused.py: fold_in(PRNGKey(17), bitcast(t)), randint in [0, n_valid)
        key = jax.random.fold_in(jax.random.PRNGKey(17), jax.lax.bitcast_convert_type(
            jnp.asarray(box["t"], jnp.float32), jnp.int32))
        hi = jnp.maximum(jnp.int32(int(valid.sum())), 1)
        d = np.asarray(jax.random.randint(key, (n_hyp, 3), 0, hi))
        return robust(Xw, Xb, valid, bf, fx, draws=torch.from_numpy(d), n_hyp=n_hyp, **kw)

    own = tfused._frontend_chunk
    tfused._frontend_chunk = frontend_chunk
    tfused._ransac_seed, tfused.robust_pose_3d3d = ransac_seed, robust_pose

    def restore():
        tfused._frontend_chunk = own
        tfused._ransac_seed, tfused.robust_pose_3d3d = seed, robust

    return restore


def record(which: str, n: int) -> dict:
    import numpy as np
    import torch

    import chip_smoke
    from orbslam3_tpu.io.synthetic import SyntheticConfig as JCfg
    from orbslam3_tpu.io.synthetic import SyntheticWorld as JWorld
    from orbslam3_tpu_torch.io.synthetic import SyntheticConfig, SyntheticWorld
    from torch_parity import record_loop_services

    kw = dict(**chip_smoke.REVISIT_WORLD, **chip_smoke.HARD_WORLD)
    world = SyntheticWorld(SyntheticConfig(**kw))
    times = world.frame_times()[:n]
    frames = world.render_sequence(times, blackout=chip_smoke.REVISIT_BLACKOUT, workers=4)
    imu = [world.imu_window(times[i - 1] if i > 0 else t, t) for i, t in enumerate(times)]
    if which == "jax-ulp":
        imu = [(g, np.nextafter(a.astype(np.float32), np.float32(np.inf)), d) for g, a, d in imu]
    jcam = JWorld(JCfg(**kw)).cam
    restore = lambda: None  # noqa: E731
    if which == "fed":
        from orbslam3_tpu_torch.models import fused as tfused

        torch.set_num_threads(4)
        restore = feed_jax_front_end(tfused, jcam)
        slam, _ = chip_smoke.loop_slam(world.cam, tfused.BENCH_CFG,
                                       chip_smoke.load_vocab("revisit"), device="cpu")
    else:
        from orbslam3_tpu.models.fused import FusedSlam
        from orbslam3_tpu.models.slam import SlamConfig

        slam = FusedSlam(jcam, SlamConfig(**JAX_CFG), vocabulary=jax_vocab(), service_every=8,
                         chunk=8, warmup=True)
    log = record_loop_services(slam, [])
    rounds = {}
    try:
        for i, t in enumerate(times):
            if which == "fed":
                chip_smoke.mirror_recorder(rounds)(i, slam)
            g, a, d = imu[i]
            slam.process_frame(frames[i][0], frames[i][1], g, a, d, float(t))
        slam.finalize()
    finally:
        restore()
    if which == "fed":
        fo = slam.frame_outputs()
        rec = {f: np.asarray(getattr(fo, f)).tolist() for f in FIELDS}
        rec["reloc_rounds"] = sorted(r for r, on in rounds.items() if on)
    else:
        _, outs, _ = slam._flat_outs()
        rec = {f: np.stack([np.asarray(getattr(o, f)) for o in outs]).tolist() for f in FIELDS}
    rec["services"] = [list(e) for e in log]
    with open(out_path(which, n), "w") as f:
        json.dump(rec, f)
    return rec


def before_last(services: list, n_rounds: int) -> list:
    """The keyframe services of rounds before round n_rounds (a run that
    stops there ends with its own final round)."""
    return [list(e) for e in services if e[0] == "kf" and e[1] < n_rounds]


def compare(name: str, a: dict, b: dict):
    import numpy as np

    dp = np.linalg.norm(np.asarray(a["p"]) - np.asarray(b["p"]), axis=1)
    firsts = {k: np.flatnonzero(np.asarray(a[k]) != np.asarray(b[k]))[:4].tolist()
              for k in ("is_kf", "n_inliers", "n_kf", "mode")}
    print(f"{name} against jax: first frames that differ {json.dumps(firsts)}; position "
          f"difference (m) every 8 frames: "
          + ", ".join(f"{i}: {dp[i]:.2e}" for i in range(0, len(dp), 8)), flush=True)


def main(n: int, which: list) -> int:
    recs = {}
    for name in ("jax", "jax-ulp", "fed"):
        if name in which:
            recs[name] = record(name, n)
        elif os.path.exists(out_path(name, n)):
            with open(out_path(name, n)) as f:
                recs[name] = json.load(f)
    for name in ("jax-ulp", "fed"):
        if name in recs and "jax" in recs:
            compare(name, recs["jax"], recs[name])
    with open(os.path.join(ROOT, "orbslam3_tpu_torch", "data", "loop_reference.json")) as f:
        ref = json.load(f)["revisit"]
    n_rounds = n // 8
    runs = {"reference": [e for e in ref["services"]
                          if e[0] != "kf" or e[1] <= n_rounds], **{k: v["services"]
                                                                  for k, v in recs.items()}}
    for name, services in runs.items():
        kf = [e for e in services if e[0] == "kf" and e[1] <= n_rounds]
        corr = [e[1:3] for e in services if e[0] == "correct"]
        if name == "reference":
            corr = [[c["kf_id"], c["cand"]] for c in ref["corrections"] if c["frame"] < n]
        print(f"{name}: relocalization-mode rounds {sorted({e[1] for e in kf if e[4]})}, "
              f"keyframes serviced {len(kf)}, corrections (keyframe, candidate) {corr}"
              + (f", keyframe services of the rounds before the last equal to the reference's: "
                 f"{before_last(services, n_rounds) == before_last(runs['reference'], n_rounds)}"
                 if name == "jax" else ""), flush=True)
    return 0


if __name__ == "__main__":
    args = sys.argv[1:]
    n_frames = int(args.pop(0)) if args and args[0].isdigit() else 176
    sys.exit(main(n_frames, args or ["jax", "jax-ulp", "fed"]))  # "none": compare records only
