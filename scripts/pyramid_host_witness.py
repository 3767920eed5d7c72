"""Witness: the JAX package's own pyramid bits depend on the host's core count.

Runs the JAX package's jitted orbslam3_tpu/ops/pyramid.py::build_pyramid
(8 levels, scale 1.2) on one seeded 480x752 float32 image (integers 0..255
from numpy's default_rng(SEED)) in subprocesses on the CPU: one pinned to a
single core, one on every core this process may use, and one on two cores
with --xla_cpu_multi_thread_eigen=false. Prints, for each run against the
all-cores run, the pixels that differ on each level, and one JSON line.

XLA:CPU applies the resize weights through its runtime dot, whose order of
summation follows how it splits the work over the host's threads: levels
that differ here differ between two runs of the reference itself, so the
port's pyramid cannot match the reference's bits on every host
(ROADMAP queue 3, expected differences; tests/test_torch_frontend.py keeps
its 1e-3 tolerance on levels >= 1 for this reason).

    JAX_PLATFORMS=cpu python scripts/pyramid_host_witness.py
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 0
SHAPE = (480, 752)


def child(cores: str, out: str) -> None:
    """Pin this process to `cores` ("all" or a comma list), then build the
    pyramid with JAX and save its levels to `out`."""
    if cores != "all":
        os.sched_setaffinity(0, {int(c) for c in cores.split(",")})
    sys.path.insert(0, ROOT)
    import jax
    import jax.numpy as jnp
    import numpy as np

    from orbslam3_tpu.ops.pyramid import build_pyramid

    img = np.random.default_rng(SEED).integers(0, 256, SHAPE).astype(np.float32)
    levels = jax.jit(build_pyramid)(jnp.asarray(img))
    np.savez(out, *[np.asarray(x) for x in levels], cores=len(os.sched_getaffinity(0)))


def run(cores: str, out: str, xla_flags: str = "") -> None:
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "") + " " + xla_flags).strip()
    subprocess.run([sys.executable, os.path.abspath(__file__), "--child", cores, out],
                   env=env, check=True)


def main() -> int:
    import numpy as np

    if sys.argv[1:2] == ["--child"]:
        child(sys.argv[2], sys.argv[3])
        return 0
    runs = {"1 core": ("0", ""), "2 cores, eigen single-threaded":
            ("0,1", "--xla_cpu_multi_thread_eigen=false")}
    with tempfile.TemporaryDirectory() as d:
        run("all", os.path.join(d, "all.npz"))
        base = np.load(os.path.join(d, "all.npz"))
        n_all = int(base["cores"])
        res = {"all_cores": n_all, "seed": SEED, "shape": list(SHAPE)}
        for name, (cores, flags) in runs.items():
            path = os.path.join(d, f"{cores}.npz")
            run(cores, path, flags)
            got = np.load(path)
            diff = [int((got[f"arr_{i}"] != base[f"arr_{i}"]).sum()) for i in range(8)]
            res[name] = diff
            print(f"{name} against all {n_all} cores: pixels differing by level {diff}")
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
