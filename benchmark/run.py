"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cells, configurations and metrics are those of BENCHMARK.json at the
root of the checkout (see benchmark/README.md). The last line of standard
output is one JSON object: correct, attempted, failed, metrics, device,
with --trace 1 also breakdown, and last the numbers the check compared,
each beside its limit (also the last lines of standard error). The run
exits with a code other than 0, printing no result, where there is no CUDA
card, where JAX or the JAX package was loaded, or where the program is
missing.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "orbslam3_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", choices=("tf32",), default=None,
                    help="run the program in the precision below the configuration's "
                         "(the check's control; never part of a measurement)")
    ap.add_argument("--fault", default=None,
                    help="plant a fault of slambench/faults.py in the program (the check's "
                         "upper readings; never part of a measurement)")
    args = ap.parse_args(argv)

    # every cache the program or its libraries write stays in the checkout
    cache = os.path.join(HERE, ".cache")
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(cache, "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(cache, "triton"))
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")
    # one process, one host thread for numpy's and torch's CPU pools: the
    # window is one Python thread dispatching launches, and idle pool
    # threads that spin only take cores from it
    for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ.setdefault(var, "1")
    sys.path[:0] = [HERE, ROOT]

    import torch

    torch.set_num_threads(1)

    from slambench import manifest
    from slambench.harness import log, run_cell

    man = manifest.load()
    cell = manifest.workload(man, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        log(f"no result: the cell needs {cell['chips']} CUDA device(s), {n} available")
        return 3
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                      control=args.control, fault=args.fault,
                      t_start=T_START)
    bad = forbidden_modules()
    if bad:
        log(f"no result: the run loaded {', '.join(bad)}")
        return 4
    for name, c in result["checks"].items():
        log(f"check {name}: {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
