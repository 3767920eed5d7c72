"""Write an EuRoC-format sequence from the synthetic world, without JAX.

Usage: python scripts/make_euroc_fixture_torch.py <outdir> [--duration S]
           [--hz HZ] [--scale 0.5] [--seed N] [--revisit] [--workers N]

The port's counterpart of scripts/make_euroc_fixture.py (same options and
the same files: yaml and csv byte-equal, PNGs pixel-equal), through
orbslam3_tpu_torch/io/euroc_fixture.py. Prints the mav0 directory.
"""
import sys, os; sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))  # noqa: E401,E702

import argparse


def main():
    from orbslam3_tpu_torch.io.euroc_fixture import write_fixture

    ap = argparse.ArgumentParser()
    ap.add_argument("outdir")
    ap.add_argument("--duration", type=float, default=8.0)
    ap.add_argument("--hz", type=float, default=10.0)
    ap.add_argument("--scale", type=float, default=0.5)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--revisit", action="store_true")
    ap.add_argument("--workers", type=int, default=1, help="rendering processes")
    a = ap.parse_args()
    print(write_fixture(a.outdir, a.duration, a.hz, a.scale, a.seed, revisit=a.revisit,
                        workers=a.workers))
    return 0


if __name__ == "__main__":
    sys.exit(main())
