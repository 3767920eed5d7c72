"""Render a saved checkpoint (map/checkpoint.py npz, written by either
package) to an interactive standalone HTML viewer. Port of
scripts/view_checkpoint.py.

Usage: python3 scripts/view_checkpoint_torch.py checkpoint.npz [out.html] [traj.tum]
           [--device cpu]

The map is loaded onto the CUDA card unless --device cpu is given, and the
script raises where there is no card. traj.tum is a TUM trajectory
(time x y z qx qy qz qw a line) drawn beside the map.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("checkpoint")
    ap.add_argument("out", nargs="?", default=None,
                    help="the HTML file; the checkpoint's name with .html by default")
    ap.add_argument("traj", nargs="?", default=None, help="a TUM trajectory to draw")
    ap.add_argument("--device", default=None,
                    help="torch device; the CUDA card unless given ('cpu' runs on the CPU)")
    args = ap.parse_args(argv)
    out = args.out or args.checkpoint.rsplit(".", 1)[0] + ".html"

    from orbslam3_tpu_torch.map.checkpoint import load_map
    from orbslam3_tpu_torch.viz.html_view import save_html_view

    st = load_map(args.checkpoint, device=args.device)
    traj = None
    if args.traj:
        traj = np.loadtxt(args.traj)[:, 1:4]
    save_html_view(out, map_state=st, traj=traj)
    print(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
