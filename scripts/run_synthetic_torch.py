"""Run the PyTorch port on a synthetic sequence and export its artifacts.

Usage: python scripts/run_synthetic_torch.py [seconds] [outdir] [--live [PORT]]
           [--device cpu]

The port's counterpart of scripts/run_synthetic.py: FusedSlam over the
synthetic stereo-inertial world, then a TUM trajectory and ground truth, a
PLY map, a checkpoint (save_map) and the HTML viewer of the map; prints
ATE/RPE as one JSON line. With --live, serves a browser view of the growing
map while tracking runs (viz/live.py). Runs on the CUDA card unless
--device names another device.
"""
import sys, os; sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))  # noqa: E401,E702

import argparse
import json
import tempfile

import numpy as np


def run(seconds: float = 6.0, outdir: str = None, live_port=None, device=None) -> dict:
    """Track `seconds` of the synthetic world and write the artifacts into
    `outdir`. `live_port` (0 for any free port) serves the live viewer."""
    from orbslam3_tpu_torch.eval.metrics import ate_rmse, rpe_rmse
    from orbslam3_tpu_torch.io.synthetic import SyntheticConfig, SyntheticWorld
    from orbslam3_tpu_torch.map.checkpoint import save_map
    from orbslam3_tpu_torch.models.fused import FusedSlam
    from orbslam3_tpu_torch.models.slam import SlamConfig
    from orbslam3_tpu_torch.viz.export import save_map_ply, save_trajectory_tum
    from orbslam3_tpu_torch.viz.html_view import save_html_view

    outdir = outdir or os.path.join(tempfile.gettempdir(), "orbslam3_tpu_torch_run")
    os.makedirs(outdir, exist_ok=True)
    viewer = None
    if live_port is not None:
        from orbslam3_tpu_torch.viz.live import LiveViewer

        viewer = LiveViewer(port=live_port)
        print(f"live viewer: {viewer.url}", flush=True)

    world = SyntheticWorld(SyntheticConfig(duration=seconds))
    slam = FusedSlam(world.cam, SlamConfig(kf_max_frames=4), device=device)
    times = world.frame_times()
    gt_p, gt_q = world.gt_trajectory()
    for i, t in enumerate(times):
        left, right = world.render_frame(t)
        t_prev = times[i - 1] if i > 0 else t
        g, a, d = world.imu_window(t_prev, t)
        slam.process_frame(left.astype(np.uint8), right.astype(np.uint8), g, a, d, float(t))
        if viewer is not None and i % 20 == 19:
            # throttled snapshot: about one device read per second of sequence
            _, ps_live, _ = slam.trajectory_arrays()
            viewer.publish(slam.map, ps_live, gt_p[: len(ps_live)])
    slam.finalize()

    ts, ps, qs = slam.trajectory_arrays()
    save_trajectory_tum(os.path.join(outdir, "trajectory.tum"), ts, ps, qs)
    save_trajectory_tum(os.path.join(outdir, "groundtruth.tum"), times, gt_p, gt_q)
    save_map_ply(os.path.join(outdir, "map.ply"), slam.map)
    save_map(os.path.join(outdir, "checkpoint.npz"), slam.map, slam.ts)
    save_html_view(os.path.join(outdir, "map.html"), slam.map, ps, gt_p[: len(ps)])
    if viewer is not None:
        viewer.publish(slam.map, ps, gt_p[: len(ps)], force=True)
        viewer.close()
    n = len(ps)
    return {"frames": len(times), "keyframes": int(slam.map.n_kf),
            "map_points": int(slam.map.mp_valid.sum()), "imu_initialized": slam.imu_initialized,
            "ate_m": round(ate_rmse(ps, gt_p[:n]), 4),
            "rpe_m": round(rpe_rmse(ps, gt_p[:n], qs, gt_q[:n])[0], 4), "outdir": outdir,
            "device": str(slam.device)}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("seconds", nargs="?", type=float, default=6.0)
    ap.add_argument("outdir", nargs="?", default=None)
    ap.add_argument("--live", nargs="?", type=int, const=0, default=None, metavar="PORT")
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    a = ap.parse_args()
    print(json.dumps(run(a.seconds, a.outdir, a.live, a.device)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
