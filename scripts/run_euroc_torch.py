"""Run the PyTorch port on an EuRoC-format sequence.

Usage: python scripts/run_euroc_torch.py /path/to/MH_01_easy [outdir]
           [--profile small] [--max-frames N] [--vocab ORBvoc.txt] [--device cpu]

The port's counterpart of scripts/run_euroc.py: EurocDataset -> images
decoded by the native loader (io/native.py, built with g++ at first use; a
threaded prefetcher per camera) -> undistortion and stereo rectification on
the device (io/rectify.py) -> FusedSlam at chunk 1 -> ATE against the
sequence's ground truth (one JSON line) and a TUM trajectory. Works on real
EuRoC data and on the generated fixture (io/euroc_fixture.py,
scripts/make_euroc_fixture_torch.py).

Runs on the CUDA card unless --device names another device. On the card the
rectified images stay there up to FusedSlam.process_frame, and the native
loader is required (no image library is imported); elsewhere images decode
through PIL where g++ is missing.
"""
import sys, os; sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))  # noqa: E401,E702

import argparse
import json
import tempfile

DEFAULT_OUT = os.path.join(tempfile.gettempdir(), "orbslam3_tpu_torch_euroc")


def slam_config(profile: str, imu_calib=None):
    """The runner's SlamConfig: "small" is the CPU-sized footprint the
    fixture test runs, "full" the configuration real sequences run."""
    from orbslam3_tpu_torch.frontend.orb import OrbConfig
    from orbslam3_tpu_torch.map.slam_map import MapCapacity
    from orbslam3_tpu_torch.models.slam import SlamConfig
    from orbslam3_tpu_torch.models.tracker import TrackConfig

    if profile == "small":
        cfg = SlamConfig(orb=OrbConfig(n_features=384, n_levels=4),
                         cap=MapCapacity(max_kf=64, n_feat=384, max_mp=8192, max_obs=8),
                         track=TrackConfig(p_local=2048), ba_points=1024, kf_max_frames=4,
                         imu_init_kfs=8)
    else:
        cfg = SlamConfig(kf_max_frames=6)
    if imu_calib is not None:
        # per-rig noise densities from imu0/sensor.yaml
        cfg = cfg._replace(imu_noise=imu_calib.noise)
    return cfg


def rectified_camera(ds, device):
    """(Camera of the rectified left image, the four remap tables on
    `device`) for a dataset's calibration."""
    import torch

    from orbslam3_tpu_torch.frontend.camera import Camera
    from orbslam3_tpu_torch.io.rectify import body_from_rect_cam, stereo_rectify_maps

    w, h = ds.cam0.resolution
    maps = stereo_rectify_maps(ds.cam0.K, ds.cam0.dist, ds.cam0.T_BS,
                               ds.cam1.K, ds.cam1.dist, ds.cam1.T_BS, (w, h))
    Kn = maps.K_new
    # the rectified camera's body extrinsic: states stay in the body frame,
    # so the raw body-frame IMU feeds the pipeline directly
    q_bc, p_bc = body_from_rect_cam(ds.cam0.T_BS, maps.R_rect0)
    cam = Camera.create(Kn[0, 0], Kn[1, 1], Kn[0, 2], Kn[1, 2], maps.baseline, w, h,
                        q_bc=q_bc, p_bc=p_bc)
    tables = [torch.from_numpy(m).to(device)
              for m in (maps.map_x0, maps.map_y0, maps.map_x1, maps.map_y1)]
    return cam, tables


def run(seq_dir: str, outdir: str = DEFAULT_OUT, profile: str = "full", max_frames: int = 0,
        cache_dir: str = None, vocab_path: str = None, loop_cfg=None, device=None, hook=None):
    """scripts/run_euroc.py::run on the port. `cache_dir` is accepted for
    the JAX runner's signature; the port has no compilation cache.
    `device` picks the device (the card when None). `hook(i, slam)`, if
    given, runs before frame i and, with i = frames, after finalize.
    Returns the JSON record:
    frames, keyframes, imu_initialized, native_loader, outdir, device, the
    loop closer's counts with a vocabulary, and ate_m with ground truth."""
    import torch

    from orbslam3_tpu_torch import default_device
    from orbslam3_tpu_torch.eval.metrics import ate_rmse
    from orbslam3_tpu_torch.io import native
    from orbslam3_tpu_torch.io.euroc import EurocDataset
    from orbslam3_tpu_torch.io.rectify import remap_u8
    from orbslam3_tpu_torch.models.fused import FusedSlam
    from orbslam3_tpu_torch.viz.export import save_trajectory_tum

    dev = default_device(device)
    if dev.type == "cuda":
        native.build()  # raises with the compiler's message
    ds = EurocDataset(seq_dir)
    os.makedirs(outdir, exist_ok=True)
    cam, (mx0, my0, mx1, my1) = rectified_camera(ds, dev)
    vocab = None
    if vocab_path:
        # a DBoW2 text vocabulary (ORBvoc.txt's format) enables loop closing
        from orbslam3_tpu_torch.loop.vocab import load_dbow2_text

        vocab = load_dbow2_text(vocab_path)
    slam = FusedSlam(cam, slam_config(profile, ds.imu_calib), vocabulary=vocab,
                     warmup=vocab is not None, loop_cfg=loop_cfg, device=dev)

    w, h = ds.cam0.resolution
    n = len(ds) if not max_frames else min(len(ds), max_frames)
    prefetch = None
    if native.available():
        prefetch = [native.ImagePrefetcher(ds.image_paths(c)[:n], w, h, threads=3)
                    for c in ("cam0", "cam1")]
    try:
        for i in range(n):
            if hook is not None:
                hook(i, slam)
            t = ds.frame_time(i)
            t_prev = ds.frame_time(i - 1) if i > 0 else t
            raw = ([p.get(i) for p in prefetch] if prefetch is not None
                   else ds.stereo_pair_u8(i))
            g, a, d = ds.imu_between(t_prev, t)
            left, right = [torch.from_numpy(x).to(dev) for x in raw]
            slam.process_frame(remap_u8(left, mx0, my0), remap_u8(right, mx1, my1), g, a, d, t)
            if i % 100 == 0:
                print(f"frame {i}/{n}", file=sys.stderr)
        slam.finalize()
        if hook is not None:
            hook(n, slam)
    finally:
        for p in prefetch or ():
            p.close()

    ts, ps, qs = slam.trajectory_arrays()
    save_trajectory_tum(os.path.join(outdir, "trajectory.tum"), ts, ps, qs)
    gt = ds.groundtruth_at_frames()
    result = {"frames": n, "keyframes": int(slam.map.n_kf),
              "imu_initialized": slam.imu_initialized, "native_loader": prefetch is not None,
              "outdir": outdir, "device": str(dev)}
    if slam.loop_closer is not None:
        result["loop_corrections"] = int(slam.loop_closer.stats.corrected)
        result["loop_candidates_checked"] = int(slam.loop_closer.stats.candidates_checked)
    if gt is not None:
        result["ate_m"] = round(ate_rmse(ps - ps[0], gt[: len(ps)]), 4)
    return result


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("sequence")
    ap.add_argument("outdir", nargs="?", default=DEFAULT_OUT)
    ap.add_argument("--profile", choices=["full", "small"], default="full")
    ap.add_argument("--max-frames", type=int, default=0)
    ap.add_argument("--vocab", default=None,
                    help="DBoW2 ORBvoc.txt vocabulary; enables loop closing")
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    a = ap.parse_args()
    result = run(a.sequence, a.outdir, a.profile, a.max_frames, vocab_path=a.vocab,
                 device=a.device)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
