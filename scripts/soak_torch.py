"""Long-sequence soak at capacity, on the PyTorch port (the counterpart of
scripts/soak.py, without JAX).

An EuRoC-MH-length (default 160 s, 3200 frames) adversarial textured
sequence with continuous revisits (a full pan every 16 s), noisy and
biased IMU, and loop closing on, through the port's FusedSlam at the
production configuration and full capacities (256 keyframes, 32768 map
points), chunk 8, a service round every 8 frames, the loop closer warmed
up. The run crosses the keyframe capacity again and again, so compaction,
the loop closer's row remaps and the growth of the per-frame outputs are
exercised together.

Prints one JSON row a window (frames/s, keyframe and point counts,
compaction, loop, relocalization and eviction counters, host RSS) and a
summary JSON line with scripts/soak.py's fields. `--out PATH` writes the
markdown block of the rows to PATH (never to BASELINE.md).

Usage: python scripts/soak_torch.py [--duration 160] [--window 16]
       [--out PATH] [--device cpu]
"""
import sys, os; sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import argparse
import json
import resource
import time

import numpy as np
import torch

# bench.py::HARD_WORLD
HARD_WORLD = dict(texture="textured", exposure_drift=0.3, image_noise_std=3.0,
                  salt_pepper_frac=0.002, motion_blur_samples=3, exposure_time=0.02)


def soak_world_config(duration: float, **over):
    """scripts/soak.py's world: revisit laps every 16 s, noisy biased IMU."""
    from orbslam3_tpu_torch.io.synthetic import SyntheticConfig

    kw = dict(duration=duration, n_landmarks=1500, seed=7, yaw_amp=0.0,
              yaw_rate=2 * np.pi / 16.0, pos_freq=(0.125, 0.1875, 0.25), imu_noise=True,
              gyro_bias=(0.003, -0.002, 0.004), accel_bias=(0.03, 0.02, -0.04), **HARD_WORLD)
    kw.update(over)
    return SyntheticConfig(**kw)


def soak(world_cfg, slam_cfg, window: float = 16.0, device=None, chunk: int = 8,
         service_every: int = 8, workers: int = 0, log=print):
    """Run the soak on `world_cfg` with `slam_cfg`. Returns (rows, summary,
    slam): one row a window of `window` seconds of frames."""
    from orbslam3_tpu_torch import default_device
    from orbslam3_tpu_torch.eval.metrics import ate_rmse
    from orbslam3_tpu_torch.io.synthetic import SyntheticWorld
    from orbslam3_tpu_torch.loop.vocab import train_world_vocab
    from orbslam3_tpu_torch.models.fused import FusedSlam

    dev = default_device(device)
    world = SyntheticWorld(world_cfg)
    times = world.frame_times()
    t0 = time.perf_counter()
    frames = world.render_sequence(times, workers=workers)
    log(f"# rendered {len(frames)} frames in {time.perf_counter() - t0:.0f} s")
    imu = [world.imu_window(times[i - 1] if i > 0 else t, t) for i, t in enumerate(times)]

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    vocab = train_world_vocab(world, frames, device=dev)
    slam = FusedSlam(world.cam, slam_cfg, service_every=service_every, chunk=chunk,
                     vocabulary=vocab, warmup=True, device=dev)
    win_frames = int(window * world_cfg.cam_hz)
    rows = []
    t_start = t_win = time.perf_counter()
    for i, t in enumerate(times):
        g, a, d = imu[i]
        slam.process_frame(frames[i][0], frames[i][1], g, a, d, float(t))
        if (i + 1) % win_frames == 0:
            slam.flush()
            sync()  # soak instrumentation: the window's time includes its device work
            now = time.perf_counter()
            modes_w = slam.modes()[-win_frames:]
            row = dict(
                t=float(t), fps=round(win_frames / (now - t_win), 1),
                n_kf=int(slam.map.n_kf), n_mp=int(slam.map.n_mp),
                ok_frac=round(float((modes_w == 1).mean()), 2),
                compactions=slam.compactions,
                loops=int(slam.loop_closer.stats.corrected),
                relocs=int(slam.loop_closer.stats.relocalized),
                kf_evict=slam.kf_evictions, mp_evict=slam.mp_evictions,
                map_evict=slam.map_evictions,
                maps=int(slam.map.next_map_id),
                outs_len=len(slam.outs),
                rss_mb=resource.getrusage(resource.RUSAGE_SELF).ru_maxrss // 1024,
            )
            rows.append(row)
            log(json.dumps(row))
            t_win = time.perf_counter()
    slam.finalize()
    sync()
    total_s = time.perf_counter() - t_start

    t0 = time.perf_counter()
    _, ps, _ = slam.trajectory_arrays()
    traj_s = time.perf_counter() - t0
    gt_p, _ = world.gt_trajectory()
    ate = ate_rmse(ps, gt_p[: len(ps)])
    fps_all = [r["fps"] for r in rows] or [round(len(times) / total_s, 1)]
    summary = dict(
        metric="soak",
        duration_s=world_cfg.duration,
        frames=len(times),
        fps_mean=round(float(np.mean(fps_all)), 1),
        fps_first_window=fps_all[0],
        fps_last_window=fps_all[-1],
        fps_min=min(fps_all),
        ate_m=round(float(ate), 4),
        n_kf_final=int(slam.map.n_kf),
        n_mp_final=int(slam.map.n_mp),
        ok_frac=round(float((slam.modes() == 1).mean()), 3),
        compactions=slam.compactions,
        loop_corrections=int(slam.loop_closer.stats.corrected),
        relocalizations=int(slam.loop_closer.stats.relocalized),
        kf_evictions=slam.kf_evictions,
        mp_evictions=slam.mp_evictions,
        map_evictions=slam.map_evictions,
        maps_spawned=int(slam.map.next_map_id),
        candidates_checked=int(slam.loop_closer.stats.candidates_checked),
        outs_len_final=len(slam.outs),
        trajectory_export_s=round(traj_s, 2),
        rss_mb_final=resource.getrusage(resource.RUSAGE_SELF).ru_maxrss // 1024,
        total_s=round(total_s, 1),
        backend=dev.type,
    )
    log(json.dumps(summary))
    return rows, summary, slam


def markdown(rows, summary, card: str = "") -> str:
    """The rows and summary as a markdown block (scripts/soak.py's table)."""
    lines = [
        f"## Soak: {summary['duration_s']:.0f} s at capacity (`scripts/soak_torch.py`, "
        f"{summary['backend']}{', ' + card if card else ''})", "",
        "| t [s] | fps | keyframes | map points | compactions | loops | evictions kf/mp/maps "
        "| RSS [MB] |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        lines.append(f"| {r['t']:.0f} | {r['fps']} | {r['n_kf']} | {r['n_mp']} "
                     f"| {r['compactions']} | {r['loops']} "
                     f"| {r['kf_evict']}/{r['mp_evict']}/{r['map_evict']} | {r['rss_mb']} |")
    lines += ["", f"End: ATE {summary['ate_m']} m over {summary['frames']} frames; fps first->last "
              f"window {summary['fps_first_window']} -> {summary['fps_last_window']} (min "
              f"{summary['fps_min']}); trajectory export of {summary['outs_len_final']} "
              f"out-chunks took {summary['trajectory_export_s']} s; "
              f"{summary['loop_corrections']} loop corrections, "
              f"{summary['candidates_checked']} candidates checked.", ""]
    return "\n".join(lines)


def main():
    from orbslam3_tpu_torch.models.slam import SlamConfig

    ap = argparse.ArgumentParser()
    ap.add_argument("--duration", type=float, default=160.0)
    ap.add_argument("--window", type=float, default=16.0)
    ap.add_argument("--out", default=None, help="write the markdown block here")
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = ap.parse_args()
    slam_cfg = SlamConfig(use_imu=True, kf_max_frames=6, ba_iters=3, ba_window=6,
                          lost_timeout=5.0)
    rows, summary, _ = soak(soak_world_config(args.duration), slam_cfg, window=args.window,
                            device=args.device, workers=4,
                            log=lambda s: print(s, flush=True))
    if args.out:
        card = ""
        if torch.cuda.is_available() and summary["backend"] == "cuda":
            card = torch.cuda.get_device_name(0)
        with open(args.out, "w") as f:
            f.write(markdown(rows, summary, card))


if __name__ == "__main__":
    main()
