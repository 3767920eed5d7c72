"""Sequence evaluation harness of the torch port: seeds x configurations -> the eval table.

Port of scripts/eval_suite.py. It runs FusedSlam on the deterministic
synthetic world across seeds and sensor configurations (stereo,
stereo-inertial, + loop closing, EuRoC body-camera extrinsics, the easy
fiducial world, the drift-then-revisit world with and without loop
closing), computes ATE, Sturm RPE over 20 frames and the frames/s after 8
warm-up frames, and prints the table (to --out PATH, never to BASELINE.md).
The worlds come from the port's own copies: chip_smoke.HARD_WORLD,
chip_smoke.REVISIT_WORLD and orbslam3_tpu_torch/io/synthetic.py::euroc_t_bc.

    python3 scripts/eval_suite_torch.py [--seeds 7,11,23] [--duration 8] [--chunk 8]
        [--modes stereo,inertial,...] [--device cpu] [--out PATH]

Runs on the CUDA card unless --device cpu is given, and raises where there is
no card. scripts/make_eval_reference.py records the JAX package's runs of
the same configurations (orbslam3_tpu_torch/data/eval_reference.json);
`load_reference` reads that file.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

REFERENCE = os.path.join(ROOT, "orbslam3_tpu_torch", "data", "eval_reference.json")
MODES = ("stereo", "inertial", "inertial_easy", "loop", "extrinsics", "revisit", "revisit_loop")
LOOP_MODES = ("loop", "revisit_loop")
WARM = 8
LABEL = dict(
    stereo="Stereo (visual only)",
    inertial="Stereo-inertial",
    inertial_easy="Stereo-inertial, EASY fiducial world (reference row)",
    loop="Stereo-inertial + loop closing",
    extrinsics="Stereo-inertial, EuRoC T_BS extrinsics",
    revisit="Drift+revisit 24 s, odometry only",
    revisit_loop="Drift+revisit 24 s, + loop closing",
)

_WORLD_CACHE = {}


def world_key(seed: int, duration: float, mode: str) -> tuple:
    """The world a mode runs on: the revisit modes share one 24 s (or
    longer) world, the others take the hard world but for inertial_easy
    (the fiducial world) and extrinsics (EuRoC's T_BS)."""
    if mode in ("revisit", "revisit_loop"):
        return ("revisit", seed, max(duration, 24.0))
    if mode == "inertial_easy":
        return ("easy", seed, duration)
    if mode == "extrinsics":
        return ("extrinsics", seed, duration)
    return ("hard", seed, duration)


def _get_world(seed: int, duration: float, mode: str, workers: int = 0):
    """Memoized (world, times, frames, imu): each (world kind, seed) is
    rendered once, for the warm-up run and every run after it."""
    import chip_smoke
    from orbslam3_tpu_torch.io.synthetic import SyntheticConfig, SyntheticWorld, euroc_t_bc

    key = world_key(seed, duration, mode)
    if key in _WORLD_CACHE:
        return _WORLD_CACHE[key]
    blackout = None
    if key[0] == "revisit":
        kw = dict(chip_smoke.REVISIT_WORLD, **chip_smoke.HARD_WORLD, seed=seed, duration=key[2])
        blackout = chip_smoke.REVISIT_BLACKOUT
    else:
        kw = dict(duration=duration, n_landmarks=1500, seed=seed)
        if key[0] != "easy":
            kw.update(chip_smoke.HARD_WORLD)
        if key[0] == "extrinsics":
            q_bc, p_bc = euroc_t_bc()
            kw.update(q_bc=q_bc, p_bc=p_bc)
    world = SyntheticWorld(SyntheticConfig(**kw))
    times = world.frame_times()
    frames = world.render_sequence(times, blackout=blackout, workers=workers)
    imu = [world.imu_window(times[i - 1] if i > 0 else t, t) for i, t in enumerate(times)]
    _WORLD_CACHE[key] = out = (world, times, frames, imu)
    return out


def run_slam(seed: int, duration: float, mode: str, chunk: int = 8, device=None):
    """One run of scripts/eval_suite.py::run_config's configuration on the
    port: (the FusedSlam after `finalize`, the table's row)."""
    import torch

    from orbslam3_tpu_torch import default_device
    from orbslam3_tpu_torch.eval.metrics import ate_rmse, rpe_rmse
    from orbslam3_tpu_torch.models.fused import FusedSlam
    from orbslam3_tpu_torch.models.slam import SlamConfig

    dev = default_device(device)
    world, times, frames, imu = _get_world(seed, duration, mode)
    use_imu = mode != "stereo"
    slam_cfg = SlamConfig(use_imu=use_imu, kf_max_frames=6, ba_iters=3, ba_window=6,
                          lost_timeout=5.0)
    vocab = None
    if mode in LOOP_MODES:
        from orbslam3_tpu_torch.loop.vocab import train_world_vocab

        vocab = train_world_vocab(world, frames, dev)
    slam = FusedSlam(world.cam, slam_cfg, service_every=8, chunk=chunk, vocabulary=vocab,
                     device=dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    for i in range(WARM):
        g, a, d = imu[i]
        slam.process_frame(frames[i][0], frames[i][1], g, a, d, float(times[i]))
    slam.flush()
    sync()
    t0 = time.perf_counter()
    for i in range(WARM, len(times)):
        g, a, d = imu[i]
        slam.process_frame(frames[i][0], frames[i][1], g, a, d, float(times[i]))
    slam.finalize()
    sync()
    fps = (len(times) - WARM) / (time.perf_counter() - t0)

    _, ps, qs = slam.trajectory_arrays()
    gt_p, gt_q = world.gt_trajectory()
    ate = ate_rmse(ps, gt_p[: len(ps)])
    rpe_t, rpe_r = rpe_rmse(ps, gt_p[: len(ps)], qs, gt_q[: len(ps)], delta=20)
    row = dict(
        seed=seed, mode=mode, ate_m=ate, rpe_m=rpe_t, rpe_rad=rpe_r, fps=fps,
        keyframes=int(slam.map.n_kf),
        imu_init=bool(slam.imu_initialized) if use_imu else None,
        loops=int(slam.loop_closer.stats.corrected) if slam.loop_closer else None,
    )
    return slam, row


def run_config(seed: int, duration: float, mode: str, chunk: int = 8, device=None) -> dict:
    """scripts/eval_suite.py::run_config on the port: the table's row."""
    return run_slam(seed, duration, mode, chunk, device)[1]


def frame_checksum(frame) -> str:
    """The first 16 hex digits of the SHA-256 of a rendered stereo pair's
    uint8 bytes, left then right."""
    h = hashlib.sha256()
    for img in frame:
        h.update(np.ascontiguousarray(img, dtype=np.uint8).tobytes())
    return h.hexdigest()[:16]


def run_record(frames, modes, is_kf, n_inliers, imu_init_frame, corrections) -> dict:
    """What scripts/make_eval_reference.py records of a run beside its row,
    from either package's FusedSlam: the per-frame tracker mode, keyframe
    flag and inlier count, the frame after which the IMU initialized, the
    share of frames tracked OK, each correction's keyframe pair and times,
    and the checksums of the first and the last rendered frame."""
    from orbslam3_tpu_torch.models.fused import MODE_OK

    modes = np.asarray(modes).astype(int)
    return dict(
        imu_init_frame=imu_init_frame,
        ok_frac=float((modes == MODE_OK).mean()),
        n_frames=int(len(modes)),
        checksum=dict(first=frame_checksum(frames[0]), last=frame_checksum(frames[-1])),
        corrections=[{k: c[k] for k in ("kf_id", "cand", "kf_time", "cand_time")}
                     for c in corrections],
        per_frame=dict(mode=modes.tolist(), is_kf=np.asarray(is_kf).astype(int).tolist(),
                       n_inliers=np.asarray(n_inliers).astype(int).tolist()),
    )


def port_record(slam, frames) -> dict:
    """run_record of the port's FusedSlam after `finalize`."""
    outs = slam.frame_outputs()
    corrections = slam.loop_closer.corrections if slam.loop_closer is not None else []
    return run_record(frames, outs.mode, outs.is_kf, outs.n_inliers, slam.imu_init_frame,
                      corrections)


def first_departure(rec: dict, ref: dict) -> str:
    """The first frame where a run's per-frame record (tracker mode,
    keyframe flag, inlier count) leaves the reference's, or 'none'."""
    for i, row in enumerate(zip(*(rec["per_frame"][k] for k in ("mode", "is_kf", "n_inliers")))):
        want = tuple(ref["per_frame"][k][i] for k in ("mode", "is_kf", "n_inliers"))
        if row != want:
            return (f"frame {i} (mode, keyframe, inliers: port {list(row)}, JAX "
                    f"{list(want)})")
    return "none"


def load_reference(path: str = REFERENCE) -> dict:
    """The JAX record: {"runs": {"<mode>:<seed>": record}, "small": record,
    ...}; each record holds the row of scripts/eval_suite.py::run_config
    and what `run_record` lists."""
    with open(path) as f:
        return json.load(f)


def table(rows: list, modes, n_seeds: int, duration: float, chunk: int, backend: str) -> str:
    """The markdown table scripts/eval_suite.py writes into BASELINE.md,
    one line a mode: the means over seeds (ATE with its spread)."""
    lines = [
        "",
        f"## Eval table (generated by `scripts/eval_suite_torch.py`, "
        f"{n_seeds} seeds x {duration:.0f} s synthetic EuRoC-scale "
        f"ADVERSARIAL textured world, chunk={chunk}, backend {backend})",
        "",
        "| Config | ATE RMSE [m] | RPE@20 [m] | RPE@20 [rad] | fps | notes |",
        "|---|---|---|---|---|---|",
    ]
    for mode in modes:
        rs = [r for r in rows if r["mode"] == mode]
        if not rs:
            continue
        ate = [r["ate_m"] for r in rs]
        rpe = [r["rpe_m"] for r in rs]
        rper = [r["rpe_rad"] for r in rs if r["rpe_rad"] is not None]
        fps = [r["fps"] for r in rs]
        notes = []
        if rs[0]["imu_init"] is not None:
            notes.append(f"imu_init {sum(bool(r['imu_init']) for r in rs)}/{len(rs)}")
        if rs[0]["loops"] is not None:
            notes.append(f"loops {sum(r['loops'] for r in rs)}")
        rper_s = f"{np.mean(rper):.4f}" if rper else "-"
        lines.append(
            f"| {LABEL.get(mode, mode)} "
            f"| {np.mean(ate):.4f} ± {np.std(ate):.4f} "
            f"| {np.mean(rpe):.4f} | {rper_s} "
            f"| {np.mean(fps):.1f} | {', '.join(notes)} |"
        )
    lines.append("")
    return "\n".join(lines)


def main(argv=None) -> int:
    from orbslam3_tpu_torch import default_device

    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", default="7,11,23")
    ap.add_argument("--duration", type=float, default=8.0)
    ap.add_argument("--chunk", type=int, default=8,
                    help="frames per device dispatch; bench.py's configuration uses 8")
    ap.add_argument("--modes", default=",".join(MODES))
    ap.add_argument("--device", default=None,
                    help="torch device; the CUDA card unless given ('cpu' runs on the CPU)")
    ap.add_argument("--out", default=None, help="write the table here (else it is printed)")
    args = ap.parse_args(argv)

    dev = default_device(args.device)
    seeds = [int(s) for s in args.seeds.split(",")]
    modes = args.modes.split(",")
    rows = []
    for mode in modes:
        # one untimed warm-up run per mode: first calls (the kernel's build,
        # allocator growth, the loop closer's first detection) land outside
        # the timed windows
        run_config(seeds[0], args.duration, mode, chunk=args.chunk, device=dev)
        for seed in seeds:
            r = run_config(seed, args.duration, mode, chunk=args.chunk, device=dev)
            rows.append(r)
            print(json.dumps({k: (round(v, 4) if isinstance(v, float) else v)
                              for k, v in r.items()}), flush=True)
    import chip_smoke

    # the card as `nvidia-smi --query-gpu=name,power.limit` names it
    backend = chip_smoke.card_line() if dev.type == "cuda" else "cpu"
    text = table(rows, modes, len(seeds), args.duration, args.chunk, backend)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
        print(f"{args.out} written ({len(rows)} runs)")
    else:
        print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
