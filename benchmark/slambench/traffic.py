"""The benchmark's one traffic generator.

A configuration fixes the world (slambench/synthetic.py, the frozen copy of
the program's generator): its geometry, textures, photometric stress,
trajectory and IMU rate, and an optional top-level `blackout: [t0, t1]`
(a camera dropout: the frames at t0 <= t < t1 are flat gray, 127, in both
images, as SyntheticWorld.render_sequence renders them; the IMU runs on).
The rendering depends on the configuration alone, so it is made once per
checkout into `benchmark/.cache/render/` and read back by every later run.
A traffic mix (benchmark/traffic/<name>.json) and `--seed` decide the rest:

* `imu_noise`: white noise at the configuration's densities (`slam.imu_noise`,
  sigma * sqrt(imu_hz) a sample) is added to the exact IMU samples;
* `pixel_noise_frac`: in each image that share of the pixels, drawn
  directly (with replacement), moves one gray level up or down, clipped to
  0..255 (the program's `perturb_frames` rule at a fixed count an image).

Every draw comes from numpy.random.default_rng(seed) in a fixed order
(session, then IMU, then frame, left before right), so the same seed gives
the same inputs, and every seed the same frame count and sizes.
"""
from __future__ import annotations

import fcntl
import hashlib
import json
import multiprocessing
import os
import shutil
import time
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path
from typing import NamedTuple

import numpy as np

from slambench import synthetic as syn
from slambench.manifest import BENCH_DIR

CACHE_DIR = BENCH_DIR / ".cache" / "render"


class Session(NamedTuple):
    """One session's inputs: frame times, (n, 2, H, W) uint8 stereo frames,
    and per frame the IMU samples since the frame before it."""

    world: syn.SyntheticWorld
    times: np.ndarray
    frames: np.ndarray
    imu: list


def world_config(config: dict, world_seed: int) -> syn.SyntheticConfig:
    cam = config["camera"]
    q_bc, p_bc = (syn.euroc_t_bc() if cam.get("t_bc") == "euroc_mh_cam0"
                  else ((1.0, 0.0, 0.0, 0.0), (0.0, 0.0, 0.0)))
    return syn.SyntheticConfig(
        seed=world_seed, duration=config["n_frames"] / cam["cam_hz"], cam_hz=cam["cam_hz"],
        imu_hz=cam["imu_hz"], width=cam["width"], height=cam["height"], fx=cam["fx"],
        fy=cam["fy"], baseline=cam["baseline"], q_bc=tuple(q_bc), p_bc=tuple(p_bc),
        **config["world"])


def _key(wcfg: syn.SyntheticConfig, blackout=None) -> str:
    """The rendering's cache key: the generator's source, the world and the
    blackout (a world without one keys as it did before blackouts were
    taken)."""
    src = (Path(syn.__file__).read_bytes() + json.dumps(wcfg._asdict(), sort_keys=True,
                                                        default=str).encode())
    if blackout is not None:
        src += json.dumps({"blackout": [float(t) for t in blackout]}).encode()
    return hashlib.sha256(src).hexdigest()[:16]


def _workers() -> int:
    try:
        return max(len(os.sched_getaffinity(0)), 1)
    except AttributeError:
        return max(os.cpu_count() or 1, 1)


def _render(world: syn.SyntheticWorld, out: Path, workers: int, log, blackout=None):
    """Render every frame of `world` and its exact IMU samples into `out`;
    the frames inside `blackout` flat gray."""
    times = world.frame_times()
    cfg = world.cfg
    frames = np.lib.format.open_memmap(out / "frames.npy", mode="w+", dtype=np.uint8,
                                       shape=(len(times), 2, cfg.height, cfg.width))
    dark = np.zeros(len(times), bool) if blackout is None else (
        (blackout[0] <= times) & (times < blackout[1]))
    frames[dark] = 127
    live = np.flatnonzero(~dark)
    t0 = time.perf_counter()
    if workers <= 1:
        for i in live:
            frames[i] = np.stack(world.render_frame(times[i])).astype(np.uint8)
    else:
        # spawn, not fork: the caller may already hold torch's threads
        with ProcessPoolExecutor(workers, mp_context=multiprocessing.get_context("spawn"),
                                 initializer=syn._pool_init, initargs=(world,)) as ex:
            for i, (l, r) in zip(live, ex.map(syn._render_one, times[live], chunksize=4)):
                frames[i, 0] = l.astype(np.uint8)
                frames[i, 1] = r.astype(np.uint8)
    frames.flush()
    del frames
    imu_t = world.imu_times()
    g, a = zip(*(world.imu_sample(t) for t in imu_t))
    np.savez(out / "imu.npz", t=imu_t, gyro=np.stack(g), acc=np.stack(a))
    log(f"rendered {len(live)} frames of world seed {cfg.seed} ({cfg.width}x{cfg.height}), "
        f"{int(dark.sum())} dark, in {time.perf_counter() - t0:.1f} s on {workers} processes")


def cached_world(wcfg: syn.SyntheticConfig, cache_dir: Path = CACHE_DIR, workers: int = 0,
                 log=print, blackout=None) -> Path:
    """The directory that holds this world's rendering, made on first use.
    A lock file serializes two processes that would render the same world;
    the rendering is written beside its final place and moved there whole."""
    cache_dir = Path(cache_dir)
    cache_dir.mkdir(parents=True, exist_ok=True)
    key = _key(wcfg, blackout)
    final = cache_dir / key
    if (final / "imu.npz").exists():
        return final
    with open(cache_dir / f"{key}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not (final / "imu.npz").exists():
            part = cache_dir / f"{key}.partial"
            shutil.rmtree(part, ignore_errors=True)
            part.mkdir()
            _render(syn.SyntheticWorld(wcfg), part, workers or _workers(), log, blackout)
            os.replace(part, final)
    return final


def _imu_windows(times, imu_t, gyro, acc, imu_hz):
    """Per frame i the samples in [t_{i-1}, t_i) (none for frame 0), as
    SyntheticWorld.imu_window selects them."""
    lo = np.searchsorted(imu_t, np.concatenate([times[:1], times[:-1]]), side="left")
    hi = np.searchsorted(imu_t, times, side="left")
    dt = np.float32(1.0 / imu_hz)
    return [(gyro[a:b], acc[a:b], np.full(b - a, dt, np.float32)) for a, b in zip(lo, hi)]


def build(config: dict, traffic: dict, seed: int, cache_dir: Path = CACHE_DIR,
          workers: int = 0, log=print) -> list:
    """The sessions of one run: [Session] * config["sessions"]."""
    rng = np.random.default_rng(seed)
    cam = config["camera"]
    noise = config["slam"]["imu_noise"]
    sessions = []
    for ws in config["world_seeds"]:
        wcfg = world_config(config, ws)
        d = cached_world(wcfg, cache_dir, workers, log, config.get("blackout"))
        world = syn.SyntheticWorld(wcfg)
        times = world.frame_times()
        frames = np.array(np.load(d / "frames.npy", mmap_mode="r"))
        imu = np.load(d / "imu.npz")
        gyro, acc = imu["gyro"].astype(np.float64), imu["acc"].astype(np.float64)
        if traffic.get("imu_noise", False):
            sr = np.sqrt(cam["imu_hz"])
            gyro = gyro + rng.normal(0.0, noise["sigma_g"] * sr, gyro.shape)
            acc = acc + rng.normal(0.0, noise["sigma_a"] * sr, acc.shape)
        frac = float(traffic.get("pixel_noise_frac", 0.0))
        if frac > 0.0:
            n_img = frames.shape[2] * frames.shape[3]
            k = max(int(round(frac * n_img)), 1)
            flat = frames.reshape(frames.shape[0] * 2, n_img)
            for img in flat:
                idx = rng.integers(0, n_img, k)
                step = rng.integers(0, 2, k).astype(np.int16) * 2 - 1
                img[idx] = np.clip(img[idx].astype(np.int16) + step, 0, 255).astype(np.uint8)
        sessions.append(Session(world, times, frames,
                                _imu_windows(times, imu["t"], gyro.astype(np.float32),
                                             acc.astype(np.float32), cam["imu_hz"])))
    return sessions
