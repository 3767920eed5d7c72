"""Record the JAX runs of the behaviour scenarios that the torch port is held to.

Runs each scenario of scripts/scenarios_torch.py (the worlds, configurations
and events of the JAX package's slow end-to-end tests, and two full-width
runs on bench.py::HARD_WORLD under BENCH_CFG) through the JAX package's
FusedSlam on the CPU, and the synthesized ORBvoc-scale vocabulary through
its loop/vocab.py. For each run it writes scenarios_torch.record (per frame
t, mode, keyframe flag, inliers, raw pose and the left image's checksum; at
the end the IMU, the host services' counters, the keyframe rows, the atlas
size, gravity and biases) and the JAX test's bars computed on it; for the
vocabulary the leaf ids of the 1024 queries and their sparse BoW. The
RANSAC-seed draws of the poisoned runs (every frame whose reference-keyframe
fallback drew them: its time, the valid count and the (128, 3) draws) go to
data/scenario_draws.npz, recorded by wrapping the JAX package's
robust_pose_3d3d in a host callback that takes the same draws from the same
key. Output: orbslam3_tpu_torch/data/scenario_reference.json; chip_smoke.py
(phase 13) and tests/test_torch_scenarios*.py hold the port to it. CPU times
in it are not a speed figure of any device.

    JAX_PLATFORMS=cpu python scripts/make_scenario_reference.py [--jobs 3] [NAME ...]
    JAX_PLATFORMS=cpu python scripts/make_scenario_reference.py --probe-evicts [MAX_MP ...]

Without NAMEs every scenario is recorded; each run is made in a process of
its own, --jobs at a time, and merged into the existing file as it ends.
--probe-evicts runs long_run_compacts' world at the given max_mp values
(multiples of 128 below 2048 by default; p_local cut to max_mp below 1024)
and prints each run's stale-point evictions: long_run_evicts takes the
largest that evicts (scenarios_torch.LONG_RUN_EVICTS_MAX_MP).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import numpy as np  # noqa: E402

import scenarios_torch as sc  # noqa: E402

RENDER_WORKERS = 4


def jax_pkg() -> dict:
    from orbslam3_tpu.frontend.orb import OrbConfig
    from orbslam3_tpu.io.synthetic import SyntheticConfig, SyntheticWorld
    from orbslam3_tpu.map.slam_map import MapCapacity
    from orbslam3_tpu.models.slam import SlamConfig
    from orbslam3_tpu.models.tracker import TrackConfig

    return dict(SyntheticConfig=SyntheticConfig, SyntheticWorld=SyntheticWorld,
                SlamConfig=SlamConfig, OrbConfig=OrbConfig, MapCapacity=MapCapacity,
                TrackConfig=TrackConfig)


def spawn_render(world, times, blackout=None) -> list:
    """The JAX world's frames as uint8 pairs (flat 127 in the blackout),
    rendered in spawned workers: forking a process that already runs JAX's
    threads can deadlock."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    from orbslam3_tpu.io.synthetic import _pool_init, _render_one

    blank = np.full((world.cfg.height, world.cfg.width), 127, np.uint8)
    live = [t for t in times if not (blackout is not None and blackout[0] <= t < blackout[1])]
    with ProcessPoolExecutor(RENDER_WORKERS, mp_context=multiprocessing.get_context("spawn"),
                             initializer=_pool_init, initargs=(world,)) as ex:
        rendered = dict(zip(live, ex.map(_render_one, live, chunksize=4)))
    return [tuple(x.astype(np.uint8) for x in rendered[t]) if t in rendered else (blank, blank)
            for t in times]


def draw_recorder():
    """Wrap the JAX package's robust_pose_3d3d so that each call that runs
    (the RANSAC seed runs under the fallback's lax.cond) sends its key, valid
    count and draws (jax.random.randint(key, (n_hyp, 3), 0, max(nv, 1)), the
    function's own) to the host. Returns (records, restore)."""
    import jax
    import jax.numpy as jnp

    from orbslam3_tpu.optim import robust_pose as rp

    records, orig = [], rp.robust_pose_3d3d

    def store(key, nv, draws):
        records.append((np.asarray(key).astype(np.uint32).tolist(), int(nv),
                        np.asarray(draws, np.int16)))

    def recorded(Xw, Xb, valid, key, cam_bf, cam_fx, n_hyp=128, px_tol=4.0):
        nv = jnp.sum(valid.astype(jnp.int32))
        draws = jax.random.randint(key, (n_hyp, 3), 0, jnp.maximum(nv, 1))
        jax.debug.callback(store, key, nv, draws)
        return orig(Xw, Xb, valid, key, cam_bf, cam_fx, n_hyp=n_hyp, px_tol=px_tol)

    rp.robust_pose_3d3d = recorded

    def restore():
        rp.robust_pose_3d3d = orig

    return records, restore


def frame_keys(times) -> dict:
    """models/fused.py's RANSAC key of each frame time: fold_in(PRNGKey(17),
    bitcast(float32 t)), as a tuple -> the frame's index."""
    import jax
    import jax.numpy as jnp

    out = {}
    for i, t in enumerate(times):
        key = jax.random.fold_in(jax.random.PRNGKey(17), jax.lax.bitcast_convert_type(
            jnp.asarray(t, jnp.float32), jnp.int32))
        out[tuple(np.asarray(key).astype(np.uint32).tolist())] = i
    return out


def record_run(name: str, max_mp: int | None = None) -> dict:
    import jax
    import jax.numpy as jnp

    from orbslam3_tpu.geometry import quat
    from orbslam3_tpu.models.fused import FusedSlam

    if max_mp is not None:  # --probe-evicts
        spec = dict(sc.SCENARIOS["long_run_compacts"])
        spec["cfg"] = dict(spec["cfg"], cap=dict(spec["cfg"]["cap"], max_mp=max_mp),
                           track=dict(p_local=min(1024, max_mp)))
        sc.SCENARIOS[name] = spec
    spec = sc.SCENARIOS[name]
    world, cfg, times = sc.build(jax_pkg(), name)
    frames = spawn_render(world, times, spec.get("blackout"))
    records, restore = draw_recorder() if "poison_t" in spec else ([], lambda: None)
    t0 = time.perf_counter()
    slam = FusedSlam(world.cam, cfg, service_every=spec["service_every"])
    try:
        events = sc.drive(slam, world, times, frames, name,
                          lambda x: jnp.asarray(x, jnp.float32), quat)
        jax.effects_barrier()
    finally:
        restore()
    wall = time.perf_counter() - t0
    rec = sc.record(slam, world, times, frames, name, events)
    rec["bars"] = {label: bool(ok) for label, ok in sc.test_bars(name, rec, world.cfg)}
    rec.update(source=spec["source"], service_every=spec["service_every"],
               backend=jax.default_backend(), cpu_wall_s=round(wall, 1))
    if records:
        keys = frame_keys(times)
        rows = sorted((keys[tuple(k)], nv, d) for k, nv, d in records)
        rec["draws"] = dict(frames=[r[0] for r in rows], nv=[r[1] for r in rows])
        np.savez_compressed(draws_part(name), frame=np.array([r[0] for r in rows], np.int32),
                            t=np.array([times[r[0]] for r in rows], np.float32),
                            nv=np.array([r[1] for r in rows], np.int32),
                            draws=np.stack([r[2] for r in rows]) if rows
                            else np.zeros((0, 128, 3), np.int16))
    return rec


def record_orbvoc() -> dict:
    import jax
    import jax.numpy as jnp

    from orbslam3_tpu.loop import vocab as vb

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "orbvoc_synth.txt")
        t0 = time.perf_counter()
        queries = sc.orbvoc_text(path)
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        voc = vb.load_dbow2_text(path)
        load_s = time.perf_counter() - t0
    leaves = vb.quantize(voc, jnp.asarray(queries), jnp.ones(len(queries), bool))
    ids, w = vb.bow_sparse(voc, leaves)
    s = vb.score_sparse_many(voc, ids, w, ids[None], w[None])
    n = sc.ORBVOC_K ** sc.ORBVOC_L
    lv = np.asarray(leaves)
    return dict(source="tests/test_vocab_scale.py:115", n_leaves=int(voc.n_leaves),
                leaves=lv.tolist(), ids=np.asarray(ids).tolist(),
                w=np.asarray(w, np.float64).tolist(), self_score=float(s[0]),
                bars={f"{n} leaves": int(voc.n_leaves) == n,
                      "every leaf id in [0, 10^6)": bool(((lv >= 0) & (lv < n)).all()),
                      "self-score 1.0 within 1e-4": abs(float(s[0]) - 1.0) <= 1e-4},
                backend=jax.default_backend(), cpu_write_s=round(write_s, 1),
                cpu_load_s=round(load_s, 1))


def draws_part(name: str) -> str:
    return os.path.join(tempfile.gettempdir(), f"scenario_draws_{name}.npz")


def dumps(ref: dict) -> str:
    """Indented JSON with each per-frame list on a line of its own."""
    def one(rec):
        head = {k: v for k, v in rec.items() if k not in ("per_frame", "leaves", "ids", "w")}
        lines = [f'   "{k}": {json.dumps(v)}' for k, v in head.items()]
        lines += [f'   "{k}": {json.dumps(rec[k])}' for k in ("leaves", "ids", "w") if k in rec]
        if "per_frame" in rec:
            pf = ",\n".join(f'    "{k}": {json.dumps(v)}' for k, v in rec["per_frame"].items())
            lines.append('   "per_frame": {\n' + pf + "\n   }")
        return "{\n" + ",\n".join(lines) + "\n  }"

    runs = ",\n".join(f'  "{k}": {one(v)}' for k, v in ref["scenarios"].items())
    head = [f' "{k}": {json.dumps(v)}' for k, v in ref.items() if k != "scenarios"]
    return "{\n" + ",\n".join(head + [' "scenarios": {\n' + runs + "\n }"]) + "\n}\n"


def merge(name: str, rec: dict):
    ref = sc.load_reference() if os.path.exists(sc.REFERENCE) else {}
    ref.update(note="the JAX package's FusedSlam and loop/vocab.py on the CPU, written by "
                    "scripts/make_scenario_reference.py: accuracy and behaviour reference "
                    "only; cpu_* times are not a speed figure of any device",
               draws="orbslam3_tpu_torch/data/scenario_draws.npz")
    runs = ref.setdefault("scenarios", {})
    runs[name] = rec
    order = list(sc.RUNS) + [sc.ORBVOC]
    ref["scenarios"] = {k: runs[k] for k in order if k in runs}
    with open(sc.REFERENCE, "w") as f:
        f.write(dumps(ref))
    if os.path.exists(draws_part(name)):
        old = dict(np.load(sc.DRAWS)) if os.path.exists(sc.DRAWS) else {}
        with np.load(draws_part(name)) as part:
            old.update({f"{name}.{k}": part[k] for k in part.files})
        np.savez_compressed(sc.DRAWS, **old)
        os.remove(draws_part(name))


def children(names: list, jobs: int, extra=()) -> dict:
    """Each name in a child process, `jobs` at a time: {name: record}."""
    queue, running, done = list(names), {}, {}
    while queue or running:
        while queue and len(running) < jobs:
            name = queue.pop(0)
            running[name] = (subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--child", *extra, name],
                stdout=subprocess.PIPE, text=True), time.perf_counter())
        time.sleep(2.0)
        for name, (p, t0) in list(running.items()):
            if p.poll() is None:
                continue
            del running[name]
            out = p.stdout.read().strip().splitlines()
            if p.returncode != 0 or not out:
                print(f"{name}: exit code {p.returncode}", flush=True)
                done[name] = None
                continue
            done[name] = json.loads(out[-1])
            print(f"{name}: {time.perf_counter() - t0:.0f} s", flush=True)
    return done


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("names", nargs="*")
    ap.add_argument("--jobs", type=int, default=3)
    ap.add_argument("--probe-evicts", action="store_true")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        (name,) = args.names
        if args.probe_evicts:
            rec = record_run(f"probe_{name}", max_mp=int(name))
        else:
            rec = record_orbvoc() if name == sc.ORBVOC else record_run(name)
        print(json.dumps(rec))
        return 0
    if args.probe_evicts:
        sizes = args.names or [str(m) for m in range(1920, 511, -128)]
        for m, rec in children(sizes, args.jobs, ("--probe-evicts",)).items():
            if rec is not None:
                print(f"max_mp {m}: mp_evictions {rec['mp_evictions']}, kf_evictions "
                      f"{rec['kf_evictions']}, compactions {rec['compactions']}, ok_frac "
                      f"{rec['ok_frac']:.3f}, n_mp {rec['n_mp']}", flush=True)
        return 0
    names = args.names or list(sc.RUNS) + [sc.ORBVOC]
    t0 = time.perf_counter()
    failed = []
    for name, rec in children(names, args.jobs).items():
        if rec is None:
            failed.append(name)
            continue
        merge(name, rec)
        print(f"{name}: bars {rec['bars']}" + (
            f", ATE {rec['ate_m']:.4f} m, ok_frac {rec['ok_frac']:.3f}, IMU after frame "
            f"{rec['imu_init_frame']}, compactions {rec['compactions']}, evictions "
            f"kf {rec['kf_evictions']} mp {rec['mp_evictions']} map {rec['map_evictions']}"
            if name != sc.ORBVOC else ""), flush=True)
    print(f"all: {time.perf_counter() - t0:.0f} s", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
