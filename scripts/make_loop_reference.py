"""Record the JAX references of the torch port's loop-closing runs.

Runs the JAX package's FusedSlam on the CPU, with its loop closer, on:

  bench    the 8 s bench world (bench.py::build_world, 752x480, 20 Hz) under
           bench.py's odometry configuration with the world's own vocabulary
           (bench.py::train_world_vocab, k=10, 4 levels): bench.py's
           fps_with_loop_closing dispatch, chunk=8, service_every=8,
           warmup=True;
  revisit  bench.py::build_revisit_world(): 24 s, a camera blackout at
           10-13 s with an IMU bias step, a second lap over the first; the
           same dispatch with its own vocabulary, and once more without a
           vocabulary (the odometry run);
  reloc    the relocalization world of tests/test_fused_loop.py (384x256,
           8 s at 10 Hz, a 2 s blackout, lost_timeout=30 s, visual only,
           the test's LoopConfig overrides), with the corrected per-frame
           positions, and the Sim3 RANSAC draws of each of its
           verifications (data/reloc_draws.npz, below).

For each: LoopStats, one event per correction (frame, service round, query
and candidate rows and their keyframe times, merge / loop / relocalization,
the seam the pose graph moved the query by, whether global BA ran and
whether the inertial refinement was accepted), the frame at which the IMU
initialized, ATE of the corrected and of the raw trajectory, the keyframe
count, and the closer's service sequence (tests/torch_parity.py::
record_loop_services). Writes orbslam3_tpu_torch/data/loop_reference.json
and the vocabularies the runs used (data/vocab_bench.npz,
data/vocab_revisit.npz, data/vocab_reloc.npz, and data/vocab_merge.npz: the
merge world of tests/test_fused_loop.py, which chip_smoke.py runs), so that
both packages run the same trees. chip_smoke.py holds the port's runs on the GPU to this
record. For the relocalization world it also writes data/reloc_draws.npz: per
verification in the order the run dispatched them, the query keyframe, the
candidates, their RANSAC masks (C, N) and the (C, 256, 3) samples JAX drew
from fold_in(PRNGKey(7), keyframe) (loop/closer.py:419-420), which
tests/test_torch_fused_reloc.py feeds to the port's LoopCloser.sampler.

    JAX_PLATFORMS=cpu python scripts/make_loop_reference.py [bench|revisit|reloc ...]

With names, only those runs are made and merged into the existing file.
"""
from __future__ import annotations

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

import numpy as np  # noqa: E402

DATA = os.path.join(ROOT, "orbslam3_tpu_torch", "data")
OUT = os.path.join(DATA, "loop_reference.json")
RENDER_WORKERS = 4


def render(world, times, blackout=None):
    """The world's frames, rendered by the torch port's numpy copy of the
    synthetic world (the same images) in spawned worker processes: forking
    a process that runs JAX's threads can deadlock."""
    from orbslam3_tpu_torch.io.synthetic import SyntheticConfig, SyntheticWorld

    port_world = SyntheticWorld(SyntheticConfig(**world.cfg._asdict()))
    return port_world.render_sequence(times, blackout=blackout, workers=RENDER_WORKERS)


def imu_windows(world, times):
    return [world.imu_window(times[i - 1] if i > 0 else t, t) for i, t in enumerate(times)]


def small_world_vocab(world):
    """The vocabulary of tests/test_fused_loop.py: k=8, 3 levels, from the
    left images at t = 0, 1, 2, 3 s."""
    import jax.numpy as jnp

    from orbslam3_tpu.frontend.orb import OrbConfig, detect_orb
    from orbslam3_tpu.loop import vocab as vb

    corpus, doc = [], []
    for i, t in enumerate([0.0, 1.0, 2.0, 3.0]):
        left, _ = world.render_frame(t)
        f = detect_orb(jnp.asarray(left), OrbConfig(n_features=384, n_levels=4))
        d = np.asarray(f.desc)[np.asarray(f.valid)]
        corpus.append(d)
        doc.append(np.full(len(d), i))
    return vb.train_vocabulary(np.concatenate(corpus), k=8, levels=3, doc_ids=np.concatenate(doc))


def save_vocab(voc, name):
    import jax

    from orbslam3_tpu_torch.interop import from_numpy_tree
    from orbslam3_tpu_torch.loop.vocab import save_npz

    path = os.path.join(DATA, f"vocab_{name}.npz")
    save_npz(from_numpy_tree(jax.tree.map(np.asarray, voc)), path)
    return os.path.relpath(path, ROOT), os.path.getsize(path)


def instrument(slam):
    """Record the service sequence and, per correction, what the port's
    LoopCloser.corrections holds: rows, times, kind, seam, global BA,
    inertial refinement."""
    import orbslam3_tpu.map.mapping_ops as mo
    from torch_parity import record_loop_services

    log = record_loop_services(slam, [])
    cl = slam.loop_closer
    events = []
    correct, gba, vi = cl._correct, cl._global_ba, cl._vi_refine
    fuse = mo.fuse_across_seam
    state = {}

    def correct_(st, kf_id, cand, S_rel, cam, record=True):
        kf_t = np.asarray(st.kf_time)
        state["p_in"] = np.asarray(st.kf_p[kf_id])
        ev = dict(frame=slam._frames - 1, service_round=slam._service_round, kf_id=int(kf_id),
                  cand=int(cand), kf_time=float(kf_t[kf_id]), cand_time=float(kf_t[cand]),
                  merge=bool(cl.last_was_merge), reloc=None, gba=False, vi_refine=None)
        state["ev"] = ev
        out = correct(st, kf_id, cand, S_rel, cam, record=record)
        if record:
            events.append(ev)
        return out

    def fuse_(st, kf_id, cand, cam, **kw):
        if "ev" in state:
            p = np.asarray(st.kf_p[int(kf_id)])
            state["ev"]["seam_m"] = float(np.linalg.norm(p - state["p_in"]))
        return fuse(st, kf_id, cand, cam, **kw)

    def gba_(st, anchor, cam):
        if "ev" in state:
            state["ev"]["gba"] = True
        return gba(st, anchor, cam)

    def vi_(st, kf_id, cam):
        out = vi(st, kf_id, cam)
        if "ev" in state:
            state["ev"]["vi_refine"] = out is not st
        return out

    cl._correct, cl._global_ba, cl._vi_refine = correct_, gba_, vi_
    mo.fuse_across_seam = fuse_
    return log, events, (lambda: setattr(mo, "fuse_across_seam", fuse))


def draw_recorder():
    """Record every verification's RANSAC masks and draws, by wrapping the
    JAX closer's _verify_program: the masks are recomputed with the
    program's own matching (integer and boolean, exact) and the draws with
    its keys. Returns (records, restore)."""
    import jax
    import jax.numpy as jnp

    import orbslam3_tpu.loop.closer as jcl

    program = jcl._verify_program
    records = []

    @jax.jit
    def masks(st, kf_id, cands, hamming_max):
        M = st.mp_pos.shape[0]
        mp_a = st.kf_mp[kf_id]
        a_mp_valid = st.mp_valid[jnp.clip(mp_a, 0, M - 1)]

        def one(cand):
            best_b, best_val, ok = jcl._match_kf_pair(
                st.kf_desc[kf_id], st.kf_feat_valid[kf_id], mp_a, st.kf_desc[cand],
                st.kf_feat_valid[cand], st.kf_mp[cand])
            mp_b = st.kf_mp[cand][best_b]
            return (ok & (best_val <= hamming_max) & a_mp_valid
                    & st.mp_valid[jnp.clip(mp_b, 0, M - 1)])

        return jax.vmap(one)(cands)

    def recorded(st, kf_id, cands, cam, hamming_max, chi2, radius):
        ok = np.asarray(masks(st, kf_id, cands, hamming_max))
        keys = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(7), kf_id), ok.shape[0])
        draws = np.stack([np.asarray(jax.random.categorical(k, jnp.where(o, 0.0, -1e9),
                                                            shape=(256, 3)))
                          for k, o in zip(keys, ok)]).astype(np.int32)
        records.append(dict(kf_id=int(kf_id), cands=np.asarray(cands, np.int32), ok=ok,
                            draws=draws))
        return program(st, kf_id, cands, cam, hamming_max, chi2, radius)

    jcl._verify_program = recorded
    return records, (lambda: setattr(jcl, "_verify_program", program))


def save_draws(records, name):
    """The recorded verifications as one npz: kf_id (V,), cands (V, C),
    ok (V, C, N), draws (V, C, 256, 3)."""
    path = os.path.join(DATA, f"{name}_draws.npz")
    np.savez_compressed(path, kf_id=np.asarray([r["kf_id"] for r in records], np.int32),
                        **{k: np.stack([r[k] for r in records]) for k in ("cands", "ok", "draws")})
    return os.path.relpath(path, ROOT), os.path.getsize(path)


def run(world, times, frames, imu, cfg, vocab, loop_over=None, chunk=8, service_every=8,
        warmup=True):
    import jax

    from orbslam3_tpu.eval.metrics import ate_rmse
    from orbslam3_tpu.models.fused import MODE_OK, FusedSlam

    slam = FusedSlam(world.cam, cfg, vocabulary=vocab, service_every=service_every, chunk=chunk,
                     warmup=warmup and vocab is not None)
    log, events, restore = [], [], (lambda: None)
    if vocab is not None:
        if loop_over:
            slam.loop_closer.cfg = slam.loop_closer.cfg._replace(**loop_over)
        log, events, restore = instrument(slam)
    t0 = time.perf_counter()
    init_frame = None
    relocs = []
    for i, t in enumerate(times):
        g, a, d = imu[i]
        n_before = slam.loop_closer.stats.relocalized if vocab is not None else 0
        slam.process_frame(frames[i][0], frames[i][1], g, a, d, float(t))
        if vocab is not None and slam.loop_closer.stats.relocalized > n_before:
            relocs.append(i)
        if init_frame is None and slam.imu_initialized:
            init_frame = i
    slam.finalize()
    jax.block_until_ready(slam.ts.q)
    wall = time.perf_counter() - t0
    restore()
    gt_p, _ = world.gt_trajectory()
    _, ps, _ = slam.trajectory_arrays(corrected=True)
    _, ps_raw, _ = slam.trajectory_arrays(corrected=False)
    n = len(ps)
    for ev in events:
        ev["reloc"] = ev["frame"] in relocs
    kv = np.asarray(slam.map.kf_valid)
    rec = {"ok_frac": float((slam.modes() == MODE_OK).mean()),
           "ate_m": float(ate_rmse(ps, gt_p[:n])),
           "ate_raw_m": float(ate_rmse(ps_raw, gt_p[:n])),
           "n_kf": int(slam.map.n_kf), "n_kf_valid": int(kv.sum()),
           "n_mp": int(slam.map.n_mp), "next_map_id": int(slam.map.next_map_id),
           "maps": sorted(set(np.asarray(slam.map.kf_map_id)[kv].tolist())),
           "compactions": int(slam.compactions),
           "imu_initialized": bool(slam.imu_initialized), "imu_init_frame": init_frame,
           "cpu_wall_s": round(wall, 1)}
    if vocab is not None:
        rec.update(stats=slam.loop_closer.stats._asdict(), corrections=events,
                   services=[list(e) for e in log])
    return rec, ps, slam


def bench_runs():
    from bench import HARD_WORLD, train_world_vocab
    from orbslam3_tpu.io.synthetic import SyntheticConfig, SyntheticWorld
    from orbslam3_tpu.models.slam import SlamConfig

    cfg = SlamConfig(use_imu=True, kf_max_frames=6, ba_iters=3, ba_window=6, lost_timeout=5.0)
    # bench.py::build_world(8.0)
    world = SyntheticWorld(SyntheticConfig(duration=8.0, n_landmarks=1500, **HARD_WORLD))
    times = world.frame_times()
    frames, imu = render(world, times), imu_windows(world, times)
    voc = train_world_vocab(world, frames)
    path, size = save_vocab(voc, "bench")
    rec, _, _ = run(world, times, frames, imu, cfg, voc)
    return {"world": "bench.py::build_world(8.0)", "vocabulary": path, "vocabulary_bytes": size,
            "config": "BENCH_CFG, chunk=8, service_every=8, warmup=True", "n_frames": len(times),
            **rec}


def revisit_runs():
    import bench
    from orbslam3_tpu.models.slam import SlamConfig

    cfg = SlamConfig(use_imu=True, kf_max_frames=6, ba_iters=3, ba_window=6, lost_timeout=5.0)
    from orbslam3_tpu.io.synthetic import SyntheticWorld

    # bench.py::build_revisit_world(), its frames rendered in spawned workers
    render_sequence = SyntheticWorld.render_sequence
    SyntheticWorld.render_sequence = (lambda self, times, blackout=None, workers=0:
                                      render(self, times, blackout))
    try:
        world, times, frames, imu = bench.build_revisit_world()
    finally:
        SyntheticWorld.render_sequence = render_sequence
    voc = bench.train_world_vocab(world, frames)
    path, size = save_vocab(voc, "revisit")
    rec, _, _ = run(world, times, frames, imu, cfg, voc)
    odo, _, _ = run(world, times, frames, imu, cfg, None)
    return {"world": "bench.py::build_revisit_world()", "vocabulary": path,
            "vocabulary_bytes": size, "blackout_s": [10.0, 13.0],
            "config": "BENCH_CFG, chunk=8, service_every=8, warmup=True", "n_frames": len(times),
            **rec, "odometry": odo}


SMALL = dict(width=384, height=256, fx=240.0, fy=240.0, n_landmarks=600, duration=8.0,
             cam_hz=10.0, pos_amp=(1.0, 0.7, 0.25))


def small_cfg(**kw):
    from orbslam3_tpu.frontend.orb import OrbConfig
    from orbslam3_tpu.map.slam_map import MapCapacity
    from orbslam3_tpu.models.slam import SlamConfig
    from orbslam3_tpu.models.tracker import TrackConfig

    return SlamConfig(orb=OrbConfig(n_features=384, n_levels=4),
                      cap=MapCapacity(max_kf=96, n_feat=384, max_mp=8192, max_obs=8),
                      track=TrackConfig(p_local=2048), ba_points=1024, use_imu=False,
                      kf_max_frames=2, min_kfs_keep_map=5, **kw)


def blackout_frames(world, times, blackout):
    blank = np.full((world.cfg.height, world.cfg.width), 127.0, np.float32)
    frames = []
    for t in times:
        frames.append((blank, blank) if blackout[0] <= t < blackout[1] else world.render_frame(t))
    imu = [(np.zeros((0, 3)), np.zeros((0, 3)), np.zeros(0))] * len(times)
    return frames, imu


def reloc_runs():
    from orbslam3_tpu.io.synthetic import SyntheticConfig, SyntheticWorld

    world = SyntheticWorld(SyntheticConfig(**SMALL, pos_freq=(0.22, 0.3, 0.35), yaw_amp=0.8,
                                           yaw_freq=0.22))
    times = world.frame_times()
    frames, imu = blackout_frames(world, times, (2.5, 4.5))
    voc = small_world_vocab(world)
    path, size = save_vocab(voc, "reloc")
    cfg = small_cfg(lost_timeout=30.0, insert_kfs_lost_visual=True)
    draws, restore = draw_recorder()
    try:
        rec, ps, slam = run(world, times, frames, imu, cfg, voc, chunk=1, service_every=2,
                            warmup=False,
                            loop_over=dict(recent_gap=3, covis_edge_weight_min=10,
                                           bow_min_score_gate=False))
    finally:
        restore()
    dpath, dsize = save_draws(draws, "reloc")
    return {"world": "tests/test_fused_loop.py::test_blackout_relocalizes_same_map",
            "vocabulary": path, "vocabulary_bytes": size, "draws": dpath, "draws_bytes": dsize,
            "n_frames": len(times), **rec, "modes": slam.modes().tolist(),
            "p": np.round(ps.astype(np.float64), 6).tolist()}


def merge_vocab():
    from orbslam3_tpu.io.synthetic import SyntheticConfig, SyntheticWorld

    world = SyntheticWorld(SyntheticConfig(**SMALL, yaw_amp=0.5))
    path, size = save_vocab(small_world_vocab(world), "merge")
    return {"vocabulary": path, "vocabulary_bytes": size}


def main():
    import jax

    names = sys.argv[1:] or ["bench", "revisit", "reloc"]
    rec = {}
    if os.path.exists(OUT) and sys.argv[1:]:
        with open(OUT) as f:
            rec = json.load(f)
    rec.update(backend=jax.default_backend(),
               note="accuracy reference only; the CPU wall time is not a speed figure")
    makers = {"bench": bench_runs, "revisit": revisit_runs, "reloc": reloc_runs}
    for name in names:
        t0 = time.perf_counter()
        rec[name] = makers[name]()
        print(f"{name}: {time.perf_counter() - t0:.0f} s", file=sys.stderr, flush=True)
        if name == "reloc":
            rec["merge"] = merge_vocab()
        os.makedirs(DATA, exist_ok=True)
        with open(OUT, "w") as f:
            json.dump(rec, f, indent=1)
    print(json.dumps({k: v for k, v in rec.items() if k != "reloc"})[:4000])


if __name__ == "__main__":
    main()
