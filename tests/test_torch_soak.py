"""scripts/soak_torch.py on a small world on the CPU, and the port's
JAX-free copy of bench.py::train_world_vocab.

The soak runs the production configuration (loop closer warmed up, chunk
8, a service round every 8 frames) on soak.py's world at 376x240 with a
map of 8 keyframe rows, so compaction fires within its 24 frames: its rows
and summary carry scripts/soak.py's keys, and its counters are the
FusedSlam's (the last service round, in finalize, may add to the last
row's). The
vocabulary trained on the JAX front end's corpus equals bench.py's exactly,
and the port's corpus takes the same images."""
import sys
from pathlib import Path

import numpy as np

import torch_parity  # noqa: F401  (one intra-op thread)

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "scripts"))

SMALL = dict(width=376, height=240, fx=229.0, fy=229.0, cam_hz=10.0, n_landmarks=800)
ROW_KEYS = {"t", "fps", "n_kf", "n_mp", "ok_frac", "compactions", "loops", "relocs", "kf_evict",
            "mp_evict", "maps", "outs_len", "rss_mb"}
SUMMARY_KEYS = {"metric", "duration_s", "frames", "fps_mean", "fps_first_window",
                "fps_last_window", "fps_min", "ate_m", "n_kf_final", "n_mp_final", "ok_frac",
                "compactions", "loop_corrections", "relocalizations", "kf_evictions",
                "mp_evictions", "maps_spawned", "candidates_checked", "outs_len_final",
                "trajectory_export_s", "rss_mb_final", "total_s", "backend"}


def test_soak_small():
    import soak_torch
    from orbslam3_tpu_torch.map.slam_map import MapCapacity
    from orbslam3_tpu_torch.models.slam import SlamConfig

    cfg = SlamConfig(use_imu=True, kf_max_frames=6, ba_iters=3, ba_window=6, lost_timeout=5.0,
                     cap=MapCapacity(max_kf=8, max_mp=4096))
    lines = []
    rows, summary, slam = soak_torch.soak(soak_torch.soak_world_config(2.4, **SMALL), cfg,
                                          window=0.8, device="cpu", log=lines.append)
    assert len(rows) == 3 and summary["frames"] == 24
    for r in rows:
        assert ROW_KEYS <= set(r)
    assert SUMMARY_KEYS <= set(summary)
    assert summary["backend"] == "cpu" and summary["compactions"] >= 1
    assert summary["compactions"] == slam.compactions >= rows[-1]["compactions"]
    assert summary["kf_evictions"] == slam.kf_evictions
    assert summary["mp_evictions"] == slam.mp_evictions
    assert summary["map_evictions"] == slam.map_evictions
    assert summary["loop_corrections"] == slam.loop_closer.stats.corrected
    assert summary["relocalizations"] == slam.loop_closer.stats.relocalized
    assert summary["candidates_checked"] == slam.loop_closer.stats.candidates_checked
    assert summary["n_kf_final"] == int(slam.map.n_kf) <= 8
    assert summary["outs_len_final"] == len(slam.outs) == 3
    assert np.isfinite(summary["ate_m"]) and summary["ok_frac"] > 0.5
    md = soak_torch.markdown(rows, summary)
    assert md.count("\n| ") == 1 + len(rows) and "soak_torch.py" in md


def test_train_world_vocab_on_the_jax_corpus():
    import soak_torch
    import jax.numpy as jnp

    from bench import train_world_vocab as jax_train
    from orbslam3_tpu.frontend.orb import OrbConfig, detect_orb
    from orbslam3_tpu_torch.io.synthetic import SyntheticWorld
    from orbslam3_tpu_torch.loop import vocab as tvb

    world = SyntheticWorld(soak_torch.soak_world_config(3.2, **SMALL))
    fr = [world.render_frame(t) for t in world.frame_times()]
    want = jax_train(world, fr)
    descs, doc = [], []
    for di, i in enumerate(range(0, len(fr), max(len(fr) // 16, 1))):
        f = detect_orb(jnp.asarray(fr[i][0].astype(np.float32)), OrbConfig())
        d = np.asarray(f.desc)[np.asarray(f.valid)]
        descs.append(d)
        doc.append(np.full(len(d), di))
    jcorpus, jdoc = np.concatenate(descs), np.concatenate(doc)
    got = tvb.train_vocabulary(jcorpus, k=10, levels=4, doc_ids=jdoc)
    assert (got.k, got.levels) == (want.k, want.levels) == (10, 4)
    for a, b in zip(got.level_desc, want.level_desc):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(got.idf.numpy(), np.asarray(want.idf))

    corpus, tdoc = tvb.world_vocab_corpus(fr, device="cpu")
    assert corpus.dtype == np.uint8 and corpus.shape[1] == 32
    np.testing.assert_array_equal(np.bincount(tdoc), np.bincount(jdoc))  # same images, counts
    same = (corpus == jcorpus).all(1).mean() if len(corpus) == len(jcorpus) else 0.0
    assert same > 0.95, same
