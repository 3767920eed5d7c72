"""Torch port of FusedSlam with its loop closer against the JAX package.

* the blackout-then-merge world of tests/test_fused_loop.py (384x256, 8 s
  at 10 Hz, a camera blackout forces a second map, the cross-map loop path
  must fold it back), JAX FusedSlam and the port side by side on the same
  frames and vocabulary, the port fed the RANSAC draws JAX makes: the
  test's bars (a correction, every keyframe in map 0, post-merge ATE <
  0.15 m) for both, the same LoopStats (candidates that passed the count
  floor within 2: the front ends differ by single descriptor bits), the same
  service sequence (service
  round, keyframe serviced, packet acted on, verification consumed,
  correction) and the corrected trajectories within 2 cm;
* _retarget_tracker within 1e-6 + 1e-6 relative, with and without gravity;
* a run with a loop closer through compaction passes (8 keyframe rows):
  the closer's BoW rows, consistency state and serviced count follow the
  remaps.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam3_tpu.eval.metrics import ate_rmse
from orbslam3_tpu.frontend.orb import OrbConfig, detect_orb
from orbslam3_tpu.io.synthetic import SyntheticConfig, SyntheticWorld
from orbslam3_tpu.loop import vocab as jvb
from orbslam3_tpu.map.slam_map import MapCapacity
from orbslam3_tpu.models import fused as jfused
from orbslam3_tpu.models.slam import SlamConfig
from orbslam3_tpu.models.tracker import TrackConfig
from orbslam3_tpu_torch.frontend.orb import OrbConfig as TOrb
from orbslam3_tpu_torch.interop import from_numpy_tree
from orbslam3_tpu_torch.loop import vocab as tvb
from orbslam3_tpu_torch.loop.closer import LoopConfig as TLoopConfig
from orbslam3_tpu_torch.map.slam_map import MapCapacity as TCap
from orbslam3_tpu_torch.models import fused as tfused
from orbslam3_tpu_torch.models.slam import SlamConfig as TSlamConfig
from orbslam3_tpu_torch.models.tracker import TrackConfig as TTrack
from test_torch_loop_closer import jax_draws
from torch_parity import SMALL_WORLD, port_camera, record_loop_services, tensor

MERGE_WORLD = dict(width=384, height=256, fx=240.0, fy=240.0, n_landmarks=600, duration=8.0,
                   cam_hz=10.0, pos_amp=(1.0, 0.7, 0.25), yaw_amp=0.5)
BLACKOUT = (2.5, 3.3)
LOOP_OVER = dict(recent_gap=3, consistency_needed=2, covis_edge_weight_min=10,
                 bow_min_score_gate=False)


def world_vocab(world):
    """tests/test_fused_loop.py's vocabulary: k=8, 3 levels, from the left
    images at t = 0, 1, 2, 3 s."""
    corpus, doc = [], []
    for i, t in enumerate([0.0, 1.0, 2.0, 3.0]):
        left, _ = world.render_frame(t)
        f = detect_orb(jnp.asarray(left), OrbConfig(n_features=384, n_levels=4))
        d = np.asarray(f.desc)[np.asarray(f.valid)]
        corpus.append(d)
        doc.append(np.full(len(d), i))
    return jvb.train_vocabulary(np.concatenate(corpus), k=8, levels=3,
                                doc_ids=np.concatenate(doc))


def small_cfgs(**kw):
    """(JAX SlamConfig, port SlamConfig) of tests/test_fused_loop.py."""
    common = dict(ba_points=1024, use_imu=False, kf_max_frames=2, min_kfs_keep_map=5, **kw)
    j = SlamConfig(orb=OrbConfig(n_features=384, n_levels=4),
                   cap=MapCapacity(max_kf=96, n_feat=384, max_mp=8192, max_obs=8),
                   track=TrackConfig(p_local=2048), **common)
    t = TSlamConfig(orb=TOrb(n_features=384, n_levels=4),
                    cap=TCap(max_kf=96, n_feat=384, max_mp=8192, max_obs=8),
                    track=TTrack(p_local=2048), **common)
    return j, t


def blackout_run(slam, world, blackout):
    times = world.frame_times()
    blank = np.full((world.cfg.height, world.cfg.width), 127.0, np.float32)
    for t in times:
        left, right = (blank, blank) if blackout[0] <= t < blackout[1] else world.render_frame(t)
        slam.process_frame(left, right, np.zeros((0, 3)), np.zeros((0, 3)), np.zeros(0), float(t))
    slam.finalize()
    _, ps, _ = slam.trajectory_arrays()
    gt_p, _ = world.gt_trajectory()
    post = times > blackout[1] + 2.0
    kv = np.asarray(slam.map.kf_valid)
    return dict(ps=ps, ate_post=float(ate_rmse(ps[post], gt_p[post])),
                maps=set(np.asarray(slam.map.kf_map_id)[kv].tolist()), modes=slam.modes(),
                stats=tuple(slam.loop_closer.stats), times=times)


@pytest.fixture(scope="module")
def merge_runs():
    world = SyntheticWorld(SyntheticConfig(**MERGE_WORLD))
    voc = world_vocab(world)
    jcfg, tcfg = small_cfgs(lost_timeout=0.3)
    runs = {}
    j = jfused.FusedSlam(world.cam, jcfg, vocabulary=voc, service_every=2)
    t = tfused.FusedSlam(port_camera(world.cam), tcfg, device="cpu", service_every=2,
                         vocabulary=from_numpy_tree(jax.tree.map(np.asarray, voc)))
    t.loop_closer.sampler = jax_draws
    for name, slam in (("jax", j), ("torch", t)):
        slam.loop_closer.cfg = slam.loop_closer.cfg._replace(**LOOP_OVER)
        log = record_loop_services(slam, [])
        runs[name] = dict(blackout_run(slam, world, BLACKOUT), log=log, slam=slam)
    return runs


@pytest.mark.parametrize("name", ["jax", "torch"])
def test_merge_world_bars(merge_runs, name):
    r = merge_runs[name]
    assert r["stats"][3] >= 1, r["stats"]  # corrected
    assert r["maps"] == {0}, r["maps"]
    assert r["ate_post"] < 0.15, r["ate_post"]


def test_merge_world_matches_jax(merge_runs):
    j, t = merge_runs["jax"], merge_runs["torch"]
    # candidates that pass the match-count floor: the front ends differ by
    # single descriptor bits (PERF.md), which moves a count at the floor
    assert abs(t["stats"][0] - j["stats"][0]) <= 2 and t["stats"][1:] == j["stats"][1:]
    corrections = [e for e in t["log"] if e[0] == "correct"]
    assert corrections == [e for e in j["log"] if e[0] == "correct"] and corrections
    assert corrections[0][3]  # a cross-map merge
    np.testing.assert_array_equal(t["modes"], j["modes"])
    np.testing.assert_allclose(t["ps"], j["ps"], rtol=0, atol=2e-2)


def test_service_sequence_equals_jax(merge_runs):
    """The same service rounds act on the same keyframes, packets and
    verifications: the port mirrors the JAX host's one-round-old keyframe
    count, atlas size and tracker mode."""
    j, t = merge_runs["jax"], merge_runs["torch"]
    assert len(t["log"]) > 40
    assert t["log"] == j["log"]
    tslam, jslam = t["slam"], j["slam"]
    assert tslam._service_round == jslam._service_round
    assert tslam._multi_map == jslam._multi_map is True
    assert tslam._refine_request == jslam._refine_request


@pytest.mark.parametrize("rotate_gravity", [False, True])
def test_retarget_tracker(rotate_gravity):
    r = np.random.default_rng(2)

    def unit(v):
        return (v / np.linalg.norm(v)).astype(np.float32)

    jts = jfused.TrackState.initial()._replace(
        q=jnp.asarray(unit(r.normal(size=4))), p=jnp.asarray(r.normal(size=3), jnp.float32),
        v=jnp.asarray(r.normal(size=3), jnp.float32),
        gravity_w=jnp.asarray([0.1, -0.2, -9.8], jnp.float32))
    args = [unit(r.normal(size=4)), r.normal(size=3).astype(np.float32),
            unit(r.normal(size=4)), r.normal(size=3).astype(np.float32)]
    j = jfused._retarget_tracker(jts, *[jnp.asarray(a) for a in args],
                                 rotate_gravity=rotate_gravity)
    tts = from_numpy_tree(jax.tree.map(np.asarray, jts))
    t = tfused._retarget_tracker(tts, *[tensor(a) for a in args], rotate_gravity=rotate_gravity)
    for name in ("q", "p", "v", "gravity_w"):
        np.testing.assert_allclose(getattr(t, name).numpy(), np.asarray(getattr(j, name)),
                                   rtol=1e-6, atol=1e-6, err_msg=name)
    assert torch.equal(t.gravity_w, tts.gravity_w) != rotate_gravity


def test_loop_closer_through_compaction():
    world = SyntheticWorld(SyntheticConfig(**SMALL_WORLD))
    voc = from_numpy_tree(jax.tree.map(np.asarray, world_vocab(world)))
    cfg = tfused.SLICE_CFG._replace(orb=TOrb(n_features=384, n_levels=4), kf_max_frames=2,
                                    cap=TCap(max_kf=8, n_feat=384, max_mp=4096, max_obs=8),
                                    track=TTrack(p_local=1024), ba_points=1024)
    slam = tfused.FusedSlam(port_camera(world.cam), cfg, vocabulary=voc, service_every=2,
                            device="cpu", loop_cfg=TLoopConfig(recent_gap=3))
    remaps = []
    remap = slam.loop_closer.remap_rows
    slam.loop_closer.remap_rows = lambda km: remaps.append(np.asarray(km)) or remap(km)
    for t in world.frame_times():
        slam.process_frame(*world.render_frame(t), np.zeros((0, 3)), np.zeros((0, 3)),
                           np.zeros(0), float(t))
    slam.finalize()
    cl = slam.loop_closer
    assert slam.compactions >= 1 and len(remaps) == slam.compactions
    n_kf = int(slam.map.n_kf)
    assert slam._n_kf_seen == n_kf
    # every serviced live row holds its own keyframe's BoW after the remaps
    st = slam.map
    for k in range(n_kf):
        ids, w, _ = tvb.transform_sparse(cl.vocab, st.kf_desc[k], st.kf_feat_valid[k])
        assert torch.equal(cl.bow_ids[k], ids) and torch.equal(cl.bow_w[k], w), k
    assert (cl.bow_ids[n_kf:] == -1).all()
    assert cl.pending_kf is None
