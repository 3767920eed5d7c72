"""The port's multi-session fleet (parallel/multi_session.py) on the CPU.

(a) JAX's fleet test configuration (tests/test_multi_session.py's world and
SLAM configuration, use_imu=False) with D = 3 sessions on the CPU: scenes
0, 1 and 0 again, session 2 ending 3 frames early, chunk 4. Session 0 equals
a lone port FusedSlam(chunk=4, service_every=10**9) on the same frames bit
for bit (every FrameOut field and the map); sessions 0 and 2 are equal over
their common frames although their chunks split differently; sessions 0
and 1 differ; the short session's trajectory has its true length; the
ragged flushes leave placeholder outputs in the JAX package's form.
(c) merge_session_maps on the JAX test's two-session construction: with the
JAX vocabulary carried across and JAX's Sim3 draws fed through the closer's
sampler, JAX's correction count, merged map ids exact and keyframe poses
within 1e-4; with the port's own draws, the JAX test's bars.
(The fleet against the JAX package's fleet is test_torch_multi_session_jax.py.)
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam3_tpu_torch.frontend.orb import OrbConfig
from orbslam3_tpu_torch.interop import from_numpy_tree
from orbslam3_tpu_torch.io.synthetic import SyntheticConfig, SyntheticWorld
from orbslam3_tpu_torch.map.slam_map import MapCapacity
from orbslam3_tpu_torch.models.fused import FrameOut, FusedSlam
from orbslam3_tpu_torch.models.slam import SlamConfig
from orbslam3_tpu_torch.models.tracker import TrackConfig
from orbslam3_tpu_torch.parallel.multi_session import MultiSessionSlam, merge_session_maps
import torch_parity  # noqa: F401  (one intra-op thread)

SCENES = (11, 12, 11)  # session -> world seed: scene 0, scene 1, scene 0 again
CHUNK = 4


def world(seed: int):
    """tests/test_multi_session.py::_world"""
    return SyntheticWorld(SyntheticConfig(width=384, height=256, fx=240.0, fy=240.0,
                                          n_landmarks=500, duration=2.4, cam_hz=10.0, seed=seed,
                                          pos_amp=(1.0, 0.7, 0.3)))


def slam_cfg():
    """tests/test_multi_session.py::_slam_cfg"""
    return SlamConfig(orb=OrbConfig(n_features=256, n_levels=4),
                      cap=MapCapacity(max_kf=16, n_feat=256, max_mp=2048, max_obs=8),
                      track=TrackConfig(p_local=1024), ba_points=512, use_imu=False,
                      kf_max_frames=3)


def stream(n_frames=None):
    """(worlds, times, frames by seed, the last frame + 1 of the short session 2)"""
    ws = [world(s) for s in SCENES]
    times = ws[0].frame_times()[:n_frames]
    frames = {s: [world(s).render_frame(t) for t in times] for s in set(SCENES)}
    return ws, times, frames, len(times) - 3


def feed(ms_process, ws, times, frames, short):
    """Interleave the sessions' frames as the JAX test does (frame i of every
    session, then frame i + 1); session 2 stops at `short`."""
    for i, t in enumerate(times):
        for s in range(len(SCENES)):
            if s == 2 and i >= short:
                continue
            left, right = frames[SCENES[s]][i]
            t_next = times[i + 1] if i + 1 < len(times) else t + 0.1
            g, a, d = ws[s].imu_window(t, t_next)
            ms_process(s, left, right, g, a, d, float(t))


@pytest.fixture(scope="module")
def fleet():
    ws, times, frames, short = stream()
    ms = MultiSessionSlam(ws[0].cam, slam_cfg(), n_sessions=len(SCENES), chunk=CHUNK,
                          devices=["cpu"] * len(SCENES))
    feed(ms.process_frame, ws, times, frames, short)
    ms.finalize()
    single = FusedSlam(ws[0].cam, slam_cfg(), chunk=CHUNK, service_every=10**9, device="cpu")
    for i, t in enumerate(times):
        left, right = frames[SCENES[0]][i]
        t_next = times[i + 1] if i + 1 < len(times) else t + 0.1
        single.process_frame(left, right, *ws[0].imu_window(t, t_next), float(t))
    single.flush()
    return ms, single, times, short


def test_session_equals_a_lone_fused_slam(fleet):
    ms, single, times, _ = fleet
    fo, so = ms.frame_outputs(0), single.frame_outputs()
    assert len(fo.q) == len(times)
    for f in FrameOut._fields:
        np.testing.assert_array_equal(getattr(fo, f), getattr(so, f), err_msg=f)
    t0, p0, q0 = ms.trajectory_arrays(0)
    ts1, p1, q1 = single.trajectory_arrays(corrected=False)
    np.testing.assert_array_equal(t0, np.asarray(ts1, np.float32))
    np.testing.assert_array_equal(p0, p1)
    np.testing.assert_array_equal(q0, q1)
    st0, ts0 = ms.session_state(0)
    for a, b in zip(st0, single.map):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b)
    for a, b in zip(ts0, single.ts):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b)
    # no host services ran in the lone system either
    assert single.compactions == 0 and single.loop_closer is None


def test_sessions_are_independent(fleet):
    ms, _, times, short = fleet
    _, p0, q0 = ms.trajectory_arrays(0)
    _, p1, _ = ms.trajectory_arrays(1)
    t2, p2, q2 = ms.trajectory_arrays(2)
    assert len(p2) == short and len(t2) == short  # the short session's true length
    np.testing.assert_array_equal(p0[:short], p2)  # same scene, other chunk splits
    np.testing.assert_array_equal(q0[:short], q2)
    assert np.abs(p0 - p1).max() > 1e-3  # other scene
    for s in range(len(SCENES)):
        st, ts = ms.session_state(s)
        assert int(st.n_kf) >= 2 and not bool(ts.imu_ok), s
    st0, _ = ms.session_state(0)
    assert int(st0.n_mp) > 100
    assert (ms.frame_outputs(1).mode == 1).all()


def test_ragged_flushes_follow_the_jax_rules(fleet):
    """c = min(chunk, longest pending); each session takes up to c frames,
    valid[s, :len(take)]; valid=False slots hold the placeholder output and
    a session is stepped (one front end, one FAST/NMS launch) only in the
    flushes where it has frames."""
    ms, _, times, short = fleet
    widths = [v.shape[1] for _, _, v in ms.outs]
    assert all(1 <= c <= CHUNK for c in widths)
    assert int(sum(v.sum() for _, _, v in ms.outs)) == 2 * len(times) + short
    ragged = 0
    for t_arr, outs, valid in ms.outs:
        for s in range(len(SCENES)):
            n = int(valid[s].sum())
            assert valid[s, :n].all() and not valid[s, n:].any()
            o = outs[s]
            assert o.q.shape[0] == valid.shape[1]
            if n < valid.shape[1]:
                ragged += 1
                pad = ~valid[s]
                assert (o.kf_id[pad] == -1).all() and (o.n_matches[pad] == 0).all()
                assert (o.ref_kf[pad] == -1).all() and not o.is_kf[pad].any()
                assert (o.rel_q[pad] == torch.tensor([1.0, 0.0, 0.0, 0.0])).all()
                assert (t_arr[s][pad] == 0).all()
                last = n - 1 if n else None
                if last is not None:  # the pose does not advance on padding
                    assert torch.equal(o.p[pad], o.p[last].expand_as(o.p[pad]))
    assert ragged >= 1
    assert ms.launches == [sum(bool(v[s].any()) for _, _, v in ms.outs)
                           for s in range(len(SCENES))]
    assert ms.host_syncs == 2 * len(times) + short  # one flag read a tracked frame


# ---------------------------------------------------------------- (c) merge

def _merge_states():
    """tests/test_multi_session.py::test_merge_session_maps_welds_overlap's
    two sessions of one wall from world origins 0.5 m apart (JAX, numpy)."""
    from orbslam3_tpu.frontend.camera import Camera
    from orbslam3_tpu.geometry import quat
    from orbslam3_tpu.imu.preintegration import PreintState
    from orbslam3_tpu.loop import vocab as vb
    from orbslam3_tpu.map.slam_map import MapCapacity as JCap
    from orbslam3_tpu.map.slam_map import empty_map, insert_keyframe

    rng = np.random.default_rng(5)
    cam = Camera.create(240.0, 240.0, 192.0, 128.0, 0.11, 384, 256)
    cap = JCap(max_kf=16, n_feat=128, max_mp=2048, max_obs=8)
    L = 96
    lm = np.stack([rng.uniform(-3, 3, L), rng.uniform(-2, 2, L), np.full(L, 6.0)],
                  -1).astype(np.float32)
    lm_desc = rng.integers(0, 256, (L, 32)).astype(np.uint8)

    def make_kf(p_est, matched_ids, p_render):
        xc = lm - p_render
        z = xc[:, 2]
        uv = np.stack([240 * xc[:, 0] / z + 192, 240 * xc[:, 1] / z + 128], -1)
        n = cap.n_feat
        mm_ = np.full(n, -1, np.int32)
        if matched_ids is not None:
            mm_[:L] = matched_ids
        return dict(
            time=jnp.float32(0.0), q_wb=quat.identity(), p_w=jnp.asarray(p_est),
            vel=jnp.zeros(3), bias_g=jnp.zeros(3), bias_a=jnp.zeros(3),
            uv=jnp.zeros((n, 2)).at[:L].set(jnp.asarray(uv.astype(np.float32))),
            u_right=jnp.full((n,), -1.0),
            depth=jnp.full((n,), -1.0).at[:L].set(jnp.asarray(z)),
            octave=jnp.zeros((n,), jnp.int32),
            desc=jnp.zeros((n, 32), jnp.uint8).at[:L].set(jnp.asarray(lm_desc)),
            points_body=jnp.zeros((n, 3)).at[:L].set(jnp.asarray(xc)),
            feat_valid=jnp.zeros((n,), bool).at[:L].set(True),
            matched_mp=jnp.asarray(mm_), preint=PreintState.identity())

    def build_session(origin_err, n_kf):
        st = empty_map(cap)
        poses = [np.array([x, 0, 0], np.float32) for x in np.linspace(-1, 1, n_kf)]
        st, _ = insert_keyframe(st, **make_kf(poses[0] + origin_err, None, poses[0]),
                                prev_kf=jnp.int32(-1), new_mp_budget=128)
        ids = np.arange(L, dtype=np.int32)
        for k, p in enumerate(poses[1:]):
            st, _ = insert_keyframe(st, **make_kf(p + origin_err, ids, p),
                                    prev_kf=jnp.int32(k), new_mp_budget=0)
        return st, poses

    offset = np.array([0.5, 0.0, 0.3], np.float32)
    st_a, _ = build_session(np.zeros(3, np.float32), 5)
    st_b, poses_b = build_session(offset, 4)
    corpus = np.concatenate([lm_desc, rng.integers(0, 256, (2000, 32)).astype(np.uint8)])
    voc = vb.train_vocabulary(corpus, k=6, levels=3)
    return st_a, st_b, poses_b, voc, cam


LOOP_KW = dict(bow_min_score_gate=False, recent_gap=2, consistency_needed=2,
               covis_edge_weight_min=10, run_global_ba=False)


@pytest.fixture(scope="module")
def merged_jax():
    from orbslam3_tpu.loop.closer import LoopConfig
    from orbslam3_tpu.parallel.multi_session import merge_session_maps as jmerge

    st_a, st_b, poses_b, voc, cam = _merge_states()
    merged, closer = jmerge([st_a, st_b], voc, cam, LoopConfig(**LOOP_KW))
    return (st_a, st_b, poses_b, voc, cam), jax.tree.map(np.asarray, merged), closer


def _port_merge(inputs, sampler):
    from orbslam3_tpu_torch.loop.closer import LoopConfig
    from torch_parity import port_camera

    st_a, st_b, _, voc, cam = inputs
    tvoc = from_numpy_tree(jax.tree.map(np.asarray, voc))
    return merge_session_maps([from_numpy_tree(jax.tree.map(np.asarray, s)) for s in (st_a, st_b)],
                              tvoc, port_camera(cam), LoopConfig(**LOOP_KW), sampler=sampler)


def test_merge_with_fed_draws_matches_jax(merged_jax):
    from test_torch_loop_closer import jax_draws

    inputs, jst, jcloser = merged_jax
    st, closer = _port_merge(inputs, jax_draws)
    assert tuple(closer.stats) == tuple(int(x) for x in jcloser.stats)
    assert closer.stats.corrected >= 1
    np.testing.assert_array_equal(st.kf_map_id.numpy(), jst.kf_map_id)
    np.testing.assert_array_equal(st.kf_valid.numpy(), jst.kf_valid)
    np.testing.assert_array_equal(st.mp_map_id.numpy(), jst.mp_map_id)
    np.testing.assert_allclose(st.kf_p.numpy(), jst.kf_p, rtol=0, atol=1e-4)
    np.testing.assert_allclose(st.kf_q.numpy(), jst.kf_q, rtol=0, atol=1e-4)


def test_merge_with_own_draws_welds_the_sessions(merged_jax):
    inputs, _, _ = merged_jax
    poses_b = inputs[2]
    st, closer = _port_merge(inputs, None)
    assert closer.stats.corrected >= 1, closer.stats
    maps = st.kf_map_id.numpy()[st.kf_valid.numpy()]
    assert len(set(maps.tolist())) == 1, set(maps.tolist())
    for kid, p_true in zip(range(5, 9), poses_b):
        err = np.linalg.norm(st.kf_p[kid].numpy() - p_true)
        assert err < 0.1, (kid, err)
