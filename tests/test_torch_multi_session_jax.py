"""The port's multi-session fleet against the JAX package's MultiSessionSlam
on 3 devices of the 8-device CPU mesh (tests/conftest.py), on the same
frames: tests/test_multi_session.py's configuration, scenes 0, 1 and 0
again, the first 12 frames a session, session 2 ending 3 frames early,
chunk 4. The flushes carry the same valid slots and times, and every
session the same modes and keyframe count exactly and a trajectory within
5 mm (the slice test's tolerance: the front ends differ in single BRIEF
bits). `interop.carry_multi_session` turns the JAX fleet's stacked state
into the port's per-session pairs, leaf for leaf, and the port's fleet goes
on from it."""
import numpy as np
import pytest

from orbslam3_tpu_torch.parallel.multi_session import MultiSessionSlam
from test_torch_multi_session import CHUNK, SCENES, feed, slam_cfg, stream

N_FRAMES = 12


@pytest.fixture(scope="module")
def fleets():
    from orbslam3_tpu.parallel import multi_session as jms
    from test_multi_session import _slam_cfg, _world

    ws, times, frames, short = stream(N_FRAMES)
    t = MultiSessionSlam(ws[0].cam, slam_cfg(), n_sessions=len(SCENES), chunk=CHUNK,
                         devices=["cpu"] * len(SCENES))
    feed(t.process_frame, ws, times, frames, short)
    t.finalize()
    jws = [_world(s) for s in SCENES]
    j = jms.MultiSessionSlam(jws[0].cam, _slam_cfg(), n_sessions=len(SCENES), chunk=CHUNK)
    feed(j.process_frame, jws, times, frames, short)
    j.finalize()
    return t, j, short


def test_flushes_carry_the_same_slots(fleets):
    t, j, _ = fleets
    assert len(t.outs) == len(j.outs)
    for (tt, _, tv), (jt, _, jv) in zip(t.outs, j.outs):
        np.testing.assert_array_equal(tv, jv)
        np.testing.assert_array_equal(tt, np.asarray(jt))


@pytest.mark.parametrize("session", range(len(SCENES)))
def test_session_against_jax(fleets, session):
    import jax

    t, j, short = fleets
    tt, tp, tq = t.trajectory_arrays(session)
    jt, jp, jq = j.trajectory_arrays(session)
    assert len(tp) == len(jp) == (short if session == 2 else N_FRAMES)
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_allclose(tp, jp, rtol=0, atol=5e-3)
    modes_j = np.concatenate([np.asarray(jax.device_get(outs.mode))[session][v[session]]
                              for _, outs, v in j.outs])
    np.testing.assert_array_equal(t.frame_outputs(session).mode, modes_j)
    tst, _ = t.session_state(session)
    jst, _ = j.session_state(session)
    assert int(tst.n_kf) == int(jst.n_kf) >= 2


def test_carry_multi_session(fleets):
    import jax

    from orbslam3_tpu_torch.interop import carry_multi_session
    from torch_parity import assert_tree_close

    t, j, _ = fleets
    state = jax.tree.map(np.asarray, (j.maps, j.tss))
    pairs = carry_multi_session(state, t.devices)
    assert len(pairs) == len(SCENES)
    for s, (st, ts) in enumerate(pairs):
        jst, jts = jax.tree.map(np.asarray, j.session_state(s))
        assert_tree_close(st, jst, rtol=0, atol=0)
        assert_tree_close(ts, jts, rtol=0, atol=0)
        assert type(st) is type(t.maps[s]) and type(ts) is type(t.tss[s])
        assert st.kf_q.device == t.devices[s]
    # a port fleet resumes from the carried state: one more frame a session
    ms = MultiSessionSlam(t.cams[0], slam_cfg(), n_sessions=len(SCENES), chunk=CHUNK,
                          devices=t.devices)
    ms.maps, ms.tss = [p[0] for p in pairs], [p[1] for p in pairs]
    ws, times, frames, _ = stream(N_FRAMES + 1)
    for s in range(len(SCENES)):
        left, right = frames[SCENES[s]][N_FRAMES]
        ms.process_frame(s, left, right, *ws[s].imu_window(times[-2], times[-1]),
                         float(times[-1]))
    ms.finalize()
    assert all(int(ms.frame_outputs(s).mode[0]) == 1 for s in range(len(SCENES)))
