"""Checkpoint, resume and export of the port against the JAX package: the
npz round trip (every leaf with its dtype and shape, 0-d counters 0-d), a
file saved by either package loaded by the other (leaf by leaf, exact), the
device rule of load_map and FusedSlam.from_state, a resumed run against the
uninterrupted one (the case of tests/test_persistence.py, exact: the file
holds the state bit for bit), and TUM / PLY exports byte-equal to the JAX
package's."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam3_tpu.map import checkpoint as jck
from orbslam3_tpu.map import slam_map as jsm
from orbslam3_tpu.models import fused as jfused
from orbslam3_tpu.viz import export as jex
from orbslam3_tpu_torch.frontend.orb import OrbConfig
from orbslam3_tpu_torch.interop import from_numpy_tree
from orbslam3_tpu_torch.io.synthetic import SyntheticConfig, SyntheticWorld
from orbslam3_tpu_torch.map import checkpoint as tck
from orbslam3_tpu_torch.map import slam_map as tsm
from orbslam3_tpu_torch.models import fused as tfused
from orbslam3_tpu_torch.models.slam import SlamConfig
from orbslam3_tpu_torch.models.tracker import TrackConfig
from orbslam3_tpu_torch.viz import export as tex
from tests.test_compaction import _build_map
from torch_parity import assert_tree_close


def np_state(st):
    return jax.tree.map(np.asarray, st)


@pytest.fixture(scope="module")
def states():
    """A JAX map of 4 keyframes and a tracker state away from its initial
    values, and the same two in the port."""
    j_map = _build_map(4)
    j_ts = jfused.TrackState.initial()._replace(
        p=jnp.asarray([0.3, -1.0, 2.0]), mode=jnp.int32(1), last_kf=jnp.int32(3),
        imu_ok=jnp.asarray(True), last_t=jnp.float32(1.5))
    return j_map, j_ts, from_numpy_tree(np_state(j_map)), from_numpy_tree(np_state(j_ts))


def test_round_trip_keeps_every_leaf(tmp_path, states):
    _, _, t_map, t_ts = states
    path = str(tmp_path / "map.npz")
    tck.save_map(path, t_map, t_ts)
    m2, ts2 = tck.load_map(path, with_track_state=True, device="cpu")
    assert type(m2) is tsm.MapState and type(ts2) is tfused.TrackState
    assert_tree_close(m2, np_state(t_map), rtol=0, atol=0)
    assert_tree_close(ts2, np_state(t_ts), rtol=0, atol=0)
    assert m2.n_kf.dim() == 0 and m2.n_kf.dtype == torch.int32 and int(m2.n_kf) == 4
    assert m2.kf_desc.dtype == torch.uint8 and m2.kf_valid.dtype == torch.bool
    assert ts2.imu_ok.dtype == torch.bool and ts2.imu_ok.dim() == 0 and bool(ts2.imu_ok)
    only_map = tck.load_map(path, device=torch.device("cpu"))
    assert type(only_map) is tsm.MapState
    tck.save_map(path, t_map)  # without a tracker state
    with pytest.raises(KeyError):
        tck.load_map(path, with_track_state=True, device="cpu")


def test_file_layout_is_the_jax_packages(tmp_path, states):
    j_map, j_ts, t_map, t_ts = states
    jck.save_map(str(tmp_path / "j.npz"), j_map, j_ts)
    tck.save_map(str(tmp_path / "t.npz"), t_map, t_ts)
    with np.load(tmp_path / "j.npz") as a, np.load(tmp_path / "t.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        assert "map.kf_preint.cov" in a.files and "ts.kf_preint.dq" in a.files
        for k in a.files:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_jax_checkpoint_loads_in_the_port(tmp_path, states):
    j_map, j_ts, _, _ = states
    path = str(tmp_path / "j.npz")
    jck.save_map(path, j_map, j_ts)
    m, ts = tck.load_map(path, with_track_state=True, device="cpu")
    assert_tree_close(m, np_state(j_map), rtol=0, atol=0)
    assert_tree_close(ts, np_state(j_ts), rtol=0, atol=0)


def test_port_checkpoint_loads_in_the_jax_package(tmp_path, states):
    j_map, j_ts, t_map, t_ts = states
    path = str(tmp_path / "t.npz")
    tck.save_map(path, t_map, t_ts)
    m, ts = jck.load_map(path, with_track_state=True)
    assert type(m) is jsm.MapState and type(ts) is jfused.TrackState
    for got, want in ((m, j_map), (ts, j_ts)):
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_default_device_is_cuda_and_raises_without_one(tmp_path, states, monkeypatch):
    _, _, t_map, t_ts = states
    path = str(tmp_path / "map.npz")
    tck.save_map(path, t_map, t_ts)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        tck.load_map(path)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tck.load_map(path, with_track_state=True, device=None)
    world = SyntheticWorld(SyntheticConfig(width=256, height=160, fx=160.0, fy=160.0))
    with pytest.raises(RuntimeError, match="cuda"):
        tfused.FusedSlam.from_state(world.cam, tfused.SLICE_CFG, t_map, t_ts)


RESUME_CFG = SlamConfig(orb=OrbConfig(n_features=256, n_levels=4),
                        cap=tsm.MapCapacity(max_kf=16, n_feat=256, max_mp=2048, max_obs=8),
                        track=TrackConfig(p_local=1024), ba_points=512, use_imu=False,
                        kf_max_frames=3)


@pytest.fixture(scope="module")
def resumed(tmp_path_factory):
    """tests/test_persistence.py::test_resume_from_checkpoint in the port: a
    run saved at its middle, resumed in a new system, beside the original
    system fed the same second half."""
    world = SyntheticWorld(SyntheticConfig(width=384, height=256, fx=240.0, fy=240.0,
                                           n_landmarks=500, duration=3.0, cam_hz=10.0,
                                           pos_amp=(1.0, 0.7, 0.3)))
    times = world.frame_times()
    half = len(times) // 2

    def feed(slam, lo, hi):
        for i in range(lo, hi):
            left, right = world.render_frame(times[i])
            t_next = times[i + 1] if i + 1 < len(times) else times[i] + 0.1
            slam.process_frame(left, right, *world.imu_window(times[i], t_next), float(times[i]))
        slam.flush()

    slam = tfused.FusedSlam(world.cam, RESUME_CFG, service_every=10**9, device="cpu")
    feed(slam, 0, half)
    path = str(tmp_path_factory.mktemp("ckpt") / "ckpt.npz")
    tck.save_map(path, slam.map, slam.ts)
    kf_before = int(slam.map.n_kf)
    st, ts = tck.load_map(path, with_track_state=True, device="cpu")
    again = tfused.FusedSlam.from_state(world.cam, RESUME_CFG, st, ts, service_every=10**9,
                                        device="cpu")
    mirrors = dict(n_kf=again._n_kf, kf_ub=again._kf_ub, mp_ub=again._mp_ub, mode=again._mode,
                   last_t=again._last_t, syncs=again.host_syncs, imu=again.imu_initialized)
    feed(again, half, len(times))
    feed(slam, half, len(times))
    return dict(slam=slam, again=again, mirrors=mirrors, kf_before=kf_before, times=times,
                half=half, n_mp_at_save=int(st.n_mp))


def test_from_state_sets_the_host_mirrors(resumed):
    m, times, half = resumed["mirrors"], resumed["times"], resumed["half"]
    assert m["n_kf"] == m["kf_ub"] == resumed["kf_before"] >= 2
    assert m["mp_ub"] == resumed["n_mp_at_save"] and m["mode"] == tfused.MODE_OK
    # the last frame time is the newest keyframe's: it lags the last frame by < kf_max_frames
    assert times[0] < m["last_t"] <= float(times[half - 1])
    assert m["syncs"] == 1 and m["imu"] is False


def test_resumed_run_lands_on_the_uninterrupted_state(resumed):
    slam, again = resumed["slam"], resumed["again"]
    assert int(again.map.n_kf) == int(slam.map.n_kf) > resumed["kf_before"]
    assert torch.equal(again.ts.p, slam.ts.p) and torch.equal(again.ts.q, slam.ts.q)
    a, b = again.frame_outputs(), slam.frame_outputs()
    half = resumed["half"]
    np.testing.assert_array_equal(a.p, b.p[half:])
    np.testing.assert_array_equal(a.mode, b.mode[half:])
    _, ps, _ = again.trajectory_arrays()
    assert ps.shape == (len(resumed["times"]) - half, 3) and np.isfinite(ps).all()


def test_from_state_resumes_an_initialized_imu(states):
    _, _, t_map, t_ts = states
    world = SyntheticWorld(SyntheticConfig(width=256, height=160, fx=160.0, fy=160.0))
    cfg = tfused.BENCH_CFG._replace(cap=tsm.MapCapacity(max_kf=8, n_feat=32, max_mp=128,
                                                        max_obs=8))
    slam = tfused.FusedSlam.from_state(world.cam, cfg, t_map, t_ts, device="cpu", chunk=2)
    assert slam.imu_initialized and slam._imu_phase == 3 and slam.chunk == 2
    assert slam._imu_init_time == slam._last_t == pytest.approx(1.5)  # kf 3 at 0.5 * 3
    assert not slam._imu_refine_due() and slam._mode == 1
    assert slam.map.kf_q is not t_map.kf_q or slam.map.kf_q.device.type == "cpu"


def test_tum_and_ply_exports_are_byte_equal(tmp_path, states):
    j_map, _, t_map, _ = states
    r = np.random.default_rng(0)
    ts_, ps = np.arange(5.0) * 0.05, r.normal(size=(5, 3)).astype(np.float32)
    qs = r.normal(size=(5, 4)).astype(np.float32)
    jex.save_trajectory_tum(str(tmp_path / "j.txt"), ts_, ps, qs)
    tex.save_trajectory_tum(str(tmp_path / "t.txt"), ts_, torch.from_numpy(ps),
                            torch.from_numpy(qs))
    assert (tmp_path / "j.txt").read_bytes() == (tmp_path / "t.txt").read_bytes()
    assert len((tmp_path / "t.txt").read_text().splitlines()[0].split()) == 8
    jex.save_map_ply(str(tmp_path / "j.ply"), j_map)
    tex.save_map_ply(str(tmp_path / "t.ply"), t_map)
    assert (tmp_path / "j.ply").read_bytes() == (tmp_path / "t.ply").read_bytes()
    n = int(t_map.mp_valid.sum()) + 4
    assert f"element vertex {n}" in (tmp_path / "t.ply").read_text()
