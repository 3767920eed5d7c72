"""Torch port of the keyframe branch's map maintenance against the JAX
package, every function started from one MapState built by a few JAX
keyframe inserts on the small world (keyframes chained by kf_prev, tracked
against the map so far): local_window_temporal, spawn_map_points,
triangulate_with_neighbor, fuse_map_points, fuse_across_seam,
update_point_stats, keyframe_redundancy, select_cull_candidate,
select_pressure_evict_kf and remove_keyframe. Integer and boolean fields
exact, float32 fields within 1e-5, except the positions (and the normal and
depth bounds derived from them) of points made by triangulation: 5e-3
relative + 5e-3 m. The closed-form DLT solves 3x3 normal equations of
nearly parallel rays in float32, so its rounding differences (another
summation order in the small matrix products) grow with a point's depth;
which features triangulate, and every id, still agree exactly."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from orbslam3_tpu.frontend.orb import OrbConfig as JOrb
from orbslam3_tpu.map import mapping_ops as jmo
from orbslam3_tpu.map import slam_map as jsm
from orbslam3_tpu.map import triangulation as jtri
from orbslam3_tpu.models import slam as jslam
from orbslam3_tpu_torch.interop import from_numpy_tree
from orbslam3_tpu_torch.map import mapping_ops as tmo
from orbslam3_tpu_torch.map import slam_map as tsm
from orbslam3_tpu_torch.map import triangulation as ttri
from torch_parity import assert_tree_close, grow_jax_map, port_camera, tensor

CAP = jsm.MapCapacity(max_kf=16, n_feat=384, max_mp=4096, max_obs=8)
CFG = jslam.SlamConfig(orb=JOrb(n_features=384, n_levels=4), cap=CAP, new_mp_budget=96)
N_KF = 8


@pytest.fixture(scope="module")
def grown():
    """8 keyframes; a small spawn budget leaves free features on both sides
    of every pair for triangulation."""
    world, st = grow_jax_map(N_KF, CAP, CFG)
    return world, st, port_camera(world.cam)


def _j(st_np):
    return jax.tree.map(jnp.asarray, st_np)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _k(i):
    return tensor(np.int32(i))


DLT_FIELDS = ("mp_pos", "mp_normal", "mp_min_dist", "mp_max_dist")


def _assert_close_after_dlt(tst, jst):
    """Whole state at 1e-5, the geometry of triangulated points at 5e-3."""
    hold = {f: getattr(jst, f) for f in DLT_FIELDS}
    assert_tree_close(tst._replace(**{f: tensor(v) for f, v in hold.items()}), jst)
    for f, v in hold.items():
        np.testing.assert_allclose(getattr(tst, f).numpy(), v, rtol=5e-3, atol=5e-3, err_msg=f)


@pytest.mark.parametrize("kf_id,window,n_temporal", [(7, 7, 2), (7, 4, 3), (1, 5, 2), (5, 3, 0),
                                                     (6, 20, 4)])
def test_local_window_temporal(grown, kf_id, window, n_temporal):
    _, st, _ = grown
    jids, jok = jsm.local_window_temporal(_j(st), jnp.int32(kf_id), window, n_temporal)
    tids, tok = tsm.local_window_temporal(from_numpy_tree(st), _k(kf_id), window, n_temporal)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    assert int(tok.sum()) >= 2


def test_local_window_temporal_cut_chain(grown):
    """A culled predecessor and a foreign-map predecessor drop out of the chain."""
    _, st, _ = grown
    valid = st.kf_valid.copy()
    valid[6] = False
    mid = st.kf_map_id.copy()
    mid[5] = 3
    st2 = st._replace(kf_valid=valid, kf_map_id=mid)
    jids, jok = jsm.local_window_temporal(_j(st2), jnp.int32(7), 7, 3)
    tids, tok = tsm.local_window_temporal(from_numpy_tree(st2), _k(7), 7, 3)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    assert not tok[1] and not tok[2] and tok[3]


def test_spawn_map_points(grown):
    _, st, _ = grown
    rng = np.random.default_rng(3)
    free = np.where(st.kf_feat_valid[7] & (st.kf_mp[7] < 0))[0][:40].astype(np.int32)
    assert len(free) == 40
    Xw = (st.kf_p[7][None] + rng.normal(0, 3.0, (40, 3))).astype(np.float32)
    ok = rng.random(40) < 0.7
    jst, jids = jsm.spawn_map_points(_j(st), jnp.int32(7), jnp.asarray(free), jnp.asarray(Xw),
                                     jnp.asarray(ok))
    tst, tids = tsm.spawn_map_points(from_numpy_tree(st), _k(7), tensor(free), tensor(Xw),
                                     tensor(ok))
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    assert int((tids >= 0).sum()) == int(ok.sum())
    assert_tree_close(tst, _np(jst))


@pytest.mark.parametrize("kf_id,kwargs", [(7, {}), (4, dict(max_new=32, n_neighbors=3)),
                                          (7, dict(epipolar_px=6.0, chi2_max=40.0,
                                                   min_parallax_cos=0.99999))],
                         ids=["defaults", "kf4-3-neighbours", "loose-gates"])
def test_triangulate_with_neighbor(grown, kf_id, kwargs):
    world, st, tcam = grown
    jst, jn = jtri.triangulate_with_neighbor(_j(st), jnp.int32(kf_id), world.cam, **kwargs)
    tst, tn = ttri.triangulate_with_neighbor(from_numpy_tree(st), _k(kf_id), tcam, **kwargs)
    assert int(tn) == int(jn)
    if "epipolar_px" in kwargs:
        assert int(jn) > 0
    _assert_close_after_dlt(tst, _np(jst))


def test_dlt_and_projection(grown):
    world, st, tcam = grown
    from orbslam3_tpu.geometry import quat as jq

    rng = np.random.default_rng(4)
    X = rng.uniform([-2, -2, 4], [2, 2, 12], (50, 3)).astype(np.float32)
    q2 = np.asarray(jq.from_axis_angle(jnp.asarray([0.02, -0.05, 0.01])))
    p2 = np.array([0.4, 0.1, -0.05], np.float32)
    q1, p1 = np.array([1, 0, 0, 0], np.float32), np.zeros(3, np.float32)
    jP1 = jtri._projection_matrix(world.cam, jnp.asarray(q1), jnp.asarray(p1))
    jP2 = jtri._projection_matrix(world.cam, jnp.asarray(q2), jnp.asarray(p2))
    tP1 = ttri._projection_matrix(tcam, tensor(q1), tensor(p1))
    tP2 = ttri._projection_matrix(tcam, tensor(q2), tensor(p2))
    np.testing.assert_allclose(tP2.numpy(), np.asarray(jP2), rtol=1e-6, atol=1e-5)
    Xh = np.concatenate([X, np.ones((50, 1), np.float32)], 1)
    uv1 = (Xh @ np.asarray(jP1).T)
    uv1 = (uv1[:, :2] / uv1[:, 2:]).astype(np.float32)
    uv2 = (Xh @ np.asarray(jP2).T)
    uv2 = (uv2[:, :2] / uv2[:, 2:]).astype(np.float32)
    jX = jax.vmap(lambda a, b: jtri._dlt(jP1, jP2, a, b))(jnp.asarray(uv1), jnp.asarray(uv2))
    tX = ttri._dlt(tP1, tP2, tensor(uv1), tensor(uv2))
    np.testing.assert_allclose(np.asarray(jX), X, rtol=0, atol=0.05)
    np.testing.assert_allclose(tX.numpy(), np.asarray(jX), rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("kf_id,kwargs", [(7, {}), (5, dict(window=4, radius=8.0, n_temporal=1))],
                         ids=["defaults", "kf5-wide"])
def test_fuse_map_points(grown, kf_id, kwargs):
    world, st, tcam = grown
    jst = jmo.fuse_map_points(_j(st), jnp.int32(kf_id), world.cam, **kwargs)
    tst = tmo.fuse_map_points(from_numpy_tree(st), _k(kf_id), tcam, **kwargs)
    assert_tree_close(tst, _np(jst))
    assert not np.array_equal(np.asarray(jst.kf_mp), st.kf_mp)  # it associated something


def test_fuse_after_triangulation_kills_duplicates(grown):
    """Triangulate from two keyframes, then fuse: the second pass spawned
    duplicates of the first's points, which fusion must remove the same way."""
    world, st, tcam = grown
    loose = dict(epipolar_px=6.0, chi2_max=40.0, min_parallax_cos=0.99999)
    jst, _ = jtri.triangulate_with_neighbor(_j(st), jnp.int32(7), world.cam, **loose)
    st2 = _np(jst)
    jst2 = jmo.fuse_map_points(_j(st2), jnp.int32(6), world.cam, radius=6.0)
    tst2 = tmo.fuse_map_points(from_numpy_tree(st2), _k(6), tcam, radius=6.0)
    assert_tree_close(tst2, _np(jst2))


def test_fuse_across_seam(grown):
    world, st, tcam = grown
    jst = jmo.fuse_across_seam(_j(st), jnp.int32(7), jnp.int32(1), world.cam)
    tst = tmo.fuse_across_seam(from_numpy_tree(st), _k(7), _k(1), tcam)
    assert_tree_close(tst, _np(jst))


@pytest.mark.parametrize("kf_id", [7, 3])
def test_update_point_stats(grown, kf_id):
    _, st, _ = grown
    jst = jmo.update_point_stats(_j(st), jnp.int32(kf_id))
    tst = tmo.update_point_stats(from_numpy_tree(st), _k(kf_id))
    assert_tree_close(tst, _np(jst))
    assert not np.array_equal(np.asarray(jst.mp_normal), st.mp_normal)
    assert not np.array_equal(np.asarray(jst.mp_desc), st.mp_desc)


def test_keyframe_redundancy(grown):
    _, st, _ = grown
    for k in (1, 4, 7):
        j = float(jmo.keyframe_redundancy(_j(st), jnp.int32(k), 2))
        t = float(tmo.keyframe_redundancy(from_numpy_tree(st), _k(k), 2))
        np.testing.assert_allclose(t, j, rtol=1e-6)
    assert float(jmo.keyframe_redundancy(_j(st), jnp.int32(3), 2)) > 0.1


@pytest.mark.parametrize("thresh,max_gap,min_other", [(0.3, 3.0, 2), (0.3, 0.15, 2), (0.99, 3.0, 3),
                                                      (0.05, 0.25, 1)])
def test_select_cull_candidate(grown, thresh, max_gap, min_other):
    _, st, _ = grown
    j = int(jmo.select_cull_candidate(_j(st), jnp.int32(7), jnp.float32(thresh),
                                      jnp.float32(max_gap), min_other))
    t = int(tmo.select_cull_candidate(from_numpy_tree(st), _k(7), tensor(np.float32(thresh)),
                                      tensor(np.float32(max_gap)), min_other))
    assert t == j
    if (thresh, max_gap) == (0.3, 3.0):
        assert j >= 1
    if thresh == 0.99 or max_gap == 0.15:
        assert j == -1


@pytest.mark.parametrize("last_kf,n_protect", [(7, 3), (2, 4), (7, 8)])
def test_select_pressure_evict_kf(grown, last_kf, n_protect):
    _, st, _ = grown
    j = int(jmo.select_pressure_evict_kf(_j(st), jnp.int32(last_kf), n_protect))
    t = int(tmo.select_pressure_evict_kf(from_numpy_tree(st), _k(last_kf), n_protect))
    assert t == j
    assert (j == -1) == (n_protect == 8)


@pytest.mark.parametrize("kf_id", [3, 7])
def test_remove_keyframe(grown, kf_id):
    """A middle keyframe (its successor inherits the merged preintegration
    and its predecessor) and the newest one (no successor)."""
    _, st, _ = grown
    jst = jmo.remove_keyframe(_j(st), jnp.int32(kf_id))
    tst = tmo.remove_keyframe(from_numpy_tree(st), _k(kf_id))
    assert_tree_close(tst, _np(jst))
    assert not bool(tst.kf_valid[kf_id])
    if kf_id == 3:
        assert int(tst.kf_prev[4]) == 2
        np.testing.assert_allclose(float(tst.kf_preint.dt[4]),
                                   float(st.kf_preint.dt[3] + st.kf_preint.dt[4]), rtol=1e-6)


def test_remove_keyframe_disabled_writes_nothing(grown):
    """enable=False leaves the state as it was (the step's cull pass that
    found no candidate); enable=True is the plain call."""
    import torch

    _, st, _ = grown
    st_t = from_numpy_tree(st)
    off = tmo.remove_keyframe(st_t, _k(3), enable=torch.tensor(False))
    assert_tree_close(off, st, rtol=0, atol=0)
    on = tmo.remove_keyframe(st_t, _k(3), enable=torch.tensor(True))
    assert_tree_close(on, _np(jmo.remove_keyframe(_j(st), jnp.int32(3))))


def test_cull_then_remove_sequence(grown):
    """The step's cull loop: select, remove, select again on the changed map."""
    _, st, _ = grown
    jst, tst = _j(st), from_numpy_tree(st)
    removed = []
    for _ in range(2):
        j = int(jmo.select_cull_candidate(jst, jnp.int32(7), jnp.float32(0.3), jnp.float32(3.0), 2))
        t = int(tmo.select_cull_candidate(tst, _k(7), tensor(np.float32(0.3)),
                                          tensor(np.float32(3.0)), 2))
        assert t == j and j >= 0
        removed.append(j)
        jst = jmo.remove_keyframe(jst, jnp.int32(j))
        tst = tmo.remove_keyframe(tst, _k(j))
        assert_tree_close(tst, _np(jst))
    assert len(set(removed)) == 2
