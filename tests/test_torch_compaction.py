"""Map compaction and the capacity evictions of the port against the JAX
package, on the small maps of tests/test_compaction.py (8 keyframe rows, 32
features, 128 points): compact_map after nothing, after a keyframe removal
and after a point cull, every column of the state and both old->new tables
(integer and boolean columns exact, float columns bit for bit: a gather
computes nothing); the rows reused by the next insert; concat_maps;
evict_stale_points with exactly tied scores; drop_map."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam3_tpu.map import compaction as jc
from orbslam3_tpu.map import mapping_ops as jmo
from orbslam3_tpu.map import slam_map as jsm
from orbslam3_tpu_torch.interop import from_numpy_tree
from orbslam3_tpu_torch.map import compaction as tc
from orbslam3_tpu_torch.map import slam_map as tsm
from tests.test_compaction import CAP, _build_map, _check_consistency
from tests.test_map import make_kf_inputs
from torch_parity import assert_tree_close, tensor


def np_state(st):
    return jax.tree.map(np.asarray, st)


def port(st):
    return from_numpy_tree(np_state(st))


def assert_same(t_state, j_state):
    """Every leaf: dtype, shape, and every value exactly."""
    assert_tree_close(t_state, np_state(j_state), rtol=0, atol=0)


def jax_maps():
    dense = _build_map(4)
    removed = jmo.remove_keyframe(_build_map(5), jnp.int32(2))
    st = _build_map(3)
    bad = jnp.zeros((CAP.max_mp,), bool).at[jnp.asarray([1, 3, 5, 7, 9, 20, 21, 22, 30])].set(True)
    culled = jsm._remove_map_points(st, bad & st.mp_valid)
    both = jsm._remove_map_points(removed, bad & removed.mp_valid)
    return {"dense": dense, "keyframe_removed": removed, "points_culled": culled,
            "both": both, "empty": jsm.empty_map(CAP)}


@pytest.fixture(scope="module")
def maps():
    return jax_maps()


CASES = ["dense", "keyframe_removed", "points_culled", "both", "empty"]


@pytest.mark.parametrize("case", CASES)
def test_compact_map_every_column(maps, case):
    j_st, j_kf, j_mp = jc.compact_map(maps[case])
    t_st, t_kf, t_mp = tc.compact_map(port(maps[case]))
    assert_same(t_st, j_st)
    assert t_kf.dtype == t_mp.dtype == torch.int32
    np.testing.assert_array_equal(t_kf.numpy(), np.asarray(j_kf))
    np.testing.assert_array_equal(t_mp.numpy(), np.asarray(j_mp))
    assert t_st.n_kf.dim() == 0 and t_st.n_kf.dtype == torch.int32


@pytest.mark.parametrize("case", CASES)
def test_compact_map_invariants(maps, case):
    """Rows [n_kf:] and [n_mp:] are pristine, every id column is in range,
    the counts are the live counts, and kf_mp and the observation lists are
    exact inverses of each other."""
    before = port(maps[case])
    st, kf_map, mp_map = tc.compact_map(before)
    n_kf, n_mp = int(st.n_kf), int(st.n_mp)
    assert n_kf == int(before.kf_valid.sum()) and n_mp == int(before.mp_valid.sum())
    empty = tsm.empty_map(CAP)
    for name in tsm.MapState._fields:
        a, e = getattr(st, name), getattr(empty, name)
        if name == "kf_preint" or a.dim() == 0:
            continue
        n = n_kf if name.startswith("kf_") or name == "covis" else n_mp
        if name in ("kf_q", "kf_p", "kf_v", "kf_bg", "kf_ba", "kf_time", "kf_uv", "kf_ur",
                    "kf_depth", "kf_octave", "kf_desc", "mp_pos", "mp_desc", "mp_normal",
                    "mp_min_dist", "mp_max_dist"):
            continue  # gathered, not filled: freed rows keep what the dead rows held
        assert torch.equal(a[n:], e[n:]), name
    assert not st.covis[:, n_kf:].any()
    for ids, hi in ((st.kf_mp, n_mp), (st.mp_obs_kf, n_kf), (st.kf_prev, n_kf),
                    (st.mp_first_kf, n_kf)):
        assert int(ids.min()) >= -1 and int(ids.max()) < max(hi, 1)
    assert st.kf_valid[:n_kf].all() and st.mp_valid[:n_mp].all()
    live = kf_map >= 0
    assert torch.equal(kf_map[live], torch.arange(n_kf, dtype=torch.int32))
    assert torch.equal(mp_map[mp_map >= 0], torch.arange(n_mp, dtype=torch.int32))
    _check_consistency(st)


def test_compaction_after_removal_moves_rows_and_chain(maps):
    before = port(maps["keyframe_removed"])
    st, kf_map, _ = tc.compact_map(before)
    assert int(st.n_kf) == 4 and kf_map.tolist()[:5] == [0, 1, -1, 2, 3]
    keep = torch.tensor([0, 1, 3, 4])
    assert torch.equal(st.kf_time[:4], before.kf_time[keep])
    assert torch.equal(st.covis[:4, :4], before.covis[keep][:, keep])
    assert torch.equal(st.kf_preint.dp[:4], before.kf_preint.dp[keep])
    assert int(st.kf_prev[2]) == 1  # kf 3's predecessor was repaired to kf 1


def test_insert_after_compaction_reuses_rows(maps):
    j_st, _, _ = jc.compact_map(maps["points_culled"])
    t_st, _, _ = tc.compact_map(port(maps["points_culled"]))
    inputs = make_kf_inputs(seed=99)
    inputs["prev_kf"] = jnp.int32(2)
    j2, jk = jsm.insert_keyframe(j_st, **inputs, new_mp_budget=8)
    t_in = {k: tensor(v) for k, v in inputs.items() if k != "preint"}
    t_in["preint"] = from_numpy_tree(np_state(inputs["preint"]))
    t2, tk = tsm.insert_keyframe(t_st, **t_in, new_mp_budget=8)
    assert int(tk) == int(jk) == int(t_st.n_kf)
    assert int(t2.n_mp) == int(t_st.n_mp) + 8 and t2.mp_valid[: int(t2.n_mp)].all()
    assert_tree_close(t2, np_state(j2), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("a,b", [("keyframe_removed", "points_culled"), ("dense", "empty")])
def test_concat_maps(maps, a, b):
    j_st, j_ko, j_mo = jc.concat_maps(maps[a], maps[b])
    t_st, t_ko, t_mo = tc.concat_maps(port(maps[a]), port(maps[b]))
    assert (t_ko, t_mo) == (j_ko, j_mo) and isinstance(t_ko, int)
    assert_same(t_st, j_st)
    _check_consistency(t_st)


def test_concat_maps_refuses_overflow_and_other_capacities(maps):
    with pytest.raises(ValueError, match="exceeds capacity"):
        tc.concat_maps(port(maps["dense"]), port(_build_map(5)))
    with pytest.raises(ValueError, match="identical capacities"):
        tc.concat_maps(port(maps["dense"]), tsm.empty_map(CAP._replace(max_kf=4)))


@pytest.mark.parametrize("n_evict,n_protect", [(4, 2), (16, 2), (128, 1), (8, 8)])
def test_evict_stale_points_with_ties(n_evict, n_protect):
    """Points spawned by one keyframe and seen by no other share their
    score exactly (one observation, the same newest time): which of them go
    is decided by the order among equal values, the lower row first."""
    st = _build_map(5)
    j = jsm.evict_stale_points(st, n_evict, n_protect)
    t = tsm.evict_stale_points(port(st), n_evict, n_protect)
    assert_same(t, j)
    gone = np.flatnonzero(np.asarray(st.mp_valid) & ~t.mp_valid.numpy())
    if n_protect < 8:
        assert 0 < len(gone) <= n_evict
        score = np.asarray(st.mp_obs_n)[gone]
        assert (score == score.min()).all()  # tied on the count, and more were eligible
    else:  # every keyframe is protected: nothing is eligible
        assert len(gone) == 0


def test_drop_map_and_reset_active_map():
    """Two atlas maps in one state: dropping the archived one (and resetting
    the active one) clears its rows, lists and covisibility only."""
    st = jsm.create_new_map(_build_map(3))
    for k in range(3, 6):
        inputs = make_kf_inputs(seed=k)
        inputs["prev_kf"] = jnp.int32(k - 1 if k > 3 else -1)
        inputs["time"] = jnp.float32(0.5 * k)
        st, _ = jsm.insert_keyframe(st, **inputs, new_mp_budget=16)
    assert sorted(set(np.asarray(st.kf_map_id)[:6].tolist())) == [0, 1]
    for map_id in (0, 1, 7):
        j = jsm.drop_map(st, jnp.int32(map_id))
        t = tsm.drop_map(port(st), torch.tensor(map_id, dtype=torch.int32))
        assert_same(t, j)
        assert int(t.kf_valid.sum()) == (6 if map_id == 7 else 3)
    assert_same(tsm.reset_active_map(port(st)), jsm.reset_active_map(st))
    t = tc.compact_map(tsm.drop_map(port(st), torch.tensor(0, dtype=torch.int32)))[0]
    assert_same(t, jc.compact_map(jsm.drop_map(st, jnp.int32(0)))[0])
    _check_consistency(t)
