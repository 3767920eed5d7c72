"""The port's host services on a state carried from a JAX run of a scenario
(scripts/scenarios_torch.py), against the JAX methods on the same state:
`_reset_bad_imu` where the static world's JAX run resets (static_bad_imu,
frame 35), `_imu_refine` where the biased world's JAX run refines
(imu_refine, frame 63), and `_maybe_compact` where the JAX run of
long_run_evicts evicts stale points. The JAX FusedSlam runs the scenario on
the CPU up to that service call; its map, tracker state and host counters
go into a port FusedSlam(device="cpu") (interop.from_numpy_tree), both
packages then make the call, and the results are compared: integers,
booleans and counters equal; the refined gravity and biases, and the map's
float columns, within 1e-5 (the solves' tolerance of PERF.md section 6).
About 2.5 minutes on one worker, most of it the three JAX runs."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scenario_parity import sc
from torch_parity import assert_tree_close

from orbslam3_tpu.geometry import quat as jquat
from orbslam3_tpu.models.fused import FusedSlam as JFusedSlam
from orbslam3_tpu_torch.interop import from_numpy_tree
from orbslam3_tpu_torch.models.fused import FusedSlam

# the host state of FusedSlam that the three services read or write
HOST = ("_frames", "_last_t", "imu_initialized", "_kf_ub", "_mp_ub", "_imu_init_time",
        "_imu_phase", "imu_refines", "bad_imu_resets", "_refine_request",
        "_refine_attempt_round", "_last_mode_snap", "_service_round", "compactions",
        "kf_evictions", "mp_evictions", "map_evictions", "_n_kf_seen")


def _host(slam) -> dict:
    """HOST's values; the JAX package's defaults where it sets a counter
    only when it first changes."""
    return {k: getattr(slam, k, -99 if k == "_refine_attempt_round" else 0) for k in HOST}


def _snapshot(slam) -> dict:
    return dict(map=jax.tree.map(np.array, slam.map), ts=jax.tree.map(np.array, slam.ts),
                host=_host(slam))


def jax_call(name: str, method: str, when) -> tuple:
    """Run the scenario's JAX FusedSlam until the first call of `method`
    for which when(before, after) holds. Returns the states before and
    after that call."""
    import make_scenario_reference as mk

    spec = sc.SCENARIOS[name]
    world, cfg, times = sc.build(mk.jax_pkg(), name)
    frames = sc.render(world, times, name, workers=1)
    slam = JFusedSlam(world.cam, cfg, service_every=spec["service_every"])
    orig, box = getattr(slam, method), {}

    class Found(Exception):
        pass

    def wrapped():
        before = _snapshot(slam)
        orig()
        after = _snapshot(slam)
        if when(before, after):
            box.update(before=before, after=after)
            raise Found

    setattr(slam, method, wrapped)
    with pytest.raises(Found):
        sc.drive(slam, world, times, frames, name, lambda x: jnp.asarray(x, jnp.float32), jquat)
    return box["before"], box["after"]


def carried(name: str, state: dict) -> FusedSlam:
    """A port FusedSlam(device="cpu") holding a JAX snapshot's map, tracker
    state and host counters (the port's own mirrors of the row counts, atlas
    size and mode from the map)."""
    world, cfg, _ = sc.build(sc.port_pkg(), name)
    slam = FusedSlam(world.cam, cfg, service_every=sc.SCENARIOS[name]["service_every"],
                     device="cpu")
    slam.map, slam.ts = from_numpy_tree(state["map"]), from_numpy_tree(state["ts"])
    for k, v in state["host"].items():
        if v is not None:
            setattr(slam, k, v)
    slam._n_kf = int(slam.map.n_kf)
    slam._next_map_id = int(slam.map.next_map_id)
    slam._mode = int(slam.ts.mode)
    return slam


def assert_same_state(slam, after: dict, atol: float = 0.0):
    assert_tree_close(slam.map, after["map"], rtol=atol, atol=atol, path="map")
    assert_tree_close(slam.ts, after["ts"], rtol=atol, atol=atol, path="ts")
    got = _host(slam)
    for k, v in after["host"].items():
        assert got[k] == v, (k, got[k], v)


def test_reset_bad_imu_on_a_carried_state():
    before, after = jax_call("static_bad_imu", "_reset_bad_imu",
                             lambda b, a: a["host"]["bad_imu_resets"] > b["host"]["bad_imu_resets"])
    assert int(before["map"].n_kf) > 0 and int(after["map"].active_map) == int(
        before["map"].active_map)
    slam = carried("static_bad_imu", before)
    slam._reset_bad_imu()
    assert_same_state(slam, after)


def test_imu_refine_on_a_carried_state():
    before, after = jax_call("imu_refine", "_imu_refine",
                             lambda b, a: a["host"]["imu_refines"] > b["host"]["imu_refines"])
    slam = carried("imu_refine", before)
    syncs = slam.host_syncs
    slam._imu_refine()
    assert slam.host_syncs - syncs == 2  # the keyframe table and the solve's result
    assert_same_state(slam, after, atol=1e-5)
    g_before = before["ts"].gravity_w
    assert not np.array_equal(np.asarray(slam.ts.gravity_w), g_before)  # a refine was accepted


def test_stale_point_eviction_on_a_carried_state():
    name = "long_run_evicts"
    before, after = jax_call(name, "_maybe_compact",
                             lambda b, a: a["host"]["mp_evictions"] > b["host"]["mp_evictions"])
    slam = carried(name, before)
    slam._maybe_compact()
    assert slam.mp_evictions > before["host"]["mp_evictions"]
    assert int(slam.map.n_mp) == int(after["map"].n_mp) < int(before["map"].n_mp)
    assert_same_state(slam, after)
    assert torch.equal(slam.map.mp_valid[:int(slam.map.n_mp)],
                       torch.ones(int(slam.map.n_mp), dtype=torch.bool))
