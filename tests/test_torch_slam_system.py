"""The port's host-orchestrated SlamSystem and local_ba_step against the JAX
package, on the CPU.

Both SlamSystems run the small world of tests/test_fused.py (384x256, 2 s at
10 Hz, torch_parity.SMALL_WORLD) under the configuration of the JAX
package's SlamSystem tests (tests/test_e2e_stereo.py and
test_e2e_inertial.py: 384 features, 4 levels, kf_max_frames=2,
imu_init_kfs=8), stereo and stereo-inertial, on the same rendered frames and
IMU windows. Fed the JAX front end's StereoFrame of every frame (as
scripts/vi_backend_witness.py feeds FusedSlam), the port's back end holds
the per-frame state, keyframe flag, match and inlier counts exact and the
poses and the final map within 1e-4; points triangulated from features
without stereo depth within 1e-3 relative (slam_system_parity.
assert_map_close: given the same keyframes they agree to 1e-5,
tests/test_torch_mapping.py, but their nearly parallel rays amplify the
poses' last-bit differences). With its own front end its ATE is within 5 mm
(stereo) and 1 cm (stereo-inertial) of JAX's.

Also held: local_ba_step on the JAX system's map within 1e-4, and a mid-run
JAX state carried into the port (interop.carry_slam_system) stepping one
keyframe frame within 1e-4 of JAX's step. The atlas and static worlds, the
fleet's step and the profiling script are in test_torch_slam_system_worlds.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from orbslam3_tpu.io.synthetic import SyntheticConfig, SyntheticWorld
from orbslam3_tpu.map import compaction as jcomp
from orbslam3_tpu.models import local_mapper as jlm
from orbslam3_tpu.models import slam as jslam
from orbslam3_tpu_torch.eval.metrics import ate_rmse
from orbslam3_tpu_torch.interop import from_numpy_tree
from orbslam3_tpu_torch.models import local_mapper as tlm
from orbslam3_tpu_torch.models import slam as tslam
from slam_system_parity import (assert_map_close, clear_jax, configs, jax_run, patched, port_run,
                                records)
from torch_parity import SMALL_WORLD, assert_tree_close, jax_slam_system_state, port_camera


@pytest.fixture(scope="module")
def small():
    """Stereo and stereo-inertial on the small world: JAX, the port fed
    JAX's features, the port with its own front end."""
    world = SyntheticWorld(SyntheticConfig(**SMALL_WORLD))
    inputs = chip_smoke.slam_system_inputs(world)
    out = {"world": world, "inputs": inputs}
    for name in ("stereo", "inertial"):
        jcfg, tcfg = configs(name)
        j = jax_run(world, jcfg, inputs)
        out[name] = dict(jax=j, fed=port_run(world, tcfg, inputs, fed=j["frames"]),
                         own=port_run(world, tcfg, inputs), tcfg=tcfg, jcfg=jcfg)
    clear_jax()
    yield out
    clear_jax()


@pytest.mark.parametrize("name", ["stereo", "inertial"])
def test_fed_slam_system_frame_by_frame(small, name):
    """Per-frame state, keyframe flag and counts exact, poses within 1e-4."""
    j, t = small[name]["jax"]["slam"], small[name]["fed"]["slam"]
    assert records(t) == records(j)
    assert any(r.is_keyframe for r in j.trajectory[1:])
    _, tp, tq = t.trajectory_arrays()
    _, jp, jq = j.trajectory_arrays()
    np.testing.assert_allclose(tp, jp, rtol=0, atol=1e-4)
    np.testing.assert_allclose(tq, jq, rtol=0, atol=1e-4)
    assert small[name]["fed"]["init"] == small[name]["jax"]["init"]
    if name == "inertial":
        assert j.imu_initialized and t.imu_initialized
        np.testing.assert_allclose(t.gravity_w.numpy(), np.asarray(j.gravity_w), atol=1e-4)
        np.testing.assert_allclose(t.bg.numpy(), np.asarray(j.bg), atol=1e-4)


@pytest.mark.parametrize("name", ["stereo", "inertial"])
def test_fed_slam_system_final_map(small, name):
    """The final map: ids and masks exact, floats within 1e-4."""
    j, t = small[name]["jax"]["slam"], small[name]["fed"]["slam"]
    assert_map_close(t.map, j.map)
    assert (t.last_kf_id, t.frames_since_kf, t.ref_inliers, t.kfs_since_cull) == (
        j.last_kf_id, j.frames_since_kf, j.ref_inliers, j.kfs_since_cull)


@pytest.mark.parametrize("name,tol", [("stereo", 5e-3), ("inertial", 1e-2)])
def test_own_frontend_ate(small, name, tol):
    """The port's own front end: ATE within 5 mm (stereo) / 1 cm
    (stereo-inertial) of JAX's, the JAX tests' bars met."""
    gt = small["world"].gt_trajectory()[0]
    j, t = small[name]["jax"]["slam"], small[name]["own"]["slam"]
    ate_j = ate_rmse(j.trajectory_arrays()[1], gt[:len(j.trajectory)])
    ate_t = ate_rmse(t.trajectory_arrays()[1], gt[:len(t.trajectory)])
    assert len(t.trajectory) == len(j.trajectory)
    assert abs(ate_t - ate_j) <= tol, (ate_t, ate_j)
    assert ate_t < 0.05 and np.mean([r.state == "Ok" for r in t.trajectory]) > 0.9
    assert t.imu_initialized == j.imu_initialized


def test_local_ba_step_on_jax_map(small):
    """local_ba_step around the newest keyframe of the JAX system's map,
    with JAX's defaults (window 8, 2048 points, 8 iterations, 8 fixed)."""
    j = small["stereo"]["jax"]["slam"]
    st = jax.tree.map(np.asarray, j.map)
    kf = j.last_kf_id
    jst, jres = jlm.local_ba_step(j.map, j.cam, jax.numpy.int32(kf))
    tst, tres = tlm.local_ba_step(from_numpy_tree(st), port_camera(j.cam),
                                  torch.tensor(kf, dtype=torch.int32))
    assert_tree_close(tst, jax.tree.map(np.asarray, jst), rtol=1e-4, atol=1e-4)
    for f in ("q", "p", "Xw"):
        np.testing.assert_allclose(getattr(tres, f).numpy(), np.asarray(getattr(jres, f)),
                                   rtol=1e-4, atol=1e-4, err_msg=f)
    moved = np.abs(np.asarray(jst.kf_p) - st.kf_p).max()
    assert moved > 0  # the solve moved the window


@pytest.mark.parametrize("compacting", [False, True], ids=["insert", "compacting-insert"])
def test_carried_state_steps_a_keyframe(small, compacting):
    """A mid-run JAX state (stereo-inertial, after the IMU initialized if it
    did) carried into the port, then one keyframe frame: the FrameResult's
    counts exact, its pose, the body state and the map within 1e-4. With
    new_mp_budget at max_mp - 1 (the spawn budget still caps nothing: a
    keyframe has 384 features) the insert finds the map at its point margin
    and compacts it first, remapping the tracked matches and last_kf_id."""
    run = small["inertial"]["jax"]
    recs = records(run["slam"])
    kfs = [i for i, r in enumerate(recs) if r[1] and run["states"][i]["map"].n_kf >= 3]
    after = [i for i in kfs if run["init"] is not None and i > run["init"]]
    k = (after or kfs)[-1]
    state = run["states"][k - 1]
    tcfg, jcfg = small["inertial"]["tcfg"], small["inertial"]["jcfg"]
    calls = []

    def counted(fn):
        return lambda st: calls.append(fn) or fn(st)

    if compacting:
        tcfg = tcfg._replace(new_mp_budget=tcfg.cap.max_mp - 1)
        jcfg = jcfg._replace(new_mp_budget=jcfg.cap.max_mp - 1)
        js = jslam.SlamSystem(small["world"].cam, jcfg)
        # copies of the lists: the JAX system appends to its IMU buffers
        vars(js).update({**{k_: list(v) if isinstance(v, list) else v for k_, v in state.items()},
                         "map": jax.tree.map(jnp.asarray, state["map"])})
        with patched(jcomp, "compact_map", counted(jcomp.compact_map)):
            js.process_frame(*small["inputs"][k])
        jst = jax_slam_system_state(js)
    else:
        jst = run["states"][k]
    with patched(tslam, "compact_map", counted(tslam.compact_map)):
        port = port_run(small["world"], tcfg, small["inputs"][k:k + 1],
                        fed=run["frames"][k:k + 1], state=state)["slam"]
    assert len(calls) == 2 * compacting  # JAX's and the port's insert each compacted once
    r, jr = port.trajectory[-1], jst["trajectory"][-1]
    assert (r.state, r.is_keyframe, r.n_matches, r.n_inliers) == (
        jr.state, jr.is_keyframe, jr.n_matches, jr.n_inliers)
    assert r.is_keyframe
    np.testing.assert_allclose(r.p, jr.p, atol=1e-4)
    np.testing.assert_allclose(r.q, jr.q, atol=1e-4)
    for f in ("q", "p", "v", "bg", "ba"):
        np.testing.assert_allclose(getattr(port, f).numpy(), jst[f], atol=1e-4, err_msg=f)
    assert_map_close(port.map, jst["map"])
    assert (port.imu_initialized, port.last_kf_id, port.ref_inliers) == (
        jst["imu_initialized"], jst["last_kf_id"], jst["ref_inliers"])


def test_slam_system_picks_the_card():
    """Without a device the port's SlamSystem runs on the CUDA card, and
    raises where there is none."""
    world = SyntheticWorld(SyntheticConfig(**SMALL_WORLD))
    if torch.cuda.is_available():
        assert tslam.SlamSystem(port_camera(world.cam)).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tslam.SlamSystem(port_camera(world.cam))
