"""Torch port of visual local BA against the JAX package on a map grown
from the small world: build_ba_problem + solve_local_ba + apply_ba_results
from one MapState (carried across as numpy). The problem gather is exact;
poses after the solve agree within 1e-4 and points within 1e-4 + 2e-4
relative (the Hessian scatter-adds sum in another order, and a point seen
from two nearby keyframes is poorly conditioned along its ray, so its
rounding differences grow with its depth)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from orbslam3_tpu.frontend.orb import OrbConfig as JOrb
from orbslam3_tpu.imu import preintegration as jpre
from orbslam3_tpu.io.synthetic import SyntheticConfig, SyntheticWorld
from orbslam3_tpu.map import slam_map as jsm
from orbslam3_tpu.models import fused as jfused
from orbslam3_tpu.models import local_mapper as jlm
from orbslam3_tpu.models import slam as jslam
from orbslam3_tpu.models import tracker as jtr
from orbslam3_tpu.optim import local_ba as jba
from orbslam3_tpu_torch.interop import from_numpy_tree
from orbslam3_tpu_torch.models import local_mapper as tlm
from orbslam3_tpu_torch.optim import local_ba as tba
from torch_parity import SMALL_WORLD, assert_tree_close, port_camera, tensor

CAP = jsm.MapCapacity(max_kf=16, n_feat=384, max_mp=4096, max_obs=8)
CFG = jslam.SlamConfig(orb=JOrb(n_features=384, n_levels=4), cap=CAP, use_imu=False)
N_KF = 5


@pytest.fixture(scope="module")
def grown():
    """N_KF keyframes inserted at ground-truth poses perturbed by a few cm,
    each tracked against the map so far (points gain observations)."""
    world = SyntheticWorld(SyntheticConfig(**SMALL_WORLD))
    fe = jax.jit(jfused._frontend, static_argnames=("cfg",))
    rng = np.random.default_rng(0)
    st = jsm.empty_map(CAP)
    z3 = jnp.zeros(3)
    for i in range(N_KF):
        t = 0.1 * i
        l, r = world.render_frame(t)
        featL, u_r, depth, has_depth, pts = fe(jnp.asarray(l.astype(np.uint8)),
                                               jnp.asarray(r.astype(np.uint8)), world.cam, cfg=CFG)
        q, p = world.gt_pose(t)
        p = p + rng.normal(0, 0.02, 3).astype(np.float32) * (i > 0)
        if i == 0:
            matched = -jnp.ones(CAP.n_feat, jnp.int32)
        else:
            matched = jtr.match_local_map(st, world.cam, featL.uv, featL.desc, featL.octave,
                                          featL.valid, jnp.asarray(q), jnp.asarray(p),
                                          jtr.TrackConfig(p_local=1024))[0]
        st, _ = jsm.insert_keyframe(st, jnp.float32(t), jnp.asarray(q), jnp.asarray(p), z3, z3, z3,
                                    featL.uv, u_r, depth, featL.octave, featL.desc, pts, featL.valid,
                                    matched, jpre.PreintState.identity(), jnp.int32(i - 1),
                                    new_mp_budget=CFG.new_mp_budget)
    return world, jax.tree.map(np.asarray, st)


@pytest.mark.parametrize("window,fixed", [(4, 16), (8, 2)])
def test_local_ba(grown, window, fixed):
    world, st_np = grown
    kf_id = N_KF - 1
    st_j = jax.tree.map(jnp.asarray, st_np)
    jprob, jids, jvalid, jpt, jptv = jlm.build_ba_problem(st_j, jnp.int32(kf_id), window, 1024, fixed)
    st_t = from_numpy_tree(st_np)
    tprob, tids, tvalid, tpt, tptv = tlm.build_ba_problem(st_t, tensor(np.int32(kf_id)), window,
                                                          1024, fixed)
    assert_tree_close(tprob, jax.tree.map(np.asarray, jprob), rtol=0, atol=0)
    for a, b in ((tids, jids), (tvalid, jvalid), (tpt, jpt), (tptv, jptv)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert int(np.asarray(jprob.opt_cam).sum()) >= 2

    jres = jba.solve_local_ba(jprob, world.cam, iters=4)
    tres = tba.solve_local_ba(tprob, port_camera(world.cam), iters=4)
    assert float(jres.cost1) < float(jres.cost0)
    np.testing.assert_allclose(float(tres.cost0), float(jres.cost0), rtol=1e-4)
    np.testing.assert_allclose(float(tres.cost1), float(jres.cost1), rtol=1e-3)
    jout = jlm.apply_ba_results(st_j, jids, jvalid & jprob.opt_cam, jres.q, jres.p, jpt, jptv, jres.Xw)
    tout = tlm.apply_ba_results(st_t, tids, tvalid & tprob.opt_cam, tres.q, tres.p, tpt, tptv, tres.Xw)
    for name, a, b in zip(("kf_q", "kf_p"), tout[:2], jout[:2]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-4, err_msg=name)
    np.testing.assert_allclose(tout[2].numpy(), np.asarray(jout[2]), rtol=2e-4, atol=1e-4)
