"""Torch port of visual-inertial local BA against the JAX package.

* build_vi_ba_problem on a map grown from the small world (keyframes
  chained by kf_prev, each with its preintegrated IMU window): ids, masks
  and the gathered problem exact;
* solve_vi_ba on the synthetic fixture of tests/test_vi_ba.py: poses 1e-4,
  velocities 1e-3, biases 1e-4, points 1e-4 + 2e-4 relative (the Hessian
  sums run in another order; a point seen from nearby keyframes is poorly
  conditioned along its ray). 5 iterations, not the fixture's 10: by then
  the solve has converged, the accept test of a step flips on the cost's
  last bits, and two points with a single observation end 8 mm apart along
  their rays;
* slot 0 takes IMU blocks from two edges (edge 0 and edge 1 both have slot
  0 as their older end): the block assembly against an explicit loop with
  every edge's blocks nonzero, which fails if duplicate block rows are
  dropped, and the whole solve with slot 0 free. (In a solve edge 0 is
  masked and its blocks are zeros, so an assembly that keeps only the last
  lane of a duplicate row would pass the solve by lane order.)
* apply_vi_ba_results exact."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from orbslam3_tpu.frontend.orb import OrbConfig as JOrb
from orbslam3_tpu.map import slam_map as jsm
from orbslam3_tpu.models import local_mapper as jlm
from orbslam3_tpu.models import slam as jslam
from orbslam3_tpu.optim import vi_ba as jvb
from orbslam3_tpu_torch.interop import from_numpy_tree
from orbslam3_tpu_torch.models import local_mapper as tlm
from orbslam3_tpu_torch.optim import vi_ba as tvb
from tests import test_vi_ba as fixture
from torch_parity import assert_tree_close, grow_jax_map, port_camera, tensor

CAP = jsm.MapCapacity(max_kf=16, n_feat=384, max_mp=4096, max_obs=8)
CFG = jslam.SlamConfig(orb=JOrb(n_features=384, n_levels=4), cap=CAP)
N_KF = 6
G = np.array([0.0, 0.0, -9.81], np.float32)


@pytest.fixture(scope="module")
def grown():
    return grow_jax_map(N_KF, CAP, CFG)


def _both_problems(st_np, kf_id, window, fixed, points=1024):
    st_j = jax.tree.map(jnp.asarray, st_np)
    j = jlm.build_vi_ba_problem(st_j, jnp.int32(kf_id), window, points, jnp.asarray(G), fixed)
    st_t = from_numpy_tree(st_np)
    t = tlm.build_vi_ba_problem(st_t, tensor(np.int32(kf_id)), window, points, tensor(G), fixed)
    return st_j, j, st_t, t


@pytest.mark.parametrize("window,fixed,kf_id", [(4, 0, 5), (8, 0, 5), (3, 2, 5), (4, 0, 2)])
def test_build_vi_ba_problem(grown, window, fixed, kf_id):
    _, st_np = grown
    _, (jprob, jids, jvalid, jpt, jptv), _, (tprob, tids, tvalid, tpt, tptv) = _both_problems(
        st_np, kf_id, window, fixed)
    assert type(tprob).__name__ == "VIBAProblem"
    assert_tree_close(tprob, jax.tree.map(np.asarray, jprob), rtol=0, atol=0)
    for a, b in ((tids, jids), (tvalid, jvalid), (tpt, jpt), (tptv, jptv)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert int(np.asarray(jprob.imu_edge_valid).sum()) == min(window, kf_id + 1) - 1


def test_build_vi_ba_problem_broken_chain(grown):
    """A keyframe whose predecessor link is cut ends the window there."""
    _, st_np = grown
    prev = st_np.kf_prev.copy()
    prev[3] = -1
    st_cut = st_np._replace(kf_prev=prev)
    _, (jprob, jids, jvalid, _, _), _, (tprob, tids, tvalid, _, _) = _both_problems(
        st_cut, 5, 6, 0)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    np.testing.assert_array_equal(tvalid.numpy(), np.asarray(jvalid))
    np.testing.assert_array_equal(tprob.imu_edge_valid.numpy(), np.asarray(jprob.imu_edge_valid))
    np.testing.assert_array_equal(tprob.opt_cam.numpy(), np.asarray(jprob.opt_cam))
    assert int(tvalid.sum()) == 3


def _check_solution(tres, jres, st=None):
    for name, atol in (("q", 1e-4), ("p", 1e-4), ("v", 1e-3), ("bg", 1e-4), ("ba", 1e-4)):
        np.testing.assert_allclose(getattr(tres, name).numpy(), np.asarray(getattr(jres, name)),
                                   rtol=0, atol=atol, err_msg=name)
    np.testing.assert_allclose(tres.Xw.numpy(), np.asarray(jres.Xw), rtol=2e-4, atol=1e-4)
    np.testing.assert_allclose(float(tres.cost0), float(jres.cost0), rtol=1e-4)
    np.testing.assert_allclose(float(tres.cost1), float(jres.cost1), rtol=2e-3)


def _synthetic_problem(C, fixed_slot=0):
    P, N = 160, 64
    qs, ps, vs, preints, lm, obs_uv, obs_ur, obs_oct, obs_pt = fixture.build_vi_problem(C, P, N)
    rng = np.random.default_rng(5)
    p_pert = np.asarray(ps) + rng.normal(0, 0.04, (C, 3)).astype(np.float32)
    p_pert[fixed_slot] = np.asarray(ps)[fixed_slot]
    v_pert = np.asarray(vs) + rng.normal(0, 0.25, (C, 3)).astype(np.float32)
    X_pert = np.asarray(lm) + rng.normal(0, 0.06, (P, 3)).astype(np.float32)
    opt = np.arange(C) != fixed_slot
    prob = jvb.VIBAProblem(
        q=qs, p=jnp.asarray(p_pert), v=jnp.asarray(v_pert), bg=jnp.zeros((C, 3)),
        ba=jnp.zeros((C, 3)), opt_cam=jnp.asarray(opt), cam_valid=jnp.ones(C, bool),
        Xw=jnp.asarray(X_pert), pt_valid=jnp.ones(P, bool), obs_uv=jnp.asarray(obs_uv),
        obs_ur=jnp.asarray(obs_ur), obs_oct=jnp.asarray(obs_oct), obs_pt=jnp.asarray(obs_pt),
        preint=preints, imu_edge_valid=preints.dt > 1e-4, gravity_w=jnp.asarray(G))
    return prob, (ps, vs)


@pytest.mark.parametrize("C,iters", [(6, 5), (3, 4)])
def test_solve_vi_ba_fixture(C, iters):
    jprob, (ps, vs) = _synthetic_problem(C)
    tprob = from_numpy_tree(jax.tree.map(np.asarray, jprob))
    assert type(tprob).__name__ == "VIBAProblem"
    jres = jvb.solve_vi_ba(jprob, fixture.CAM, iters=iters)
    tres = tvb.solve_vi_ba(tprob, port_camera(fixture.CAM), iters=iters)
    assert type(from_numpy_tree(jax.tree.map(np.asarray, jres))).__name__ == "VIBAResult"
    assert float(jres.cost1) < float(jres.cost0) * 0.2
    _check_solution(tres, jres)
    if C == 6:
        p_err = np.linalg.norm(tres.p.numpy() - np.asarray(ps), axis=-1)
        assert p_err.max() < 0.03, p_err


@pytest.mark.parametrize("C", [3, 6, 8])
def test_edge_blocks_accumulate_duplicate_rows(C):
    """_edge_blocks against the JAX module's scatter-adds written as a loop:
    rows i_idx = clip(c - 1, 0) hold slot 0 twice, and both edges count."""
    import torch

    rng = np.random.default_rng(C)
    R, D = 9, 15
    J = rng.normal(0, 1, (C, 2, R, D)).astype(np.float32)
    res = rng.normal(0, 1, (C, R)).astype(np.float32)
    i_idx = np.clip(np.arange(C) - 1, 0, C - 1)
    S_want = np.zeros((C, D, C, D))
    b_want = np.zeros((C, D))
    for c in range(C):
        ends = (i_idx[c], c)
        for sa in range(2):
            b_want[ends[sa]] += J[c, sa].T.astype(np.float64) @ res[c]
            for sb in range(2):
                S_want[ends[sa], :, ends[sb], :] += J[c, sa].T.astype(np.float64) @ J[c, sb]
    eye = torch.eye(C)
    sel = torch.stack([eye[torch.from_numpy(i_idx)], eye], dim=1)
    S_got, b_got = tvb._edge_blocks(sel, tensor(J), tensor(res))
    np.testing.assert_allclose(S_got.numpy(), S_want, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(b_got.numpy(), b_want, rtol=1e-5, atol=1e-4)
    # the duplicated slot really holds two edges' worth
    both = J[0, 0].T @ J[0, 0] + J[0, 0].T @ J[0, 1] + J[0, 1].T @ J[0, 0] + J[0, 1].T @ J[0, 1] \
        + J[1, 0].T @ J[1, 0]
    np.testing.assert_allclose(S_got[0, :, 0, :].numpy(), both, rtol=1e-4, atol=1e-4)


def test_solve_vi_ba_duplicate_block_rows():
    """Slot 0 free and the newest slot the fixed anchor: slot 0's diagonal
    block takes the older-end IMU blocks of edge 0 (masked, zeros) and of
    edge 1. An assembly that lets one of the two overwrite the other either
    loses edge 1's block or keeps it by luck of lane order; summing both is
    the only assembly that matches for every C."""
    for C in (3, 4):
        jprob, _ = _synthetic_problem(C, fixed_slot=C - 1)
        tprob = from_numpy_tree(jax.tree.map(np.asarray, jprob))
        jres = jvb.solve_vi_ba(jprob, fixture.CAM, iters=3)
        tres = tvb.solve_vi_ba(tprob, port_camera(fixture.CAM), iters=3)
        assert float(jres.cost1) < float(jres.cost0)
        # the step moved slot 0, so its blocks mattered
        assert float(np.abs(np.asarray(jres.v)[0] - np.asarray(jprob.v)[0]).max()) > 1e-3
        _check_solution(tres, jres)


def test_vi_ba_on_map_and_apply(grown):
    world, st_np = grown
    st_j, (jprob, jids, jvalid, jpt, jptv), st_t, (tprob, tids, tvalid, tpt, tptv) = \
        _both_problems(st_np, N_KF - 1, 6, 0)
    jres = jvb.solve_vi_ba(jprob, world.cam, iters=3)
    tres = tvb.solve_vi_ba(tprob, port_camera(world.cam), iters=3)
    assert float(jres.cost1) < float(jres.cost0)
    _check_solution(tres, jres)
    # apply: the same (JAX) solution scattered by both, exact
    jout = jlm.apply_vi_ba_results(st_j, jids, jvalid & jprob.opt_cam, jres.q, jres.p, jres.v,
                                   jres.bg, jres.ba, jpt, jptv, jres.Xw)
    r = from_numpy_tree(jax.tree.map(np.asarray, jres))
    tout = tlm.apply_vi_ba_results(st_t, tids, tvalid & tprob.opt_cam, r.q, r.p, r.v, r.bg, r.ba,
                                   tpt, tptv, r.Xw)
    for name, a, b in zip(("kf_q", "kf_p", "kf_v", "kf_bg", "kf_ba", "mp_pos"), tout, jout):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
    assert not np.array_equal(np.asarray(jout[1]), st_np.kf_p)
