"""The port's distributed global BA (torch.distributed) against the JAX
package's mesh version, on test_torch_global_ba.py's grown map.

* gloo groups of 1, 2 and 4 spawned ranks on a localhost store against
  `distributed_global_ba` on 1, 2 and 4 devices of the 8-device CPU mesh
  (tests/conftest.py): poses and points within 1e-4 (the camera system sums
  in another order); every rank's (q, p, Xw) equals every other's bit for
  bit, and one rank equals `global_ba` bit for bit;
* without a process group it raises;
* the loop closer at two ranks sizes its table as the JAX closer does for
  two devices (slots and tile exactly) and lands within 1e-4 of it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from orbslam3_tpu.frontend.camera import Camera
from orbslam3_tpu.loop import closer as jcl
from orbslam3_tpu.loop import vocab as jvb
from orbslam3_tpu.map import slam_map as jsm
from orbslam3_tpu.models import slam as jslam
from orbslam3_tpu.frontend.orb import OrbConfig as JOrb
from orbslam3_tpu.parallel import distributed_ba as jdba
from orbslam3_tpu_torch.interop import from_numpy_tree
from orbslam3_tpu_torch.parallel import distributed_ba as tdba
from orbslam3_tpu_torch.parallel.ranks import gba_rank, run_ranks
from torch_parity import closer_gba_rank, grow_jax_map, port_camera, tensor

CAP = jsm.MapCapacity(max_kf=16, n_feat=384, max_mp=4096, max_obs=8)
CFG = jslam.SlamConfig(orb=JOrb(n_features=384, n_levels=4), cap=CAP)
N_KF = 7
P, TILE, ITERS = 2048, 256, 4
JCAM = Camera.create(240.0, 240.0, 192.0, 128.0, 0.11, 384, 256)
CAM = (240.0, 240.0, 192.0, 128.0, 0.11, 384, 256)


@pytest.fixture(scope="module")
def problem():
    _, st_np = grow_jax_map(N_KF, CAP, CFG)
    r = np.random.default_rng(5)
    q, p = st_np.kf_q.copy(), st_np.kf_p.copy()
    p[1:N_KF] += r.normal(0, 0.03, (N_KF - 1, 3)).astype(np.float32)
    opt = st_np.kf_valid & (np.arange(CAP.max_kf) != 0)
    pts, ids = jdba.make_point_table(st_np, P, 8)
    prob = {f: np.asarray(getattr(pts, f)) for f in jdba.GlobalBAPoints._fields}
    prob.update(q=q, p=p, opt_cam=opt, cam=CAM)
    return st_np, prob, len(ids)


def _jax(prob, n_dev):
    pts = jdba.GlobalBAPoints(*[jnp.asarray(prob[f]) for f in jdba.GlobalBAPoints._fields])
    mesh = Mesh(np.array(jax.devices()[:n_dev]), ("pt",))
    out = jdba.distributed_global_ba(mesh, pts, jnp.asarray(prob["q"]), jnp.asarray(prob["p"]),
                                     jnp.asarray(prob["opt_cam"]), JCAM, iters=ITERS, tile=TILE)
    return [np.asarray(a) for a in out]


@pytest.mark.parametrize("world", [1, 2, 4])
def test_ranks_against_jax_mesh(problem, world):
    _, prob, n = problem
    outs = run_ranks(gba_rank, world, (prob, ITERS, TILE, "cpu"))
    for o in outs[1:]:
        for k in ("q", "p", "Xw"):
            assert np.array_equal(o[k], outs[0][k]), k
    tq, tp, tX = outs[0]["q"], outs[0]["p"], outs[0]["Xw"]
    jq, jp, jX = _jax(prob, world)
    assert np.abs(tp - prob["p"]).max() > 1e-3  # the solve moved the poses
    np.testing.assert_allclose(tp, jp, rtol=0, atol=1e-4)
    np.testing.assert_allclose(tq * np.sign((tq * jq).sum(-1, keepdims=True)), jq, rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(tX[:n], jX[:n], rtol=0, atol=1e-4)
    opt = prob["opt_cam"]
    np.testing.assert_array_equal(tq[~opt], prob["q"][~opt])
    if world == 1:
        pts = tdba.GlobalBAPoints(*[tensor(prob[f]) for f in tdba.GlobalBAPoints._fields])
        gq, gp, gX = tdba.global_ba(pts, tensor(prob["q"]), tensor(prob["p"]),
                                    tensor(prob["opt_cam"]), port_camera(JCAM), iters=ITERS,
                                    tile=TILE)
        for a, b in ((tq, gq), (tp, gp), (tX, gX)):
            assert np.array_equal(a, b.numpy())


def test_without_a_group_it_raises(problem):
    _, prob, _ = problem
    pts = tdba.GlobalBAPoints(*[tensor(prob[f]) for f in tdba.GlobalBAPoints._fields])
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        tdba.distributed_global_ba(pts, tensor(prob["q"]), tensor(prob["p"]),
                                   tensor(prob["opt_cam"]), port_camera(JCAM))


def test_closer_table_at_two_ranks(problem, monkeypatch):
    st_np, prob, _ = problem
    st_np = st_np._replace(kf_p=prob["p"])
    loop_kw = dict(gba_max_points=3000, gba_tile=512, gba_iters=3)
    seen = {}
    table, solve, devices = jdba.make_point_table, jdba.distributed_global_ba, jax.devices

    def spy_table(st, max_points, max_obs):
        seen["slots"] = max_points
        return table(st, max_points, max_obs)

    def spy_solve(mesh, pts, *a, tile=0, **k):
        seen["tile"], seen["devices"] = tile, mesh.devices.size
        return solve(mesh, pts, *a, tile=tile, **k)

    monkeypatch.setattr(jdba, "make_point_table", spy_table)
    monkeypatch.setattr(jdba, "distributed_global_ba", spy_solve)
    monkeypatch.setattr(jax, "devices", lambda *a: devices(*a)[:2])
    voc = jvb.train_vocabulary(np.random.default_rng(0).integers(0, 256, (200, 32))
                               .astype(np.uint8), k=4, levels=2)
    jst = jcl.LoopCloser(voc, jcl.LoopConfig(**loop_kw))._global_ba(
        jax.tree.map(jnp.asarray, st_np), 0, JCAM)
    outs = run_ranks(closer_gba_rank, 2, (from_numpy_tree(st_np), loop_kw, CAM))
    assert seen["devices"] == 2
    for o in outs:
        rec = o["rec"]
        assert rec["ranks"] == 2 and rec["iters"] == 3
        assert rec["slots"] == seen["slots"] == 3072
        assert rec["slots"] // rec["tiles"] == seen["tile"] == 512
    for k in ("kf_q", "kf_p", "mp_pos"):
        assert np.array_equal(outs[1][k], outs[0][k]), k
    np.testing.assert_allclose(outs[0]["kf_p"], np.asarray(jst.kf_p), rtol=0, atol=1e-4)
    np.testing.assert_allclose(outs[0]["mp_pos"], np.asarray(jst.mp_pos), rtol=0, atol=1e-4)
    assert np.abs(outs[0]["kf_p"] - prob["p"]).max() > 1e-3
