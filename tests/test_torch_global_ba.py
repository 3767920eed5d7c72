"""Torch port of the whole-map bundle adjustment against the JAX package.

* make_point_table on a map grown from the small world: every column of
  the point-major table and the selected map-point rows exact, under the
  budget and over it (the most-observed points kept, ties to the lower
  row), and with few observation slots (every stride-th view kept);
* global_ba against distributed_global_ba on a one-device mesh and on the
  8-device CPU mesh: poses and points within 1e-4 (the camera system sums
  in another order: tile by tile here, block pairs per point in place of
  the dense (tile, 6K, 3) stack); several tiles against one tile within
  1e-4 as well (a point seen from nearby keyframes is poorly conditioned
  along its ray); two runs bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from orbslam3_tpu.frontend.orb import OrbConfig as JOrb
from orbslam3_tpu.map import slam_map as jsm
from orbslam3_tpu.models import slam as jslam
from orbslam3_tpu.parallel import distributed_ba as jdba
from orbslam3_tpu_torch.interop import from_numpy_tree
from orbslam3_tpu_torch.parallel import distributed_ba as tdba
from torch_parity import grow_jax_map, port_camera, tensor

CAP = jsm.MapCapacity(max_kf=16, n_feat=384, max_mp=4096, max_obs=8)
CFG = jslam.SlamConfig(orb=JOrb(n_features=384, n_levels=4), cap=CAP)
N_KF = 7


@pytest.fixture(scope="module")
def grown():
    return grow_jax_map(N_KF, CAP, CFG)


@pytest.mark.parametrize("max_points,max_obs", [(4096, 8), (512, 8), (300, 3), (4200, 2)],
                         ids=["all", "over-budget", "over-budget-strided", "past-capacity"])
def test_make_point_table(grown, max_points, max_obs):
    _, st_np = grown
    j_pts, j_ids = jdba.make_point_table(st_np, max_points, max_obs)
    t_pts, t_ids = tdba.make_point_table(from_numpy_tree(st_np), max_points, max_obs)
    assert type(t_pts).__name__ == "GlobalBAPoints"
    n = len(j_ids)
    assert n > 0 and (n < int(st_np.mp_valid.sum())) == (max_points < int(st_np.mp_valid.sum()))
    np.testing.assert_array_equal(t_ids[:n].numpy(), j_ids)
    assert (t_ids[n:] == -1).all()
    for name in t_pts._fields:
        got, want = getattr(t_pts, name).numpy(), np.asarray(getattr(j_pts, name))
        assert got.dtype == want.dtype and got.shape == want.shape, name
        np.testing.assert_array_equal(got, want, err_msg=name)


def _problem(st_np):
    """The grown map with its poses pulled a few cm off (keyframe 0 is the
    gauge anchor), and both packages' table of it."""
    r = np.random.default_rng(5)
    q = st_np.kf_q.copy()
    p = st_np.kf_p.copy()
    p[1:N_KF] += r.normal(0, 0.03, (N_KF - 1, 3)).astype(np.float32)
    opt = st_np.kf_valid & (np.arange(CAP.max_kf) != 0)
    return q, p, opt


def _jax_gba(st_np, q, p, opt, n_dev, P, tile, iters=4):
    pts, ids = jdba.make_point_table(st_np, P, 8)
    mesh = Mesh(np.array(jax.devices()[:n_dev]), ("pt",))
    from orbslam3_tpu.frontend.camera import Camera

    cam = Camera.create(240.0, 240.0, 192.0, 128.0, 0.11, 384, 256)
    out = jdba.distributed_global_ba(mesh, pts, jnp.asarray(q), jnp.asarray(p), jnp.asarray(opt),
                                     cam, iters=iters, tile=tile)
    return [np.asarray(a) for a in out], ids, cam


def _torch_gba(st_np, q, p, opt, jcam, P, tile, iters=4):
    pts, ids = tdba.make_point_table(from_numpy_tree(st_np), P, 8)
    out = tdba.global_ba(pts, tensor(q), tensor(p), tensor(opt), port_camera(jcam), iters=iters,
                         tile=tile)
    return [a.numpy() for a in out], ids


@pytest.mark.parametrize("n_dev,tile", [(1, 0), (1, 1024), (8, 256)],
                         ids=["one-device", "one-device-tiled", "eight-devices"])
def test_global_ba_against_jax(grown, n_dev, tile):
    _, st_np = grown
    q, p, opt = _problem(st_np)
    P = 2048
    (jq, jp, jX), j_ids, jcam = _jax_gba(st_np, q, p, opt, n_dev, P, tile)
    (tq, tp, tX), t_ids = _torch_gba(st_np, q, p, opt, jcam, P, 512)
    n = len(j_ids)
    assert np.abs(tp - p).max() > 1e-3  # the solve moved the poses
    np.testing.assert_allclose(tp, jp, rtol=0, atol=1e-4)
    np.testing.assert_allclose(tq * np.sign((tq * jq).sum(-1, keepdims=True)), jq, rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(tX[:n], jX[:n], rtol=0, atol=1e-4)
    np.testing.assert_array_equal(tq[~opt], q[~opt])


def test_global_ba_tiles_and_repeat(grown):
    _, st_np = grown
    q, p, opt = _problem(st_np)
    from orbslam3_tpu.frontend.camera import Camera

    jcam = Camera.create(240.0, 240.0, 192.0, 128.0, 0.11, 384, 256)
    one, _ = _torch_gba(st_np, q, p, opt, jcam, 2048, 0)
    tiled, _ = _torch_gba(st_np, q, p, opt, jcam, 2048, 256)
    again, _ = _torch_gba(st_np, q, p, opt, jcam, 2048, 256)
    for a, b in zip(one, tiled):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4)
    for a, b in zip(tiled, again):
        assert torch.equal(torch.from_numpy(a), torch.from_numpy(b))
