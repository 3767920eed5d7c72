"""Torch port of the map and tracking kernels against the JAX package,
starting both from the same MapState (carried across as numpy):
insert_keyframe (the whole MapState), match_local_map,
update_point_counters, pose_optimize, pose_inertial_optimize and
cull_map_points. Ids, masks and counters exact; float32 fields within
1e-5."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam3_tpu.frontend.orb import OrbConfig as JOrb
from orbslam3_tpu.imu import preintegration as jpre
from orbslam3_tpu.io.synthetic import SyntheticConfig, SyntheticWorld
from orbslam3_tpu.map import slam_map as jsm
from orbslam3_tpu.models import fused as jfused
from orbslam3_tpu.models import slam as jslam
from orbslam3_tpu.models import tracker as jtr
from orbslam3_tpu.optim import pose_only as jpo
from orbslam3_tpu_torch.imu import preintegration as tpre
from orbslam3_tpu_torch.interop import from_numpy_tree, to_numpy_tree
from orbslam3_tpu_torch.map import slam_map as tsm
from orbslam3_tpu_torch.models import tracker as ttr
from orbslam3_tpu_torch.optim import pose_only as tpo
from torch_parity import SMALL_WORLD, assert_tree_close, port_camera

CAP = jsm.MapCapacity(max_kf=16, n_feat=384, max_mp=2048, max_obs=8)
CFG = jslam.SlamConfig(orb=JOrb(n_features=384, n_levels=4), cap=CAP, use_imu=False)
TRACK = jtr.TrackConfig(p_local=1024)


@pytest.fixture(scope="module")
def scene():
    world = SyntheticWorld(SyntheticConfig(**SMALL_WORLD))
    fe = jax.jit(jfused._frontend, static_argnames=("cfg",))
    frames = []
    for t in (0.0, 0.1):
        l, r = world.render_frame(t)
        out = fe(jnp.asarray(l.astype(np.uint8)), jnp.asarray(r.astype(np.uint8)), world.cam, cfg=CFG)
        frames.append(jax.tree.map(np.asarray, out))
    poses = [world.gt_pose(t) for t in (0.0, 0.1)]
    return dict(world=world, frames=frames, poses=poses, tcam=port_camera(world.cam))


def _insert_args(frame, pose, matched, prev):
    featL, u_r, depth, has_depth, pts = frame
    q, p = pose
    z3 = np.zeros(3, np.float32)
    return (np.float32(0.1), q, p, z3, z3, z3, featL.uv, u_r, depth, featL.octave, featL.desc,
            pts, featL.valid, matched.astype(np.int32), np.int32(prev))


def _jax_insert(st, args):
    pre0 = jpre.PreintState.identity()
    return jsm.insert_keyframe(st, *[jnp.asarray(a) for a in args[:14]], pre0,
                               jnp.asarray(args[14]), new_mp_budget=CFG.new_mp_budget)


def _torch_insert(st_np, args):
    st = from_numpy_tree(st_np)
    a = [torch.from_numpy(np.array(x)) for x in args]
    return tsm.insert_keyframe(st, *a[:14], tpre.PreintState.identity(), a[14],
                               new_mp_budget=CFG.new_mp_budget)


@pytest.fixture(scope="module")
def maps(scene):
    """st1: the anchor keyframe; st2: a second keyframe tracked against st1."""
    st0 = jax.tree.map(np.asarray, jsm.empty_map(CAP))
    n = CAP.n_feat
    a1 = _insert_args(scene["frames"][0], scene["poses"][0], -np.ones(n), -1)
    st1, k1 = _jax_insert(jax.tree.map(jnp.asarray, st0), a1)
    st1 = jax.tree.map(np.asarray, st1)
    f1 = scene["frames"][1][0]
    q1, p1 = scene["poses"][1]
    m = jtr.match_local_map(jax.tree.map(jnp.asarray, st1), scene["world"].cam, f1.uv, f1.desc,
                            f1.octave, f1.valid, jnp.asarray(q1), jnp.asarray(p1), TRACK)
    m = jax.tree.map(np.asarray, m)
    a2 = _insert_args(scene["frames"][1], scene["poses"][1], m[0], int(k1))
    st2, _ = _jax_insert(jax.tree.map(jnp.asarray, st1), a2)
    return dict(st0=st0, st1=st1, st2=jax.tree.map(np.asarray, st2), a1=a1, a2=a2, match=m)


def test_insert_keyframe_anchor(maps):
    st, k = _torch_insert(maps["st0"], maps["a1"])
    assert int(k) == 0
    assert_tree_close(st, maps["st1"])


def test_insert_keyframe_tracked(maps):
    assert int((maps["match"][0] >= 0).sum()) > 30
    st, k = _torch_insert(maps["st1"], maps["a2"])
    assert int(k) == 1
    assert_tree_close(st, maps["st2"])


def test_match_local_map_and_counters(scene, maps):
    f1 = scene["frames"][1][0]
    q1, p1 = scene["poses"][1]
    st = from_numpy_tree(maps["st1"])
    got = ttr.match_local_map(st, scene["tcam"], *[torch.from_numpy(np.array(x)) for x in (
        f1.uv, f1.desc, f1.octave, f1.valid, q1, p1)], ttr.TrackConfig(p_local=1024))
    want = maps["match"]
    np.testing.assert_array_equal(got[0].numpy(), want[0])
    np.testing.assert_allclose(got[1].numpy(), want[1], rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got[2].numpy(), want[2])
    np.testing.assert_array_equal(got[3].numpy(), want[3])
    inl = (want[0] >= 0) & (np.arange(len(want[0])) % 3 != 0)
    jv = jtr.update_point_counters(maps["st1"].mp_visible, maps["st1"].mp_found, want[2], want[3],
                                   want[0], inl)
    tv = ttr.update_point_counters(st.mp_visible, st.mp_found, got[2], got[3], got[0],
                                   torch.from_numpy(inl))
    for a, b in zip(tv, jv):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _pose_inputs(scene, maps):
    featL, u_r, depth, has_depth, pts = scene["frames"][1]
    matched, mp_w = maps["match"][0], maps["match"][1]
    valid = matched >= 0
    ur = np.where(valid, u_r, -1.0).astype(np.float32)
    q1, p1 = scene["poses"][1]
    # start from a perturbed pose
    dq = np.array([0.9998, 0.01, -0.012, 0.008], np.float32)
    q0 = np.asarray(jnp.asarray(q1)).astype(np.float32)
    from orbslam3_tpu.geometry import quat as jq

    q0 = np.asarray(jq.normalize(jq.mul(jnp.asarray(q0), jnp.asarray(dq / np.linalg.norm(dq)))))
    p0 = (p1 + np.array([0.03, -0.02, 0.04], np.float32)).astype(np.float32)
    return q0, p0, mp_w, featL.uv, ur, featL.octave, valid


def test_pose_optimize(scene, maps):
    q0, p0, mp_w, uv, ur, octv, valid = _pose_inputs(scene, maps)
    j = jpo.pose_optimize(*map(jnp.asarray, (q0, p0)), scene["world"].cam,
                          *map(jnp.asarray, (mp_w, uv, ur, octv, valid)))
    t = tpo.pose_optimize(*[torch.from_numpy(np.array(x)) for x in (q0, p0)], scene["tcam"],
                          *[torch.from_numpy(np.array(x)) for x in (mp_w, uv, ur, octv, valid)])
    np.testing.assert_allclose(t.q.numpy(), np.asarray(j.q), atol=1e-5)
    np.testing.assert_allclose(t.p.numpy(), np.asarray(j.p), atol=1e-5)
    np.testing.assert_array_equal(t.inliers.numpy(), np.asarray(j.inliers))
    assert int(t.n_inliers) == int(j.n_inliers) > 30
    np.testing.assert_allclose(t.chi2.numpy(), np.asarray(j.chi2), rtol=1e-3, atol=1e-3)


def test_pose_inertial_optimize(scene, maps):
    q0, p0, mp_w, uv, ur, octv, valid = _pose_inputs(scene, maps)
    world = scene["world"]
    g, a, d = world.imu_window(0.0, 0.1)
    gp, ap, dp, mp = jpre.pad_imu_window(g, a, d, 32)
    z3 = np.zeros(3, np.float32)
    jpi = jax.tree.map(np.asarray, jax.jit(jpre.integrate_assoc)(gp, ap, dp, mp, z3, z3))
    qk, pk = world.gt_pose(0.0)
    vk = world.gt_velocity(0.0)
    v0 = world.gt_velocity(0.1) + np.float32(0.05)
    grav = np.array([0.0, 0.0, -9.81], np.float32)
    args = (q0, p0, v0, z3, z3)
    rest = (mp_w, uv, ur, octv, valid.astype(np.float32))
    kf = (qk, pk, vk, z3, z3)
    j = jpo.pose_inertial_optimize(*map(jnp.asarray, args), world.cam, *map(jnp.asarray, rest),
                                   jax.tree.map(jnp.asarray, jpi), *map(jnp.asarray, kf),
                                   gravity=jnp.asarray(grav), imu_cap=jnp.float32(30.0))
    tt = lambda x: torch.from_numpy(np.array(x))  # noqa: E731
    t = tpo.pose_inertial_optimize(*map(tt, args), scene["tcam"], *map(tt, rest),
                                   from_numpy_tree(jpi), *map(tt, kf), gravity=tt(grav),
                                   imu_cap=30.0)
    for name, x, y in zip(("q", "p", "v", "bg", "ba"), t[:5], j[:5]):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), atol=1e-5, err_msg=name)
    np.testing.assert_array_equal(t[5].numpy(), np.asarray(j[5]))
    assert int(t[6]) == int(j[6])


def test_cull_map_points(maps):
    st2 = maps["st2"]
    # make a third of the points look badly tracked and age the map
    found = st2.mp_found.copy()
    found[::3] = 0
    vis = st2.mp_visible.copy()
    vis[::3] = 9
    st = st2._replace(mp_found=found, mp_visible=vis, n_kf=np.int32(5))
    j = jax.tree.map(np.asarray, jsm.cull_map_points(jax.tree.map(jnp.asarray, st)))
    assert j.mp_valid.sum() < st2.mp_valid.sum()
    t = tsm.cull_map_points(from_numpy_tree(st))
    assert_tree_close(t, j)
    assert_tree_close(from_numpy_tree(to_numpy_tree(t)), j)
