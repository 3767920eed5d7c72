"""Shared helpers of the torch-port parity tests (test_torch_*.py)."""
import numpy as np
import torch

from orbslam3_tpu_torch.frontend.camera import Camera as TCamera

# The port's eager steps are thousands of small ops: more intra-op threads
# gain nothing at these sizes, and several test workers on one machine, each
# with a full thread pool spinning at its barriers, slow each other many-fold.
torch.set_num_threads(1)

# bench.py::HARD_WORLD
HARD_WORLD = dict(texture="textured", exposure_drift=0.3, image_noise_std=3.0,
                  salt_pepper_frac=0.002, motion_blur_samples=3, exposure_time=0.02)
# the small world of tests/test_fused.py, 20 frames at 10 Hz
SMALL_WORLD = dict(width=384, height=256, fx=240.0, fy=240.0, n_landmarks=600, duration=2.0,
                   cam_hz=10.0, pos_amp=(1.2, 0.8, 0.3))


def tensor(x):
    """numpy (or JAX array) -> CPU tensor, copied."""
    return torch.from_numpy(np.array(x))


def port_camera(jcam):
    """The port's Camera with the JAX camera's intrinsics."""
    return TCamera.create(float(jcam.fx), float(jcam.fy), float(jcam.cx), float(jcam.cy),
                          float(jcam.bf / jcam.fx), jcam.width, jcam.height)


def assert_tree_close(t, j, rtol=1e-5, atol=1e-5, path="state"):
    """Port tree (tensors) vs JAX tree (numpy): same dtypes and shapes,
    exact for integer/bool leaves, rtol/atol for float32 leaves."""
    if hasattr(j, "_fields"):
        assert t._fields == j._fields, path
        for f in j._fields:
            assert_tree_close(getattr(t, f), getattr(j, f), rtol, atol, f"{path}.{f}")
        return
    tv = t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    jv = np.asarray(j)
    assert tv.dtype == jv.dtype and tv.shape == jv.shape, (path, tv.dtype, jv.dtype, tv.shape,
                                                           jv.shape)
    if jv.dtype.kind == "f":
        np.testing.assert_allclose(tv, jv, rtol=rtol, atol=atol, err_msg=path)
    else:
        np.testing.assert_array_equal(tv, jv, err_msg=path)


def grow_jax_map(n_kf, cap, cfg, p_local=1024, seed=0):
    """A JAX MapState (as numpy) of `n_kf` keyframes of the small world,
    inserted at ground-truth poses perturbed by a few cm, each tracked
    against the map so far, chained by kf_prev and carrying the
    preintegrated IMU window since its predecessor and the true velocity.
    Returns (world, MapState of numpy arrays)."""
    import jax
    import jax.numpy as jnp

    from orbslam3_tpu.imu import preintegration as jpre
    from orbslam3_tpu.io.synthetic import SyntheticConfig, SyntheticWorld
    from orbslam3_tpu.map import slam_map as jsm
    from orbslam3_tpu.models import fused as jfused
    from orbslam3_tpu.models import tracker as jtr

    world = SyntheticWorld(SyntheticConfig(**SMALL_WORLD))
    fe = jax.jit(jfused._frontend, static_argnames=("cfg",))
    integrate = jax.jit(jpre.integrate_assoc)
    rng = np.random.default_rng(seed)
    st = jsm.empty_map(cap)
    z3 = jnp.zeros(3)
    for i in range(n_kf):
        t = 0.1 * i
        l, r = world.render_frame(t)
        featL, u_r, depth, has_depth, pts = fe(jnp.asarray(l.astype(np.uint8)),
                                               jnp.asarray(r.astype(np.uint8)), world.cam, cfg=cfg)
        q, p = world.gt_pose(t)
        p = p + rng.normal(0, 0.02, 3).astype(np.float32) * (i > 0)
        if i == 0:
            matched = -jnp.ones(cap.n_feat, jnp.int32)
            preint = jpre.PreintState.identity()
        else:
            matched = jtr.match_local_map(st, world.cam, featL.uv, featL.desc, featL.octave,
                                          featL.valid, jnp.asarray(q), jnp.asarray(p),
                                          jtr.TrackConfig(p_local=p_local))[0]
            preint = integrate(*jpre.pad_imu_window(*world.imu_window(t - 0.1, t), 32), z3, z3)
        st, _ = jsm.insert_keyframe(st, jnp.float32(t), jnp.asarray(q), jnp.asarray(p),
                                    jnp.asarray(world.gt_velocity(t)), z3, z3,
                                    featL.uv, u_r, depth, featL.octave, featL.desc, pts,
                                    featL.valid, matched, preint, jnp.int32(i - 1),
                                    new_mp_budget=cfg.new_mp_budget)
    return world, jax.tree.map(np.asarray, st)


def record_loop_services(slam, log: list):
    """Record the loop closer's service sequence of a FusedSlam of either
    package into `log`, by wrapping the closer's methods on the instance:
    ("kf", service round, keyframe, multi_map, reloc, steady) for each
    keyframe serviced, ("packet", keyframe) for each detection packet acted
    on, ("verify", keyframe, corrected) for each verification consumed, and
    ("correct", keyframe, candidate, merge) for each correction."""
    cl = slam.loop_closer
    on_kf, proc = cl.on_keyframe, cl._process_packet
    apply_v, correct = cl._apply_verify, cl._correct

    def on_keyframe(st, kf_id, cam, multi_map=True, round_id=-1, reloc=False, steady=False):
        log.append(("kf", int(round_id), int(kf_id), bool(multi_map), bool(reloc), bool(steady)))
        return on_kf(st, kf_id, cam, multi_map=multi_map, round_id=round_id, reloc=reloc,
                     steady=steady)

    def process_packet(st, kf_id, *a, **k):
        log.append(("packet", int(kf_id)))
        return proc(st, kf_id, *a, **k)

    def apply_verify(st, cam, *a, **k):
        pending = cl._verify_pending
        st, corrected = apply_v(st, cam, *a, **k)
        if pending is not None and cl._verify_pending is None:
            log.append(("verify", int(pending[1]), bool(corrected)))
        return st, corrected

    def correct_(st, kf_id, cand, *a, **k):
        log.append(("correct", int(kf_id), int(cand), bool(cl.last_was_merge)))
        return correct(st, kf_id, cand, *a, **k)

    cl.on_keyframe, cl._process_packet = on_keyframe, process_packet
    cl._apply_verify, cl._correct = apply_verify, correct_
    return log


def closer_gba_rank(rank, world, st, loop_kw: dict, cam: tuple, anchor: int = 0):
    """One rank of the port loop closer's whole-map BA (`LoopCloser._global_ba`)
    on the port MapState `st` inside a process group of `world` ranks
    (parallel/ranks.py::run_ranks). Returns the closer's table record and
    the refined poses and points as numpy."""
    import numpy as np
    import torch

    from orbslam3_tpu_torch.frontend.camera import Camera
    from orbslam3_tpu_torch.loop import closer as tcl
    from orbslam3_tpu_torch.loop import vocab as tvb

    torch.set_num_threads(1)
    voc = tvb.train_vocabulary(np.random.default_rng(0).integers(0, 256, (200, 32))
                               .astype(np.uint8), k=4, levels=2)
    closer = tcl.LoopCloser(voc, tcl.LoopConfig(**loop_kw))
    out, rec = closer._global_ba(st, anchor, Camera.create(*cam))
    return dict(rec={k: rec[k] for k in ("slots", "tiles", "iters", "ranks")},
                kf_q=out.kf_q.numpy(), kf_p=out.kf_p.numpy(), mp_pos=out.mp_pos.numpy())


def jax_slam_system_state(slam) -> dict:
    """A JAX SlamSystem's state, arrays as numpy and lists copied, in the
    form interop.carry_slam_system takes."""
    import jax

    from orbslam3_tpu_torch.interop import SLAM_SYSTEM_STATE

    def host(x):
        return None if x is None else np.array(x)

    out = {}
    for k in SLAM_SYSTEM_STATE:
        v = getattr(slam, k, 0)
        if k == "map":
            v = jax.tree.map(np.asarray, v)
        elif k in ("_kf_gyro", "_kf_acc", "_kf_dts"):
            v = [np.array(a) for a in v]
        elif k == "trajectory":
            v = list(v)
        elif k in ("q", "p", "v", "bg", "ba", "motion_dq", "motion_dp", "gravity_w"):
            v = host(v)
        out[k] = v
    return out
