"""Helpers of the SlamSystem parity tests (test_torch_slam_system*.py): both
packages' SlamSystems on one world and configuration, the JAX one's per-frame
StereoFrames fed to the port's, and the comparison of their maps.

The JAX SlamSystem compiles every eager operation it dispatches; the tests
clear JAX's caches (`clear_jax`) after their runs so that a test worker does
not run out of mappable memory."""
import contextlib
import gc

import jax
import numpy as np
import torch

import chip_smoke
from orbslam3_tpu.frontend.orb import OrbConfig as JOrb
from orbslam3_tpu.io.synthetic import SyntheticConfig, SyntheticWorld, euroc_t_bc
from orbslam3_tpu.map.slam_map import MapCapacity as JCap
from orbslam3_tpu.models import slam as jslam
from orbslam3_tpu.models.tracker import TrackConfig as JTrack
from orbslam3_tpu_torch.frontend.orb import OrbConfig as TOrb
from orbslam3_tpu_torch.frontend.stereo import StereoFrame
from orbslam3_tpu_torch.interop import carry_slam_system, from_numpy_tree
from orbslam3_tpu_torch.map.slam_map import MapCapacity as TCap
from orbslam3_tpu_torch.models import slam as tslam
from orbslam3_tpu_torch.models.tracker import TrackConfig as TTrack
from torch_parity import assert_tree_close, jax_slam_system_state, port_camera

# either package's classes, for chip_smoke.slam_system_world
JPKG = dict(SyntheticConfig=SyntheticConfig, SyntheticWorld=SyntheticWorld,
            euroc_t_bc=euroc_t_bc, SlamConfig=jslam.SlamConfig, OrbConfig=JOrb,
            MapCapacity=JCap, TrackConfig=JTrack)
TPKG = dict(JPKG, SlamConfig=tslam.SlamConfig, OrbConfig=TOrb, MapCapacity=TCap,
            TrackConfig=TTrack)


def configs(name):
    """The JAX and port SlamConfigs of chip_smoke.SLAM_SYSTEM_WORLDS[name]."""
    return chip_smoke.slam_system_world(JPKG, name)[1], chip_smoke.slam_system_world(TPKG, name)[1]


def port_frame(sf):
    """A JAX StereoFrame as the port's, on the CPU."""
    f = lambda x: from_numpy_tree(jax.tree.map(np.asarray, x))  # noqa: E731
    return StereoFrame(feat=f(sf.feat), u_right=f(sf.u_right), depth=f(sf.depth),
                       points_cam=f(sf.points_cam), has_depth=f(sf.has_depth))


@contextlib.contextmanager
def patched(module, name, fn):
    """module.name replaced by fn inside the block."""
    old = getattr(module, name)
    setattr(module, name, fn)
    try:
        yield
    finally:
        setattr(module, name, old)


def clear_jax():
    jax.clear_caches()
    gc.collect()


def jax_run(world, cfg, inputs):
    """The JAX SlamSystem over `inputs`: its per-frame StereoFrames (as the
    port's), its state after every frame, its IMU frame and the system."""
    slam = jslam.SlamSystem(world.cam, cfg)
    frames, states = [], []
    real = jslam.process_stereo

    def recording(*a, **k):
        sf = real(*a, **k)
        frames.append(port_frame(sf))
        return sf

    with patched(jslam, "process_stereo", recording):
        init = chip_smoke.drive_slam_system(
            slam, inputs, hook=lambda i: states.append(jax_slam_system_state(slam)))
    return dict(slam=slam, frames=frames, states=states, init=init)


def port_run(world, cfg, inputs, fed=None, state=None):
    """The port's SlamSystem on the CPU, fed the given StereoFrames in
    order (its own front end without), from a carried state if given."""
    slam = tslam.SlamSystem(port_camera(world.cam), cfg, device="cpu")
    if state is not None:
        vars(slam).update(carry_slam_system(state, "cpu"))
    feed = iter(fed or [])
    patch = (patched(tslam, "process_stereo", lambda *a, **k: next(feed)) if fed is not None
             else contextlib.nullcontext())
    with patch:
        init = chip_smoke.drive_slam_system(slam, inputs)
    return dict(slam=slam, init=init)


POINT_FIELDS = ("mp_pos", "mp_normal", "mp_min_dist", "mp_max_dist")


def assert_map_close(tmap, jmap):
    """Ids and masks exact, keyframe floats within 1e-4; the geometry of
    live points within 1e-4, of live triangulated points (a feature without
    stereo depth at its first keyframe) within 1e-3 relative: their nearly
    parallel rays amplify the keyframe poses' last-bit differences (a few
    1e-6 m after a run) a few hundred times. Dead rows keep stale geometry
    and are not compared."""
    jm = jax.tree.map(np.asarray, jmap)
    hold = {f: getattr(jm, f) for f in POINT_FIELDS}
    assert_tree_close(tmap._replace(**{f: torch.from_numpy(v.copy()) for f, v in hold.items()}),
                      jm, rtol=1e-4, atol=1e-4)
    k0, f0 = jm.mp_obs_kf[:, 0], jm.mp_obs_feat[:, 0]
    tri = (k0 >= 0) & (jm.kf_depth[np.maximum(k0, 0), np.maximum(f0, 0)] <= 0)
    live = jm.mp_valid
    for f, v in hold.items():
        got = getattr(tmap, f).numpy()
        np.testing.assert_allclose(got[live & ~tri], v[live & ~tri], rtol=1e-4, atol=1e-4,
                                   err_msg=f)
        np.testing.assert_allclose(got[live & tri], v[live & tri], rtol=1e-3, atol=1e-4,
                                   err_msg=f)


def records(slam):
    return [(r.state, bool(r.is_keyframe), int(r.n_matches), int(r.n_inliers))
            for r in slam.trajectory]
