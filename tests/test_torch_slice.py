"""The port's main path end to end against the JAX package: both
FusedSlams run the stereo slice (SLICE_CFG) over the small world of
tests/test_fused.py (384x256, 4 levels, 384 features, 20 frames at 10 Hz)
on the same rendered frames and IMU windows.

Per-frame tracking mode exact; keyframe decisions and feature counts exact
over the first 5 frames; after that a rare descriptor bit flip (see
test_torch_frontend.py) can move one inlier count across the keyframe
policy's gate, so the final keyframe count may differ by 2. Trajectories
agree within 5 mm, and the port's own ATE stays under 5 cm (the JAX
package gives 0.024 m here)."""
import numpy as np
import pytest
import torch

from orbslam3_tpu.frontend.orb import OrbConfig as JOrb
from orbslam3_tpu.io.synthetic import SyntheticConfig, SyntheticWorld
from orbslam3_tpu.map.slam_map import MapCapacity as JCap
from orbslam3_tpu.models import fused as jfused
from orbslam3_tpu.models.slam import SlamConfig as JSlamConfig
from orbslam3_tpu.models.tracker import TrackConfig as JTrack
from orbslam3_tpu_torch.eval.metrics import ate_rmse
from orbslam3_tpu_torch.frontend.orb import OrbConfig as TOrb
from orbslam3_tpu_torch.map.slam_map import MapCapacity as TCap
from orbslam3_tpu_torch.models import fused as tfused
from orbslam3_tpu_torch.models.tracker import TrackConfig as TTrack
from torch_parity import SMALL_WORLD, port_camera

SLICE_FLAGS = dict(use_imu=False, ransac_fallback=False, triangulate_mono=False,
                   fuse_neighbors=False, update_point_stats=False, kf_cull_redundancy=0.0)
SMALL = dict(ba_points=1024, kf_max_frames=2)


@pytest.fixture(scope="module")
def runs():
    world = SyntheticWorld(SyntheticConfig(**SMALL_WORLD))
    times = world.frame_times()
    inputs = []
    for i, t in enumerate(times):
        left, right = world.render_frame(t)
        inputs.append((left, right, *world.imu_window(times[i - 1] if i else t, t), float(t)))

    jcfg = JSlamConfig(orb=JOrb(n_features=384, n_levels=4),
                       cap=JCap(max_kf=64, n_feat=384, max_mp=8192, max_obs=8),
                       track=JTrack(p_local=2048), **SMALL, **SLICE_FLAGS)
    tcfg = tfused.SLICE_CFG._replace(orb=TOrb(n_features=384, n_levels=4),
                                     cap=TCap(max_kf=64, n_feat=384, max_mp=8192, max_obs=8),
                                     track=TTrack(p_local=2048), **SMALL)
    out = {}
    for name, slam in (("jax", jfused.FusedSlam(world.cam, jcfg, service_every=4)),
                       ("torch", tfused.FusedSlam(port_camera(world.cam), tcfg, service_every=4,
                                                 device="cpu"))):
        for args in inputs:
            slam.process_frame(*args)
        slam.finalize()
        _, ps, _ = slam.trajectory_arrays()
        if name == "jax":  # a list of per-frame FrameOuts
            outs = jfused.FrameOut(*[np.stack(f) for f in zip(*slam._flat_outs()[1])])
        else:  # one FrameOut of stacked arrays
            outs = slam._flat_outs()[1]
        out[name] = dict(ps=ps, outs=outs, n_kf=int(slam.map.n_kf), modes=slam.modes())
    out["gt"] = world.gt_trajectory()[0]
    return out


def test_slice_modes_and_keyframes(runs):
    j, t = runs["jax"], runs["torch"]
    np.testing.assert_array_equal(t["modes"], j["modes"])
    np.testing.assert_array_equal(t["outs"].is_kf[:5], j["outs"].is_kf[:5])
    np.testing.assert_array_equal(t["outs"].n_features[:5], j["outs"].n_features[:5])
    assert abs(t["n_kf"] - j["n_kf"]) <= 2, (t["n_kf"], j["n_kf"])


def test_slice_trajectory(runs):
    j, t = runs["jax"], runs["torch"]
    assert t["ps"].shape == j["ps"].shape == (20, 3) and t["ps"].dtype == np.float32
    np.testing.assert_allclose(t["ps"], j["ps"], rtol=0, atol=5e-3)
    ate = ate_rmse(t["ps"], runs["gt"][: len(t["ps"])])
    ok_frac = float((t["modes"] == tfused.MODE_OK).mean())
    assert ate < 0.05 and ok_frac > 0.9, (ate, ok_frac)


@pytest.mark.parametrize("kwargs", [dict(), dict(chunk=4, loop_cfg="given")],
                         ids=["vocabulary", "chunk"])
def test_slice_refuses_unported_wrapper_options(kwargs):
    """Nothing is refused any more: with a vocabulary, at chunk 1 and at
    chunk 4, FusedSlam builds a loop closer with LoopConfig()'s defaults or
    the given loop_cfg; chunked dispatch alone has none."""
    from orbslam3_tpu_torch.loop import vocab as tvb
    from orbslam3_tpu_torch.loop.closer import LoopConfig

    cam = port_camera(SyntheticWorld(SyntheticConfig(**SMALL_WORLD)).cam)
    voc = tvb.train_vocabulary(np.random.default_rng(0).integers(0, 256, (300, 32))
                               .astype(np.uint8), k=4, levels=2)
    given = LoopConfig(consistency_needed=2, run_global_ba=False)
    if kwargs.get("loop_cfg"):
        kwargs = dict(kwargs, loop_cfg=given)
    slam = tfused.FusedSlam(cam, tfused.SLICE_CFG, device="cpu", vocabulary=voc, **kwargs)
    assert slam.loop_closer.cfg == (given if "loop_cfg" in kwargs else LoopConfig())
    assert slam.chunk == kwargs.get("chunk", 1) and slam.loop_closer.stats.corrected == 0
    assert tfused.FusedSlam(cam, tfused.SLICE_CFG, device="cpu", chunk=4).loop_closer is None


def test_slice_refuses_compaction():
    """A map whose true row count reaches the compaction margin does not
    run on into a full array, and no longer raises: its dead rows are
    reclaimed, with one read for the counts and one for the pass."""
    cam = port_camera(SyntheticWorld(SyntheticConfig(**SMALL_WORLD)).cam)
    cfg = tfused.SLICE_CFG._replace(cap=TCap(max_kf=8, n_feat=64, max_mp=1024, max_obs=4))
    slam = tfused.FusedSlam(cam, cfg, device="cpu")
    slam.map = slam.map._replace(n_kf=torch.tensor(5, dtype=torch.int32))
    slam._kf_ub = 5
    slam._maybe_compact()
    assert slam.compactions == 1 and slam.host_syncs == 2
    assert int(slam.map.n_kf) == slam._n_kf == slam._kf_ub == 0  # no row of the 5 was live
    slam._maybe_compact()  # nothing is due any more: no read
    assert slam.compactions == 1 and slam.host_syncs == 2


def test_perturb_frames():
    """The sensor-noise draws chip_smoke.py holds the port to: a fixed
    fraction of pixels moves by one gray level, the same way every time."""
    from orbslam3_tpu_torch.io.synthetic import perturb_frames

    rng = np.random.default_rng(0)
    frames = [tuple(rng.integers(0, 256, (64, 96), dtype=np.uint8) for _ in range(2))
              for _ in range(3)]
    a, b = perturb_frames(frames, 5, frac=0.01), perturb_frames(frames, 5, frac=0.01)
    for fa, fb, f0 in zip(a, b, frames):
        for x, y, x0 in zip(fa, fb, f0):
            np.testing.assert_array_equal(x, y)
            d = x.astype(int) - x0.astype(int)
            assert x.dtype == np.uint8 and np.abs(d).max() <= 1
            assert 0 < (d != 0).mean() <= 0.02
