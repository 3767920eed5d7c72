"""The port enters the JAX host's service rounds without a loop closer.

The world and configuration of test_torch_vi_slice.py (384x256 at 10 Hz,
use_imu=True), with a 4096-row point array: once the IMU has initialized
and no loop closer runs, a round is due only when the host's upper bounds
on the rows in use reach the capacity margin (max_mp - 2 * new_mp_budget).
The JAX host keeps pessimistic bounds (each frame adds the most rows a frame
can add; a round tightens them from the counts of the round before; a
capacity check sets them to the true counts), so it enters rounds in which
the true counts are far from the margin. The port keeps the same bounds and
enters the same rounds: `_service_round` equals the JAX host's after every
frame, at chunk 1 and at chunk 8."""
import numpy as np
import pytest

from orbslam3_tpu.frontend.orb import OrbConfig as JOrb
from orbslam3_tpu.io.synthetic import SyntheticConfig, SyntheticWorld
from orbslam3_tpu.map.slam_map import MapCapacity as JCap
from orbslam3_tpu.models import fused as jfused
from orbslam3_tpu.models.slam import SlamConfig as JSlamConfig
from orbslam3_tpu.models.tracker import TrackConfig as JTrack
from orbslam3_tpu_torch.frontend.orb import OrbConfig as TOrb
from orbslam3_tpu_torch.map.slam_map import MapCapacity as TCap
from orbslam3_tpu_torch.models import fused as tfused
from orbslam3_tpu_torch.models.slam import SlamConfig as TSlamConfig
from orbslam3_tpu_torch.models.tracker import TrackConfig as TTrack
from test_torch_vi_slice import SMALL, WORLD
from torch_parity import port_camera

MAX_MP = 4096


def _cfg(cfg_cls, orb, cap, track):
    return cfg_cls(orb=orb(n_features=384, n_levels=4),
                   cap=cap(max_kf=64, n_feat=384, max_mp=MAX_MP, max_obs=8),
                   track=track(p_local=2048), **SMALL)


@pytest.fixture(scope="module")
def inputs():
    world = SyntheticWorld(SyntheticConfig(**WORLD))
    times = world.frame_times()[:24]
    out = []
    for i, t in enumerate(times):
        left, right = world.render_frame(t)
        out.append((left, right, *world.imu_window(times[i - 1] if i else t, t), float(t)))
    return world, out


@pytest.mark.parametrize("chunk, service_every, n", [(1, 4, 20), (8, 8, 24)])
def test_service_rounds_equal_jax(inputs, chunk, service_every, n):
    world, frames = inputs
    systems = (("jax", jfused.FusedSlam(world.cam, _cfg(JSlamConfig, JOrb, JCap, JTrack),
                                        service_every=service_every, chunk=chunk)),
               ("torch", tfused.FusedSlam(port_camera(world.cam),
                                          _cfg(TSlamConfig, TOrb, TCap, TTrack),
                                          service_every=service_every, chunk=chunk,
                                          device="cpu")))
    rounds, n_mp = {}, {}
    for name, slam in systems:
        rounds[name], n_mp[name] = [], []
        for args in frames[:n]:
            slam.process_frame(*args)
            rounds[name].append((slam._service_round, bool(slam.imu_initialized)))
            n_mp[name].append(int(slam.map.n_mp))
        slam.finalize()
        rounds[name].append((slam._service_round, bool(slam.imu_initialized)))
    assert rounds["torch"] == rounds["jax"]
    # the case at stake: rounds after the IMU initialized, entered on the
    # bounds while the true point count stayed below the margin
    margin = MAX_MP - 2 * SMALL.get("new_mp_budget", TSlamConfig().new_mp_budget)
    after = [i for i in range(1, n) if rounds["jax"][i - 1][1]
             and rounds["jax"][i][0] > rounds["jax"][i - 1][0]]
    assert after and max(n_mp["torch"][i] for i in after) < margin, (after, n_mp["torch"])
    assert np.all(np.asarray(n_mp["torch"]) < margin)
