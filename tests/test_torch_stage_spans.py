"""FusedSlam's span hook (`trace_spans`, `spans`) off, its default, on the
world and configuration of test_torch_vi_slice.py at chunk 1 and 4: four
frames keep no span, and the "sync_wait" timer still counts every host
sync. test_torch_chunk_slice.py runs its sessions with the hook on and
holds the spans."""
import pytest

from orbslam3_tpu_torch.frontend.orb import OrbConfig
from orbslam3_tpu_torch.io.synthetic import SyntheticConfig, SyntheticWorld
from orbslam3_tpu_torch.map.slam_map import MapCapacity
from orbslam3_tpu_torch.models import fused as tfused
from orbslam3_tpu_torch.models.slam import SlamConfig
from orbslam3_tpu_torch.models.tracker import TrackConfig
from test_torch_vi_slice import SERVICE_EVERY, SMALL, WORLD
from torch_parity import port_camera

FRAMES = 4
CFG = SlamConfig(orb=OrbConfig(n_features=384, n_levels=4),
                 cap=MapCapacity(max_kf=16, n_feat=384, max_mp=8192, max_obs=8),
                 track=TrackConfig(p_local=2048), **SMALL)


@pytest.fixture(scope="module")
def world():
    w = SyntheticWorld(SyntheticConfig(**WORLD))
    times = w.frame_times()[:FRAMES]
    inputs = []
    for i, t in enumerate(times):
        left, right = w.render_frame(t)
        inputs.append((left, right, *w.imu_window(times[i - 1] if i else t, t), float(t)))
    return port_camera(w.cam), inputs


@pytest.mark.parametrize("chunk", [1, 4])
def test_hook_is_off_by_default(world, chunk):
    cam, inputs = world
    slam = tfused.FusedSlam(cam, CFG, chunk=chunk, service_every=SERVICE_EVERY, device="cpu")
    for args in inputs:
        slam.process_frame(*args)
    slam.finalize()
    assert slam.spans is None
    assert slam.timing["step"][1] == FRAMES and slam.timing["sync_wait"][1] == slam.host_syncs
    assert slam.trace_spans(True) == [] and slam.spans == []
    assert slam.trace_spans(False) is None and slam.spans is None
