"""Which device the port's entry point picks: FusedSlam runs on the CUDA
card unless the caller asks for another device. Where no card is available
it raises and names the device it wanted; device="cpu" runs on the CPU."""
import numpy as np
import pytest
import torch

from orbslam3_tpu_torch.frontend.orb import OrbConfig
from orbslam3_tpu_torch.io.synthetic import SyntheticConfig, SyntheticWorld
from orbslam3_tpu_torch.loop import vocab as vb
from orbslam3_tpu_torch.map.slam_map import MapCapacity
from orbslam3_tpu_torch.models.fused import MODE_OK, SLICE_CFG, FusedSlam
from orbslam3_tpu_torch.models.tracker import TrackConfig

TINY_WORLD = dict(width=256, height=160, fx=160.0, fy=160.0, n_landmarks=300, duration=0.2,
                  cam_hz=10.0)
TINY_CFG = SLICE_CFG._replace(orb=OrbConfig(n_features=128, n_levels=2),
                              cap=MapCapacity(max_kf=8, n_feat=128, max_mp=1024, max_obs=4),
                              track=TrackConfig(p_local=512), ba_points=512)


@pytest.fixture(scope="module")
def world():
    return SyntheticWorld(SyntheticConfig(**TINY_WORLD))


def test_default_device_is_cuda_and_raises_without_one(world, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        FusedSlam(world.cam, SLICE_CFG)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FusedSlam(world.cam, TINY_CFG, device=None)


@pytest.mark.parametrize("device", ["cpu", torch.device("cpu")], ids=["str", "torch.device"])
def test_explicit_cpu_runs_a_frame(world, device):
    slam = FusedSlam(world.cam, TINY_CFG, device=device)
    assert slam.device == torch.device("cpu") and slam.cam.fx.device.type == "cpu"
    left, right = world.render_frame(0.0)
    out = slam.process_frame(left, right, *world.imu_window(0.0, 0.0), 0.0)
    assert int(out.mode) == MODE_OK and bool(out.is_kf)
    assert out.q.device.type == "cpu"


def test_unported_options_are_refused_before_the_device_is_picked(world, monkeypatch):
    """Nothing is refused any more: loop closing is ported. With a
    vocabulary (with or without `warmup`, at any chunk) and no card,
    FusedSlam raises for the device it wanted before it builds anything; on
    device="cpu" it builds the loop closer, with LoopConfig()'s defaults or
    the given loop_cfg."""
    from orbslam3_tpu_torch.loop.closer import LoopConfig

    voc = vb.train_vocabulary(np.random.default_rng(0).integers(0, 256, (300, 32))
                              .astype(np.uint8), k=4, levels=2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        FusedSlam(world.cam, SLICE_CFG._replace(use_imu=True), vocabulary=voc)
    with pytest.raises(RuntimeError, match="cuda"):
        FusedSlam(world.cam, SLICE_CFG, vocabulary=voc, warmup=True, chunk=8)
    with pytest.raises(RuntimeError, match="cuda"):
        FusedSlam(world.cam, SLICE_CFG, chunk=4)
    cfg = LoopConfig(recent_gap=7)
    slam = FusedSlam(world.cam, TINY_CFG, vocabulary=voc, loop_cfg=cfg, device="cpu")
    assert slam.loop_closer.cfg == cfg and slam.loop_closer.vocab.idf.device.type == "cpu"
    assert FusedSlam(world.cam, TINY_CFG, loop_cfg=cfg, device="cpu").loop_closer is None


def test_bench_signature_constructs(world):
    """The keywords bench.py::run_pipeline passes without a vocabulary."""
    slam = FusedSlam(world.cam, TINY_CFG, service_every=8, chunk=8, vocabulary=None,
                     warmup=False, device="cpu")
    assert slam.chunk == 8 and slam.flush() is None and slam.compactions == 0
    slam.finalize()
    assert slam.frame_outputs() is None and slam.trajectory_arrays()[1].shape == (0, 3)
