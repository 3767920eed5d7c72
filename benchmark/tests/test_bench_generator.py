"""The frozen generator and the plain front end against the program's own
(CPU), and the traffic's draws from the seed."""
import json
import os

import numpy as np
import pytest
import torch

from slambench import synthetic as frozen
from slambench import traffic

HERE = os.path.dirname(os.path.abspath(__file__))
HARD = dict(texture="textured", exposure_drift=0.3, image_noise_std=3.0,
            salt_pepper_frac=0.002, motion_blur_samples=3, exposure_time=0.02)


def _worlds(**kw):
    from orbslam3_tpu_torch.io import synthetic as port

    q, p = frozen.euroc_t_bc()
    assert np.allclose(q, port.euroc_t_bc()[0]) and np.allclose(p, port.euroc_t_bc()[1])
    args = dict(duration=2.0, q_bc=q, p_bc=p, **kw)
    return frozen.SyntheticWorld(frozen.SyntheticConfig(**args)), \
        port.SyntheticWorld(port.SyntheticConfig(**args))


@pytest.mark.parametrize("t", [0.0, 0.35, 1.2])
def test_frozen_frames_equal_the_program_generator(t):
    a, b = _worlds(width=376, height=240, fx=229.0, fy=229.0, **HARD)
    for x, y in zip(a.render_frame(t), b.render_frame(t)):
        assert np.array_equal(x, y)


def test_frozen_imu_and_ground_truth_equal_the_program_generator():
    a, b = _worlds(seed=3)
    for t0, t1 in ((0.0, 0.05), (0.95, 1.0)):
        for x, y in zip(a.imu_window(t0, t1), b.imu_window(t0, t1)):
            assert np.array_equal(x, y)
    for t in (0.0, 1.5):
        for x, y in zip(a.gt_pose(t), b.gt_pose(t)):
            assert np.array_equal(x, y)


def test_plain_front_end_equals_the_program_front_end():
    """The check's reference front end, frozen in the benchmark, equals the
    program's front end (on the CPU both run plain PyTorch) at full width."""
    from orbslam3_tpu_torch.models.fused import _frontend
    from orbslam3_tpu_torch.models.slam import SlamConfig
    from slambench.reference import frontend as ref
    from slambench.systems import camera

    torch.set_num_threads(2)
    a, _ = _worlds(**HARD)
    left, right = (torch.from_numpy(x.astype(np.uint8)) for x in a.render_frame(0.5))
    cfg = SlamConfig(kf_max_frames=6)
    cam = camera({"camera": {"fx": 458.0, "fy": 458.0, "width": 752, "height": 480,
                             "baseline": 0.11}}, a)
    featL, u_r, *_ = _frontend(left, right, cam, cfg)
    fl, ur = ref.detect_and_match(left, right, 0.11 * 458.0, ref.OrbConfig(), ref.StereoConfig())
    for k in ("uv", "octave", "desc", "valid"):
        assert torch.equal(getattr(featL, k), getattr(fl, k)), k
    assert torch.equal(u_r, ur)


def _tiny_cfg():
    with open(os.path.join(HERE, "data", "tiny_vi.json")) as f:
        cfg = json.load(f)
    cfg["n_frames"] = 12
    return cfg


def test_traffic_same_seed_same_inputs(render_cache):
    cfg = _tiny_cfg()
    tr = {"imu_noise": True, "pixel_noise_frac": 0.001}
    big = 2**31 + 977
    a = traffic.build(cfg, tr, big, render_cache, workers=1, log=lambda m: None)[0]
    b = traffic.build(cfg, tr, big, render_cache, workers=1, log=lambda m: None)[0]
    c = traffic.build(cfg, tr, big + 1, render_cache, workers=1, log=lambda m: None)[0]
    assert np.array_equal(a.frames, b.frames)
    assert all(np.array_equal(x[0], y[0]) for x, y in zip(a.imu, b.imu))
    assert not np.array_equal(a.frames, c.frames)
    # every seed the same frames, sizes and IMU counts
    assert a.frames.shape == c.frames.shape
    assert [len(x[0]) for x in a.imu] == [len(x[0]) for x in c.imu]
    assert len(a.imu[0][0]) == 0 and len(a.imu[1][0]) == 10
    # the draw moves about frac of the pixels by one gray level
    clean = traffic.build(cfg, {}, big, render_cache, workers=1, log=lambda m: None)[0]
    d = a.frames.astype(int) - clean.frames.astype(int)
    assert np.abs(d).max() == 1
    assert 0.0005 < np.mean(d != 0) < 0.0011


def test_traffic_imu_windows_equal_the_world_windows(render_cache):
    cfg = _tiny_cfg()
    s = traffic.build(cfg, {}, 1, render_cache, workers=1, log=lambda m: None)[0]
    for i in (0, 1, 5, 11):
        t0 = s.times[i - 1] if i else s.times[0]
        for x, y in zip(s.imu[i], s.world.imu_window(t0, s.times[i])):
            assert np.array_equal(x, y)
