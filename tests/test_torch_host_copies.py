"""The port's numpy host copies (io/synthetic.py, eval/metrics.py) against
the JAX package's modules: same ground truth, IMU samples, rendered pixels
and trajectory metrics on seeded inputs."""
import numpy as np
import pytest

from orbslam3_tpu.eval import metrics as jmet
from orbslam3_tpu.io import synthetic as jsyn
from orbslam3_tpu_torch.eval import metrics as tmet
from orbslam3_tpu_torch.io import synthetic as tsyn
from torch_parity import HARD_WORLD, SMALL_WORLD


@pytest.mark.parametrize("texture", ["fiducial", "textured"])
def test_synthetic_world_matches(texture):
    kw = dict(SMALL_WORLD, **dict(HARD_WORLD, texture=texture))
    jw, tw = jsyn.SyntheticWorld(jsyn.SyntheticConfig(**kw)), tsyn.SyntheticWorld(
        tsyn.SyntheticConfig(**kw))
    np.testing.assert_array_equal(tw.frame_times(), jw.frame_times())
    for a, b in zip(tw.gt_trajectory(), jw.gt_trajectory()):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tw.imu_window(0.3, 0.4), jw.imu_window(0.3, 0.4)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tw.render_frame(1.2), jw.render_frame(1.2)):
        np.testing.assert_array_equal(a, b)
    assert tsyn.euroc_t_bc() == jsyn.euroc_t_bc()


@pytest.mark.parametrize("with_rot", [False, True])
def test_metrics_match(with_rot):
    rng = np.random.default_rng(3)
    gt_p = np.cumsum(rng.normal(size=(60, 3)), axis=0)
    est_p = gt_p @ np.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]]).T
    est_p = 1.3 * est_p + rng.normal(scale=0.05, size=est_p.shape) + 2.0
    gt_q = rng.normal(size=(60, 4))
    gt_q /= np.linalg.norm(gt_q, axis=1, keepdims=True)
    est_q = gt_q + rng.normal(scale=0.01, size=gt_q.shape)
    est_q /= np.linalg.norm(est_q, axis=1, keepdims=True)
    for s in (False, True):
        for a, b in zip(tmet.umeyama_align(est_p, gt_p, s), jmet.umeyama_align(est_p, gt_p, s)):
            np.testing.assert_array_equal(a, b)
        assert tmet.ate_rmse(est_p, gt_p, s) == jmet.ate_rmse(est_p, gt_p, s)
    qs = (est_q, gt_q) if with_rot else (None, gt_q)
    assert tmet.rpe_rmse(est_p, gt_p, *qs, delta=10) == jmet.rpe_rmse(est_p, gt_p, *qs, delta=10)
    assert tmet.rpe_rmse(est_p[:5], gt_p[:5], *qs) == jmet.rpe_rmse(est_p[:5], gt_p[:5], *qs)
