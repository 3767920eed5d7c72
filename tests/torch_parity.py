"""Shared helpers of the torch-port parity tests (test_torch_*.py)."""
import numpy as np
import torch

from orbslam3_tpu_torch.frontend.camera import Camera as TCamera

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
