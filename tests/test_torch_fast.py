"""Torch port of the FAST/NMS path: the plain version of the CUDA kernel
(fast_nms_reference) is bitwise equal to the JAX package's
nms3x3(max(fast_score(., 20), 1e-3 * fast_score(., 7))) over the whole
image, at every pyramid-level shape of a 480x752 frame, on the stereo stack
(B=2); select_keypoints keeps the JAX package's tie order exactly."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam3_tpu.ops import fast as jf
from orbslam3_tpu.ops.pyramid import level_shapes
from orbslam3_tpu_torch.ops import fast as tf
from orbslam3_tpu_torch.ops.fast_cuda import fast_nms, fast_nms_reference, fast_nms_single

SHAPES = level_shapes(480, 752, 8, 1.2)


@jax.jit
def _jax_fast_nms(imgs):
    def one(im):
        return jf.nms3x3(jnp.maximum(jf.fast_score(im, 20.0), jf.fast_score(im, 7.0) * 1e-3))

    return jax.vmap(one)(imgs)


@pytest.mark.parametrize("hw", SHAPES, ids=[f"{h}x{w}" for h, w in SHAPES])
def test_fast_nms_reference_bitwise(hw):
    rng = np.random.default_rng(hw[0])
    imgs = rng.integers(0, 256, (2,) + hw).astype(np.float32)
    # flat regions and steps so corners hit the image border too
    imgs[:, : hw[0] // 3, : hw[1] // 4] = 200.0
    want = np.asarray(_jax_fast_nms(jnp.asarray(imgs)))
    got = fast_nms_reference(torch.from_numpy(imgs)).numpy()
    np.testing.assert_array_equal(got, want)
    # the CPU path of the wrapper is the reference
    before = fast_nms.launches
    np.testing.assert_array_equal(fast_nms(torch.from_numpy(imgs)).numpy(), want)
    np.testing.assert_array_equal(fast_nms_single(torch.from_numpy(imgs[1])).numpy(), want[1])
    assert fast_nms.launches == before  # no kernel launch on the CPU


@pytest.mark.parametrize("cell,k_cell,n_out", [(32, 6, 600), (8, 4, 64), (27, 6, 300), (16, 2, 40)])
def test_select_keypoints_ties(cell, k_cell, n_out):
    rng = np.random.default_rng(cell)
    # few distinct values: ties everywhere, including across cells
    score = rng.choice(np.array([0.0, 0.0, 0.0, 5.0, 7.0, 7.0, 21.0], np.float32), size=(120, 150))
    jy, jx, jv = jf.select_keypoints(jnp.asarray(score), cell=cell, k_cell=k_cell, n_out=n_out)
    ty, tx, tv = tf.select_keypoints(torch.from_numpy(score), cell=cell, k_cell=k_cell, n_out=n_out)
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_mask_border():
    s = np.random.default_rng(0).uniform(0, 5, (40, 50)).astype(np.float32)
    np.testing.assert_array_equal(tf.mask_border(torch.from_numpy(s), 7).numpy(),
                                  np.asarray(jf.mask_border(jnp.asarray(s), 7)))
