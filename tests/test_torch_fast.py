"""Torch port of the FAST/NMS path: the plain version of the CUDA kernel
(fast_nms_reference) is bitwise equal to the JAX package's
nms3x3(max(fast_score(., 20), 1e-3 * fast_score(., 7))) over the whole
image, at every pyramid-level shape of a 480x752 frame, on the stereo stack
(B=2); fast_nms_levels, the front end's one call a frame, gives the same a
level and builds a launch grid that covers every pixel of every level once;
select_keypoints keeps the JAX package's tie order exactly."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam3_tpu.ops import fast as jf
from orbslam3_tpu.ops.pyramid import level_shapes
from orbslam3_tpu_torch.ops import fast as tf
from orbslam3_tpu_torch.ops.fast_cuda import (MAX_LEVELS, TILE_X, TILE_Y, fast_nms,
                                              fast_nms_levels, fast_nms_reference,
                                              fast_nms_single, level_table, locate_tile)

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


def test_fast_nms_levels_bitwise():
    """The whole pyramid in one call: each level equals the JAX package's
    score map bit for bit, and a CPU call launches no kernel."""
    rng = np.random.default_rng(11)
    imgs = [rng.integers(0, 256, (2,) + hw).astype(np.float32) for hw in SHAPES]
    for im, hw in zip(imgs, SHAPES):
        im[:, hw[0] // 2:, : hw[1] // 3] = 31.0
    before = fast_nms.launches
    got = fast_nms_levels([torch.from_numpy(im) for im in imgs])
    assert fast_nms.launches == before
    assert len(got) == len(SHAPES)
    for g, im in zip(got, imgs):
        np.testing.assert_array_equal(g.numpy(), np.asarray(_jax_fast_nms(jnp.asarray(im))))
    assert fast_nms_levels([]) == []


def _bad_levels(kind):
    z = torch.zeros
    return {
        "mixed_B": [z(2, 8, 9), z(1, 7, 8)],
        "float64": [z(2, 8, 9), z(2, 7, 8, dtype=torch.float64)],
        "uint8": [z(2, 8, 9, dtype=torch.uint8)],
        "too_many": [z(1, 4, 4)] * (MAX_LEVELS + 1),
        "rank": [z(8, 9)],
        "strided": [z(2, 8, 18)[:, :, ::2]],
    }[kind]


@pytest.mark.parametrize("kind", ["mixed_B", "float64", "uint8", "too_many", "rank", "strided"])
def test_fast_nms_levels_rejects(kind):
    with pytest.raises(ValueError):
        fast_nms_levels(_bad_levels(kind))


def test_fast_nms_levels_takes_max_levels():
    out = fast_nms_levels([torch.zeros(1, 9, 9)] * MAX_LEVELS)
    assert len(out) == MAX_LEVELS and all(o.shape == (1, 9, 9) for o in out)


RAGGED = [(1, 1), (7, 9), (65, 33), (16, 64), (17, 65), (3, 200)]
GRIDS = ([("bench", SHAPES), ("ragged", RAGGED), ("mixed", RAGGED[:3] + SHAPES[5:] + RAGGED[3:])]
         + [(f"{h}x{w}", [(h, w)]) for h, w in SHAPES + RAGGED])


@pytest.mark.parametrize("B", [1, 2])
@pytest.mark.parametrize("shapes", [g[1] for g in GRIDS], ids=[g[0] for g in GRIDS])
def test_level_table_covers_every_pixel_once(shapes, B):
    """Walking the launch's flat tile indices as the kernel does reaches
    every output pixel of every level and image exactly once."""
    table, total = level_table(tuple(map(tuple, shapes)), B)
    firsts = [row[3] for row in table]
    assert firsts[0] == 0 and all(a < b for a, b in zip(firsts, firsts[1:] + [total]))
    assert [row[:2] for row in table] == list(map(tuple, shapes))
    hits = [np.zeros((B,) + tuple(hw), np.int32) for hw in shapes]
    for flat in range(total):
        lv, b, ty, tx = locate_tile(table, flat)
        H, W, tiles_x, _ = table[lv]
        assert 0 <= b < B and tx < tiles_x and ty * TILE_Y < H and tx * TILE_X < W
        hits[lv][b, ty * TILE_Y:(ty + 1) * TILE_Y, tx * TILE_X:(tx + 1) * TILE_X] += 1
    for h in hits:
        assert h.min() == 1 and h.max() == 1


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
