"""The CUDA FAST/NMS kernel (orbslam3_tpu_torch/csrc/fast_nms.cu) against
its plain PyTorch version, bitwise, at every pyramid-level shape of a
480x752 frame, for the stereo stack (B=2) and a single image (B=1), and
the whole pyramid in one launch (fast_nms_levels), ragged and tiny levels
included, and the 16 images of a chunk of 8 stereo frames (B=16).
Needs an NVIDIA GPU and nvcc: run on the card with
`python -m pytest -m gpu tests/test_torch_kernels_gpu.py`."""
import numpy as np
import pytest
import torch

from orbslam3_tpu_torch.ops.fast_cuda import (MAX_LEVELS, fast_nms, fast_nms_levels,
                                              fast_nms_reference, fast_nms_single)
from orbslam3_tpu_torch.ops.pyramid import level_shapes

pytestmark = pytest.mark.gpu
SHAPES = level_shapes(480, 752, 8, 1.2)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU or interpret mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("hw", SHAPES, ids=[f"{h}x{w}" for h, w in SHAPES])
def test_fast_nms_kernel_bitwise(cuda, hw):
    rng = np.random.default_rng(hw[1])
    imgs = rng.integers(0, 256, (2,) + hw).astype(np.float32)
    imgs[:, : hw[0] // 3, : hw[1] // 4] = 200.0
    x = torch.from_numpy(imgs).to(cuda)
    before = fast_nms.launches
    got = fast_nms(x)
    torch.cuda.synchronize()
    assert fast_nms.launches == before + 1
    want = fast_nms_reference(x)
    assert torch.equal(got, want)
    assert torch.equal(fast_nms_single(x[1]), want[1])
    # non-integer images (the pyramid's upper levels are not integer-valued)
    y = x * 0.731 + 0.37
    assert torch.equal(fast_nms(y), fast_nms_reference(y))


def test_fast_nms_rejects_bad_input(cuda):
    with pytest.raises(ValueError):
        fast_nms(torch.zeros(4, 5, device=cuda))
    with pytest.raises(ValueError):
        fast_nms(torch.zeros(1, 8, 8, dtype=torch.float64, device=cuda))
    with pytest.raises(ValueError):
        fast_nms(torch.zeros(1, 8, 16, device=cuda)[:, :, ::2])


def _levels(rng, shapes, B, cuda, integer=True):
    out = []
    for hw in shapes:
        im = rng.integers(0, 256, (B,) + tuple(hw)).astype(np.float32)
        im[:, : hw[0] // 3, : hw[1] // 4] = 200.0
        if not integer:
            im = im * 0.731 + 0.37
        out.append(torch.from_numpy(im).to(cuda))
    return out


def _check_levels(levels, **thr):
    before = fast_nms.launches
    got = fast_nms_levels(levels, **thr)
    torch.cuda.synchronize()
    assert fast_nms.launches == before + 1
    assert len(got) == len(levels)
    for g, lv in zip(got, levels):
        assert g.shape == lv.shape and g.is_contiguous()
        assert torch.equal(g, fast_nms_reference(lv, **thr)), tuple(lv.shape)


@pytest.mark.parametrize("integer", [True, False], ids=["integer", "non_integer"])
@pytest.mark.parametrize("B", [2, 1, 16])
def test_fast_nms_levels_pyramid_one_launch(cuda, B, integer):
    _check_levels(_levels(np.random.default_rng(3 + B), SHAPES, B, cuda, integer))


def test_fast_nms_levels_chunk_batch_is_image_by_image(cuda):
    """B = 16, the 2C images of a chunk of 8 frames: 18,560 blocks in one
    launch, and every image scored as it is in its own stereo pair (B = 2)."""
    from orbslam3_tpu_torch.ops.fast_cuda import level_table

    levels = _levels(np.random.default_rng(16), SHAPES, 16, cuda, integer=False)
    assert level_table(tuple(SHAPES), 16)[1] == 8 * level_table(tuple(SHAPES), 2)[1] == 18560
    got = fast_nms_levels(levels)
    for p in range(8):
        pair = fast_nms_levels([lv[2 * p:2 * p + 2].contiguous() for lv in levels])
        for g, h in zip(got, pair):
            assert torch.equal(g[2 * p:2 * p + 2], h)


# smaller than the 4-pixel halo, one tile exactly, one pixel over a tile, wide and flat
RAGGED = [(1, 1), (2, 3), (7, 9), (16, 64), (17, 65), (65, 33), (3, 200), (129, 5)]


@pytest.mark.parametrize("B", [1, 2, 3])
def test_fast_nms_levels_ragged_and_tiny(cuda, B):
    _check_levels(_levels(np.random.default_rng(B), RAGGED, B, cuda))
    for hw in RAGGED:  # and each alone, through the one-level entry points
        (x,) = _levels(np.random.default_rng(hw[1]), [hw], B, cuda)
        assert torch.equal(fast_nms(x), fast_nms_reference(x))
        assert torch.equal(fast_nms_single(x[0]), fast_nms_reference(x)[0])


def test_fast_nms_levels_max_levels(cuda):
    rng = np.random.default_rng(16)
    shapes = [(40 + 3 * i, 130 - 7 * i) for i in range(MAX_LEVELS)]
    _check_levels(_levels(rng, shapes, 2, cuda))


def test_fast_nms_levels_unaligned_views(cuda):
    """Levels whose first pixel is not 16-byte aligned (views into a larger
    buffer) take the shifted wide loads."""
    rng = np.random.default_rng(5)
    buf = torch.from_numpy(rng.integers(0, 256, 3 + 2 * 50 * 70).astype(np.float32)).to(cuda)
    levels = [buf[off:off + 2 * 50 * 70].view(2, 50, 70) for off in (1, 2, 3)]
    assert all(lv.data_ptr() % 16 != 0 for lv in levels)
    _check_levels(levels)


@pytest.mark.parametrize("thr", [dict(thr_hi=20.0, thr_lo=7.0), dict(thr_hi=35.5, thr_lo=12.25),
                                 dict(thr_hi=5.0, thr_lo=9.0)],
                         ids=["default", "other", "hi_below_lo"])
def test_fast_nms_levels_thresholds(cuda, thr):
    _check_levels(_levels(np.random.default_rng(9), SHAPES[4:], 2, cuda, integer=False), **thr)


def test_fast_nms_levels_empty_and_cpu(cuda):
    before = fast_nms.launches
    out = fast_nms_levels([torch.zeros(2, 0, 8, device=cuda)])
    assert out[0].shape == (2, 0, 8) and fast_nms.launches == before
    fast_nms_levels([torch.zeros(2, 8, 8)])
    assert fast_nms.launches == before


def test_fast_nms_levels_rejects_bad_input(cuda):
    z = torch.zeros
    for bad in ([z(2, 8, 9, device=cuda), z(1, 8, 9, device=cuda)],
                [z(2, 8, 9, device=cuda), z(2, 8, 9, dtype=torch.float16, device=cuda)],
                [z(1, 4, 4, device=cuda)] * (MAX_LEVELS + 1),
                [z(2, 8, 9, device=cuda), z(2, 8, 9)],
                [z(2, 8, 18, device=cuda)[:, :, ::2]]):
        with pytest.raises(ValueError):
            fast_nms_levels(bad)
