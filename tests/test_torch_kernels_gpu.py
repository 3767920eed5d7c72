"""The CUDA FAST/NMS kernel (orbslam3_tpu_torch/csrc/fast_nms.cu) against
its plain PyTorch version, bitwise, at every pyramid-level shape of a
480x752 frame, for the stereo stack (B=2) and a single image (B=1).
Needs an NVIDIA GPU and nvcc: run on the card with
`python -m pytest -m gpu tests/test_torch_kernels_gpu.py`."""
import numpy as np
import pytest
import torch

from orbslam3_tpu_torch.ops.fast_cuda import fast_nms, fast_nms_reference, fast_nms_single
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
