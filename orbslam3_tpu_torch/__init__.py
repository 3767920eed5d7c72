"""orbslam3_tpu_torch — the stereo SLAM engine of `orbslam3_tpu`, in PyTorch.

A port of the JAX package beside it for one NVIDIA H100: the same
fixed-capacity structure-of-arrays map, the same configs and defaults and
the same per-frame outputs. Module paths mirror the JAX package
(`orbslam3_tpu/x/y.py` -> `orbslam3_tpu_torch/x/y.py`). Every tensor is
float32/int32/bool/uint8 as in the JAX package (which runs with x64 off),
and every function takes its device from its inputs; the entry points that
pick a device (`FusedSlam`, `FusedSlam.from_state`, `load_map`) pick the CUDA
card unless told otherwise (`default_device`).

The FAST-16-9 + NMS kernel is hand-written CUDA (csrc/fast_nms.cu, bound in
ops/fast_cuda.py, one launch a frame over all pyramid levels); everything
else is plain PyTorch. A CPU tensor takes
each kernel's plain PyTorch version, a CUDA tensor the kernel.

This package never imports JAX or `orbslam3_tpu`.
"""
import torch

__version__ = "0.1.0"


def default_device(device=None) -> torch.device:
    """`device`, or the CUDA card when it is None; a RuntimeError where
    there is no card (the caller passes device="cpu" to run on the CPU)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "orbslam3_tpu_torch runs on device 'cuda' by default and no CUDA device is "
                "available (torch.cuda.is_available() is False); pass device='cpu' "
                "to run on the CPU")
        device = "cuda"
    return torch.device(device)


def set_full_precision() -> None:
    """Full float32 for every matrix product and convolution on the card.

    The JAX package pins precision="highest" for its geometry and solver
    math (orbslam3_tpu/utils/precision.py). PyTorch's matmul default is
    already full float32, but cuDNN convolutions default to TF32; both are
    pinned here. (The port's blur is written as shifted multiply-adds and
    runs no convolution.)"""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
