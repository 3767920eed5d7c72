"""The lower-precision control on the card: the program with every float32
matrix product in TF32 fails the check, and the same run in full float32
passes. At a size a test run holds (the tests' CPU-sized configuration
on the card); the cells' own readings are in PERF.md."""
import pytest

from conftest import tiny
from slambench.harness import run_cell


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [11, 12, 13])
def test_tf32_control_fails_and_float32_passes(seed, cuda_device, tmp_path):
    import torch

    res = tiny("tiny_vi", "cold")
    sound = run_cell("tiny", seed, 5.0, False, resolved=res, device=cuda_device,
                     cache_dir=tmp_path, workers=1)
    ctl = run_cell("tiny", seed, 5.0, False, resolved=res, device=cuda_device,
                   cache_dir=tmp_path, workers=1, control="tf32")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    assert sound["correct"], sound["checks"]
    assert not ctl["correct"], ctl["checks"]
    assert ctl["checks"]["fe_mismatch"]["value"] > 0.0
