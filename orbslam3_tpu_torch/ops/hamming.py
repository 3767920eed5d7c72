"""Hamming distance between binary descriptors as a matrix product.

Port of orbslam3_tpu/ops/hamming.py: d(i, j) = (256 - <u_i, v_j>) / 2 with
u, v in {-1, +1}^256. Sums of 256 terms of +-1 are exact in float32, so
the float32 matmul is exact (TF32 would be too: +-1 is exact in it and the
accumulation is float32)."""
from __future__ import annotations

import torch

from orbslam3_tpu_torch.ops.brief import unpack_pm1


def hamming_matrix(desc_a, desc_b):
    """(Na, 32) u8 x (Nb, 32) u8 -> (Na, Nb) int32 Hamming distances."""
    dot = unpack_pm1(desc_a) @ unpack_pm1(desc_b).transpose(-1, -2)
    return ((256.0 - dot) * 0.5).to(torch.int32)

