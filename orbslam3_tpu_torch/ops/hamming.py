"""Hamming distance between binary descriptors as a matrix product.

Port of orbslam3_tpu/ops/hamming.py: d(i, j) = (256 - <u_i, v_j>) / 2 with
u, v in {-1, +1}^256. Sums of 256 terms of +-1 are exact in float32, so
the float32 matmul is exact (TF32 would be too: +-1 is exact in it and the
accumulation is float32). `hamming_matrix_popcount` and `hamming_pairs`
count the set bits of the XOR through a 256-entry table."""
from __future__ import annotations

import torch

from orbslam3_tpu_torch.ops.brief import unpack_pm1


def hamming_matrix(desc_a, desc_b):
    """(Na, 32) u8 x (Nb, 32) u8 -> (Na, Nb) int32 Hamming distances."""
    dot = unpack_pm1(desc_a) @ unpack_pm1(desc_b).transpose(-1, -2)
    return ((256.0 - dot) * 0.5).to(torch.int32)



_POPCOUNT: dict = {}


def _popcount_u8(x):
    """Set bits of each uint8 of x, as int32."""
    key = str(x.device)
    if key not in _POPCOUNT:
        table = [bin(i).count("1") for i in range(256)]
        _POPCOUNT[key] = torch.tensor(table, dtype=torch.int32, device=x.device)
    return _POPCOUNT[key][x.long()]


def hamming_matrix_popcount(desc_a, desc_b):
    """(Na, 32) u8 x (Nb, 32) u8 -> (Na, Nb) int32, by XOR and popcount."""
    return _popcount_u8(desc_a[:, None, :] ^ desc_b[None, :, :]).sum(-1, dtype=torch.int32)


def hamming_pairs(desc_a, desc_b):
    """Row-wise distance between aligned descriptor arrays: (N, 32) x 2 ->
    (N,) int32."""
    return _popcount_u8(desc_a ^ desc_b).sum(-1, dtype=torch.int32)
