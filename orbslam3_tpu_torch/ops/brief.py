"""Oriented BRIEF descriptors + intensity-centroid orientation, batched.

Port of orbslam3_tpu/ops/brief.py. The pattern and moment constants are
recomputed from the same seed and formulas. The JAX package samples the
rotated pattern through a bfloat16 one-hot matmul, so every sampled
intensity is bfloat16-rounded before the `<` test; here the samples are
gathered and rounded to bfloat16 the same way (the gather itself is exact).
"""
from __future__ import annotations

import numpy as np
import torch

PATCH = 31  # descriptor patch diameter (level pixels)
HALF = PATCH // 2
ORI_RADIUS = 15  # intensity-centroid radius
GATHER = 37  # gather radius: rotated pattern points reach sqrt(2)*HALF
GHALF = GATHER // 2

_rng = np.random.default_rng(42)
# BRIEF pattern: 256 (p, q) pairs ~ N(0, (PATCH/5)^2), clipped to the patch.
_pat = np.clip(_rng.normal(0.0, PATCH / 5.0, size=(256, 2, 2)), -HALF, HALF)
BRIEF_PATTERN = _pat.astype(np.float32)  # (256, 2 points, (x, y)), numpy

_yy, _xx = np.mgrid[-ORI_RADIUS: ORI_RADIUS + 1, -ORI_RADIUS: ORI_RADIUS + 1]
_circ = (_yy**2 + _xx**2) <= ORI_RADIUS**2
ORI_MASK = _circ.astype(np.float32)  # (31, 31)
ORI_X = (_xx * _circ).astype(np.float32)
ORI_Y = (_yy * _circ).astype(np.float32)


def gather_patches(img, ys, xs, size: int):
    """size x size patches centered at integer (ys, xs).

    img (B, H, W); ys, xs (B, N) -> (B, N, size, size). Corners are clamped
    so every patch lies inside the image."""
    B, h, w = img.shape
    half = size // 2
    y0 = torch.clamp(ys.long() - half, 0, h - size)
    x0 = torch.clamp(xs.long() - half, 0, w - size)
    ar = torch.arange(size, device=img.device)
    rows = y0[..., None] + ar  # (B, N, S)
    cols = x0[..., None] + ar
    base = (torch.arange(B, device=img.device) * (h * w))[:, None, None, None]
    flat = base + rows[..., :, None] * w + cols[..., None, :]
    return img.reshape(-1)[flat]


_MOMENT_W: dict = {}


def _moment_weights(S):
    """(S*S, 2) moment weight matrix embedding the 31x31 circular mask."""
    off = (S - (2 * ORI_RADIUS + 1)) // 2
    W = np.zeros((S, S, 2), np.float32)
    W[off: off + 31, off: off + 31, 0] = ORI_X
    W[off: off + 31, off: off + 31, 1] = ORI_Y
    return W.reshape(S * S, 2)


def orientations_from_patches(patches):
    """Intensity-centroid angles (..., N) from (..., N, S, S) patches, S >= 31."""
    S = patches.shape[-1]
    key = (S, str(patches.device))
    if key not in _MOMENT_W:
        _MOMENT_W[key] = torch.from_numpy(_moment_weights(S)).to(patches.device)
    flat = patches.reshape(patches.shape[:-2] + (S * S,))
    if flat.dim() == 3:
        # a matrix product's order of summation depends on its row count, so
        # a batch goes two images (one stereo pair) at a time, a lone image
        # beside a copy of itself: every image then gets the bits it gets in
        # a batch of two
        B = flat.shape[0]
        if B % 2:
            flat = torch.cat([flat, flat[-1:]])
        m = torch.cat([g @ _MOMENT_W[key] for g in flat.split(2)])[:B]
    else:
        m = flat @ _MOMENT_W[key]
    return torch.atan2(m[..., 1], m[..., 0])


def orientations(img, ys, xs):
    """Intensity-centroid angle per keypoint of one (H, W) image at
    integer (N,) ys, xs: atan2(m01, m10), (N,) radians."""
    patches = gather_patches(img[None], ys[None], xs[None], 2 * ORI_RADIUS + 1)
    return orientations_from_patches(patches)[0]


def descriptors(img, ys, xs, angles):
    """Steered BRIEF of one (H, W) image (pre-blurred, sigma ~2) at integer
    (N,) ys, xs with (N,) angles: (N, 32) uint8 packed descriptors."""
    return descriptors_from_patches(gather_patches(img[None], ys[None], xs[None], GATHER),
                                    angles[None])[0]


def descriptors_from_patches(patches, angles):
    """Steered BRIEF from (..., N, G, G) patches -> (..., N, 32) uint8.

    Rotated pattern points are sampled nearest-neighbour."""
    dev = patches.device
    ca = torch.cos(angles)[..., None, None]
    sa = torch.sin(angles)[..., None, None]
    pat = torch.from_numpy(BRIEF_PATTERN).to(dev)
    px, py = pat[..., 0], pat[..., 1]  # (256, 2)
    rx = ca * px - sa * py  # (..., N, 256, 2)
    ry = sa * px + ca * py
    ix = torch.clamp(torch.round(rx).long() + GHALF, 0, GATHER - 1)
    iy = torch.clamp(torch.round(ry).long() + GHALF, 0, GATHER - 1)
    pb = patches.to(torch.bfloat16).to(torch.float32)
    lead = pb.shape[:-2]
    flat = pb.reshape(lead + (GATHER * GATHER,))
    vals = torch.gather(flat, -1, (iy * GATHER + ix).reshape(lead + (512,)))
    vals = vals.reshape(lead + (256, 2))
    bits = (vals[..., 0] < vals[..., 1]).to(torch.uint8)
    return pack_bits(bits)


def pack_bits(bits):
    """(..., 256) {0,1} -> (..., 32) uint8, LSB-first within each byte."""
    b = bits.reshape(bits.shape[:-1] + (32, 8)).to(torch.int32)
    weights = (1 << torch.arange(8, device=bits.device, dtype=torch.int32))
    return torch.sum(b * weights, dim=-1).to(torch.uint8)


def unpack_bits(desc):
    """(..., 32) uint8 -> (..., 256) {0,1} uint8, LSB-first."""
    shifts = torch.arange(8, device=desc.device, dtype=torch.uint8)
    b = (desc[..., None] >> shifts) & 1
    return b.reshape(desc.shape[:-1] + (256,))


def unpack_pm1(desc):
    """(..., 32) uint8 -> (..., 256) float32 in {-1, +1}."""
    return unpack_bits(desc).to(torch.float32) * 2.0 - 1.0
