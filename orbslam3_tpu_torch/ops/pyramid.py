"""Image pyramid + separable Gaussian blur.

Port of orbslam3_tpu/ops/pyramid.py, written to reproduce the JAX package's
XLA:CPU numbers as closely as float32 allows:

* `resize_bilinear` is `jax.image.resize(..., "bilinear")`: when it shrinks,
  a triangle kernel widened by the scale, half-pixel centres, normalised
  weights. The weight matrices are built in numpy the way XLA evaluates
  `jax.image.scale_and_translate` inside a jitted program (the sample
  position as one fused multiply-add, the division by the kernel scale as a
  multiply by its float32 reciprocal, column sums in runs of 32 rows), and
  are applied rows first, then columns, each output as a fused
  multiply-add chain over its (at most four) taps in input order — the
  order XLA's matrix product takes. A fused multiply-add is emulated by
  forming the product and the sum in float64 and rounding once.
* `blur` is the JAX package's zero-padded separable 7-tap convolution,
  written as seven shifted multiply-adds (the same chain), so no cuDNN
  convolution (and no TF32) is involved.
"""
from __future__ import annotations

import numpy as np
import torch


def level_shapes(h, w, n_levels, scale):
    """Static per-level (h, w) sizes."""
    out = []
    for lv in range(n_levels):
        s = scale**lv
        out.append((int(round(h / s)), int(round(w / s))))
    return out


def gaussian_kernel_1d(sigma, radius):
    x = np.arange(-radius, radius + 1, dtype=np.float32)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return k / k.sum()


def _fma_chain(terms):
    """sum_i w_i * x_i as a chain of fused multiply-adds, in order."""
    acc = None
    for w, x in terms:
        p = w.double() * x.double()
        acc = p if acc is None else p + acc.double()
        acc = acc.float()
    return acc


def blur(img, sigma=2.0, radius=3):
    """Separable Gaussian blur of (..., H, W) images; zero-padded."""
    k = [float(v) for v in gaussian_kernel_1d(sigma, radius)]
    h, w = img.shape[-2:]
    kt = [torch.tensor(v, dtype=torch.float32, device=img.device) for v in k]
    x = torch.nn.functional.pad(img, (0, 0, radius, radius))
    x = _fma_chain((kt[i], x[..., i:i + h, :]) for i in range(2 * radius + 1))
    x = torch.nn.functional.pad(x, (radius, radius))
    return _fma_chain((kt[i], x[..., :, i:i + w]) for i in range(2 * radius + 1))


_TAPS: dict = {}


def _resize_taps_np(m: int, n: int):
    """(n, T) input indices and float32 weights of a length-m -> length-n
    antialiased triangle resample, zero-padded to T taps per output."""
    inv = np.float32(1.0 / (n / m))
    kscale = np.maximum(inv, np.float32(1.0))
    rk = np.float32(1.0) / kscale
    ar = np.arange(n, dtype=np.float32) + np.float32(0.5)
    sample = (ar.astype(np.float64) * np.float64(inv) - 0.5).astype(np.float32)
    x = np.abs(np.abs(sample[None, :] - np.arange(m, dtype=np.float32)[:, None]) * rk)
    wts = np.maximum(np.float32(1.0) - x, np.float32(0.0)).astype(np.float32)
    groups = -(-m // 32)
    total = np.zeros(n, np.float32)
    for g in range(groups):
        part = np.zeros(n, np.float32)
        for i in range(32 * g, min(32 * g + 32, m)):
            part = part + wts[i]
        total = total + part
    safe = np.where(total != 0, total, np.float32(1.0))
    wts = np.where(np.abs(total)[None] > np.float32(1000.0 * np.finfo(np.float32).eps),
                   wts / safe[None], np.float32(0.0))
    inside = (sample >= -0.5) & (sample <= np.float32(m - 0.5))
    wts = np.where(inside[None, :], wts, np.float32(0.0)).astype(np.float32)
    nz = [np.nonzero(wts[:, j])[0] for j in range(n)]
    T = max(max((len(z) for z in nz), default=1), 1)
    idx = np.zeros((n, T), np.int64)
    wt = np.zeros((n, T), np.float32)
    for j, z in enumerate(nz):
        idx[j, : len(z)] = z
        wt[j, : len(z)] = wts[z, j]
    return idx, wt


def _resize_taps(m: int, n: int, device):
    key = (m, n, str(device))
    if key not in _TAPS:
        idx, wt = _resize_taps_np(m, n)
        _TAPS[key] = (torch.from_numpy(idx).to(device), torch.from_numpy(wt).to(device))
    return _TAPS[key]


def _resize_axis(x, n: int, axis: int):
    m = x.shape[axis]
    idx, wt = _resize_taps(m, n, x.device)
    shape = [1] * x.dim()
    shape[axis] = n
    return _fma_chain(
        (wt[:, t].reshape(shape), x.index_select(axis, idx[:, t])) for t in range(idx.shape[1])
    )


def resize_bilinear(img, out_hw):
    """(..., H, W) -> (..., h, w): jax.image.resize(..., "bilinear")."""
    h, w = out_hw
    x = img
    if x.shape[-2] != h:
        x = _resize_axis(x, h, x.dim() - 2)
    if x.shape[-1] != w:
        x = _resize_axis(x, w, x.dim() - 1)
    return x


def build_pyramid(img, n_levels=8, scale=1.2):
    """(..., H, W) float32 images -> tuple of per-level (..., h, w) images.

    Successive resize from the previous level (like OpenCV)."""
    h, w = img.shape[-2:]
    shapes = level_shapes(h, w, n_levels, scale)
    levels = [img]
    for lv in range(1, n_levels):
        levels.append(resize_bilinear(levels[-1], shapes[lv]))
    return tuple(levels)
