"""Image pyramid + separable Gaussian blur.

Port of orbslam3_tpu/ops/pyramid.py, written to reproduce the JAX package's
XLA:CPU numbers as closely as float32 allows:

* `resize_bilinear` is `jax.image.resize(..., "bilinear")`: when it shrinks,
  a triangle kernel widened by the scale, half-pixel centres, normalised
  weights. The weight matrices are built in numpy the way XLA evaluates
  `jax.image.scale_and_translate` inside a jitted program (see
  `_resize_weights_np`: which columns take a fused multiply-add where, and
  the padded runs of 32 rows the column sums add), and are applied rows
  first, then columns, each output as a fused multiply-add chain over its
  (at most four) taps in input order. A fused multiply-add is emulated by
  forming the product and the sum in float64 and rounding once. (XLA's
  runtime matrix product sums the taps in an order of its own at some
  shapes, so levels past the first still differ in part of their pixels.)
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


def _fma_np(a, b, c):
    """float32 fused multiply-add: product and sum in float64, one rounding."""
    return (np.float64(a) * np.float64(b) + np.float64(c)).astype(np.float32)


def _resize_weights_np(m: int, n: int):
    """(m, n) float32 weights of a length-m -> length-n antialiased triangle
    resample, bit for bit as XLA:CPU's compiled `jax.image.resize` builds
    them (jaxlib 0.9, x86-64 with FMA).

    XLA builds the matrix in two loop fusions, and LLVM compiles each output
    column one of two ways. Where the column loop runs at run time, the
    sample position is one fused multiply-add and the weight is
    `1 - round(|s - i| * rk)`; where LLVM unrolled the loop and folded the
    sample position to a constant (two roundings), the weight is one fused
    multiply-add `1 - |s - i| * rk`. The fusion that sums the weights runs
    columns in blocks of 32 and is unrolled whole when it has at most 10
    such blocks; a tail past the last block is folded. The fusion that
    divides by the sum runs blocks of 16, is unrolled whole at up to 5
    blocks, and folds the last n % 8 columns. The column sums add runs of 32
    rows in order, the runs placed over the rows padded by half the padding
    to a multiple of 32 on each side, then the runs in order."""
    f32 = np.float32
    inv = f32(1.0 / (n / m))
    rk = f32(1.0) / np.maximum(inv, f32(1.0))
    ar = np.arange(n, dtype=f32) + f32(0.5)
    s_run = _fma_np(ar, inv, f32(-0.5))
    s_fold = (ar * inv).astype(f32) + f32(-0.5)
    rows = np.arange(m, dtype=f32)[:, None]

    def w_run(s):
        return np.maximum(f32(1.0) - np.abs(s[None, :] - rows) * rk, f32(0.0))

    def w_fold(s):
        return np.maximum(_fma_np(-np.abs(s[None, :] - rows), rk, f32(1.0)), f32(0.0))

    j = np.arange(n)
    run_sum = j < (32 * (n // 32) if n // 32 > 10 else 0)
    run_div = j < (8 * (n // 8) if n // 16 > 5 else 0)
    w_sum = np.where(run_sum[None, :], w_run(s_run), w_fold(s_fold))
    sample = np.where(run_div, s_run, s_fold)
    wts = np.where(run_div[None, :], w_run(s_run), w_fold(s_fold))
    groups = -(-m // 32)
    lo = (32 * groups - m) // 2
    total = np.zeros(n, f32)
    for g in range(groups):
        part = np.zeros(n, f32)
        for i in range(max(32 * g - lo, 0), min(32 * g + 32 - lo, m)):
            part = part + w_sum[i]
        total = total + part
    safe = np.where(total != 0, total, f32(1.0))
    wts = np.where(np.abs(total)[None] > f32(1000.0 * np.finfo(np.float32).eps),
                   wts / safe[None], f32(0.0))
    inside = (sample >= -0.5) & (sample <= f32(m - 0.5))
    return np.where(inside[None, :], wts, f32(0.0)).astype(f32)


def _resize_taps_np(m: int, n: int):
    """(n, T) input indices and float32 weights of a length-m -> length-n
    antialiased triangle resample, zero-padded to T taps per output."""
    wts = _resize_weights_np(m, n)
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
