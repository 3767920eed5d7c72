"""FAST-16 corner detection + grid-constrained keypoint selection.

Port of orbslam3_tpu/ops/fast.py. `fast_score`/`nms3x3` are the plain
PyTorch formulation; the fused two-threshold score + NMS that the front end
runs is ops/fast_cuda.py::fast_nms_levels (a CUDA kernel on the card).

Every image function takes a leading batch: (..., H, W).
`lax.top_k` keeps the lower index among equal values; the selections here
use a stable descending sort so ties break the same way.
"""
from __future__ import annotations

import numpy as np
import torch

# 16-pixel Bresenham circle of radius 3, clockwise from 12 o'clock, (dy, dx).
CIRCLE = np.array(
    [
        (-3, 0), (-3, 1), (-2, 2), (-1, 3),
        (0, 3), (1, 3), (2, 2), (3, 1),
        (3, 0), (3, -1), (2, -2), (1, -3),
        (0, -3), (-1, -3), (-2, -2), (-3, -1),
    ],
    dtype=np.int32,
)


def _shift2d(img, dy, dx):
    """out[..., y, x] = img[..., y + dy, x + dx] with edges replicated."""
    h, w = img.shape[-2:]
    ys = torch.clamp(torch.arange(h, device=img.device) + dy, 0, h - 1)
    xs = torch.clamp(torch.arange(w, device=img.device) + dx, 0, w - 1)
    return img[..., ys, :][..., :, xs]


def _seg9(bits):
    """Any run of >= 9 consecutive set bits on the 16-bit circle."""
    acc = bits
    for k in range(1, 9):
        acc = acc & (((bits << k) | (bits >> (16 - k))) & 0xFFFF)
    return acc != 0


def fast_score(img, threshold: float):
    """FAST-16-9 response of (..., H, W) float32 images; 0 where no corner.

    The SAD terms accumulate one ring pixel at a time in CIRCLE order."""
    thr = float(threshold)
    bright = torch.zeros(img.shape, dtype=torch.int32, device=img.device)
    dark = torch.zeros_like(bright)
    sad_b = torch.zeros_like(img)
    sad_d = torch.zeros_like(img)
    for i, (dy, dx) in enumerate(CIRCLE):
        diff = _shift2d(img, int(dy), int(dx)) - img
        bright = bright | ((diff > thr).to(torch.int32) << i)
        dark = dark | ((diff < -thr).to(torch.int32) << i)
        sad_b = sad_b + torch.clamp(diff - thr, min=0.0)
        sad_d = sad_d + torch.clamp(-diff - thr, min=0.0)
    corner = _seg9(bright) | _seg9(dark)
    return torch.where(corner, torch.maximum(sad_b, sad_d), torch.zeros_like(img))


def nms3x3(score):
    """3x3 non-maximum suppression of (..., H, W): keep score >= all 8
    neighbours (the window is padded with -inf)."""
    shp = score.shape
    s = score.reshape((-1, 1) + tuple(shp[-2:]))
    mx = torch.nn.functional.max_pool2d(s, 3, stride=1, padding=1).reshape(shp)
    return torch.where(score >= mx, score, torch.zeros_like(score))


def mask_border(score, border: int, valid_h: int | None = None, valid_w: int | None = None):
    """Zero scores within `border` px of the (valid) image edge."""
    h, w = score.shape[-2:]
    vh = valid_h if valid_h is not None else h
    vw = valid_w if valid_w is not None else w
    ys = torch.arange(h, device=score.device)
    xs = torch.arange(w, device=score.device)
    my = (ys >= border) & (ys < vh - border)
    mx = (xs >= border) & (xs < vw - border)
    return score * (my[:, None] & mx[None, :]).to(score.dtype)


def corner_subpix(img, ys, xs, win: int = 4):
    """Gradient-based corner localization (cornerSubPix-style), batched.

    img (B, H, W); ys, xs (B, N). Returns (dy, dx) offsets (B, N) from the
    integer keypoint, clamped to +-win."""
    from orbslam3_tpu_torch.ops.brief import gather_patches

    size = 2 * win + 3
    P = gather_patches(img, ys, xs, size)  # (B, N, S, S)
    gx = 0.5 * (P[..., 1:-1, 2:] - P[..., 1:-1, :-2])
    gy = 0.5 * (P[..., 2:, 1:-1] - P[..., :-2, 1:-1])
    r = torch.arange(-win, win + 1, dtype=torch.float32, device=img.device)
    Y, X = torch.meshgrid(r, r, indexing="ij")
    w = torch.exp(-(X**2 + Y**2) / (2.0 * (win / 1.5) ** 2))

    def ssum(a):
        return torch.sum(a, dim=(-2, -1))

    gxx = ssum(w * gx * gx)
    gxy = ssum(w * gx * gy)
    gyy = ssum(w * gy * gy)
    bx = ssum(w * (gx * gx * X + gx * gy * Y))
    by = ssum(w * (gx * gy * X + gy * gy * Y))
    det = gxx * gyy - gxy * gxy
    ok = torch.abs(det) > 1e-6
    det_safe = torch.where(ok, det, torch.full_like(det, 1e-6))
    dx = (gyy * bx - gxy * by) / det_safe
    dy = (gxx * by - gxy * bx) / det_safe
    zero = torch.zeros_like(dx)
    dx = torch.where(ok, torch.clamp(dx, -win, win), zero)
    dy = torch.where(ok, torch.clamp(dy, -win, win), zero)
    return dy, dx


def subpixel_refine(score, ys, xs):
    """Quadratic (parabola) sub-pixel peak refinement on one (H, W) score
    map at integer (N,) peaks: (dy, dx) offsets in [-0.5, 0.5]."""
    h, w = score.shape
    y0 = torch.clamp(ys.long(), 1, h - 2)
    x0 = torch.clamp(xs.long(), 1, w - 2)
    c = score[y0, x0]
    left = score[y0, x0 - 1]
    right = score[y0, x0 + 1]
    up = score[y0 - 1, x0]
    down = score[y0 + 1, x0]

    def para(m, c_, p):
        denom = m - 2.0 * c_ + p
        safe = torch.where(torch.abs(denom) > 1e-6, denom, torch.full_like(denom, 1e-6))
        return torch.clamp(0.5 * (m - p) / safe, -0.5, 0.5)

    return para(up, c, down), para(left, c, right)


def topk_stable(x, k: int, dim: int = -1):
    """(values, indices) of the k largest along `dim`; equal values keep the
    lower index first (lax.top_k's order)."""
    v, i = torch.sort(x, dim=dim, descending=True, stable=True)
    return v.narrow(dim, 0, k), i.narrow(dim, 0, k)


def select_keypoints(score, cell: int = 32, k_cell: int = 4, n_out: int = 256):
    """Spatially-distributed top-k selection with fixed output shape.

    score (..., H, W). Per cell of `cell`x`cell` px keep the k_cell best
    responses, then the global top n_out among those candidates. Returns
    (ys, xs, scores), each (..., n_out); invalid slots have score 0."""
    lead = score.shape[:-2]
    h, w = score.shape[-2:]
    ph = (-h) % cell
    pw = (-w) % cell
    s = torch.nn.functional.pad(score, (0, pw, 0, ph))
    hh, ww = h + ph, w + pw
    gy, gx = hh // cell, ww // cell
    cells = (s.reshape(lead + (gy, cell, gx, cell)).transpose(-3, -2)
             .reshape(lead + (gy * gx, cell * cell)))
    cv, ci = topk_stable(cells, k_cell)  # (..., ncells, k_cell)
    dev = score.device
    cy = torch.arange(gy, device=dev).repeat_interleave(gx)[:, None]
    cx = torch.arange(gx, device=dev).repeat(gy)[:, None]
    ys = cy * cell + ci // cell
    xs = cx * cell + ci % cell
    flat_v = cv.reshape(lead + (-1,))
    flat_y = ys.reshape(lead + (-1,))
    flat_x = xs.reshape(lead + (-1,))
    k = min(n_out, flat_v.shape[-1])
    top_v, top_i = topk_stable(flat_v, k)
    out_y = torch.gather(flat_y, -1, top_i)
    out_x = torch.gather(flat_x, -1, top_i)
    if k < n_out:
        pad = n_out - k
        top_v = torch.nn.functional.pad(top_v, (0, pad))
        out_y = torch.nn.functional.pad(out_y, (0, pad))
        out_x = torch.nn.functional.pad(out_x, (0, pad))
    return out_y.to(torch.int32), out_x.to(torch.int32), top_v
