"""The plain front end that decides the benchmark's front-end check.

A frozen copy, in plain PyTorch, of the program's front end as it stood
when the benchmark was written (orbslam3_tpu_torch/ops/fast.py,
ops/pyramid.py, ops/brief.py, ops/hamming.py, frontend/orb.py,
frontend/stereo.py): FAST-16-9 at two thresholds with 3x3 non-maximum
suppression (the function the program's CUDA kernel computes), grid top-k
selection, corner refinement, intensity-centroid orientation, steered
BRIEF, and the epipolar stereo match. It imports nothing of the program and
takes nothing the program made: the caller hands it the same uint8 images
the program was fed.

`detect_and_match(left_u8, right_u8, bf, orb_cfg, stereo_cfg)` returns the
left image's features and each one's right-image u, as the program stores
them in a keyframe's row (kf_uv, kf_octave, kf_desc, kf_feat_valid,
kf_ur). Every float32 matrix product here is full float32 unless the caller
turns TF32 on, which is how the check's lower-precision control is made.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


# ---- FAST (ops/fast.py)
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


# ---- pyramid (ops/pyramid.py)
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


# ---- BRIEF (ops/brief.py, ops/hamming.py)
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


def unpack_pm1(desc):
    """(..., 32) uint8 -> (..., 256) float32 in {-1, +1}, LSB-first."""
    shifts = torch.arange(8, device=desc.device, dtype=torch.uint8)
    b = (desc[..., None] >> shifts) & 1
    return b.reshape(desc.shape[:-1] + (256,)).to(torch.float32) * 2.0 - 1.0


def hamming_matrix(desc_a, desc_b):
    """(..., Na, 32) u8 x (..., Nb, 32) u8 -> (..., Na, Nb) int32 Hamming
    distances: (256 - <u, v>) / 2 with u, v in {-1, +1}^256 (exact)."""
    dot = unpack_pm1(desc_a) @ unpack_pm1(desc_b).transpose(-1, -2)
    return ((256.0 - dot) * 0.5).to(torch.int32)


# ---- ORB (frontend/orb.py)
class OrbConfig(NamedTuple):
    n_features: int = 1024
    n_levels: int = 8
    scale_factor: float = 1.2
    fast_threshold: float = 20.0
    fast_threshold_min: float = 7.0
    cell: int = 32
    k_cell: int = 6


class Features(NamedTuple):
    """Fixed-capacity feature set for one image (padded, mask-validated).
    Batched callers carry a leading batch axis on every field."""

    uv: torch.Tensor  # (N, 2) level-0 pixel coords (u=x, v=y)
    response: torch.Tensor  # (N,)
    octave: torch.Tensor  # (N,) int32 pyramid level
    angle: torch.Tensor  # (N,) radians
    desc: torch.Tensor  # (N, 32) uint8 packed BRIEF
    valid: torch.Tensor  # (N,) bool

    @property
    def n(self):
        return self.uv.shape[-2]


def level_quotas(cfg: OrbConfig):
    """Static per-level feature quotas, area-proportional (sums to n_features)."""
    inv = [1.0 / (cfg.scale_factor ** (2 * lv)) for lv in range(cfg.n_levels)]
    total = sum(inv)
    quotas = [max(8, int(round(cfg.n_features * w / total))) for w in inv]
    quotas[0] += cfg.n_features - sum(quotas)
    return quotas


def _select_impl(levels, scores, cfg: OrbConfig) -> Features:
    quotas = level_quotas(cfg)
    parts = []
    for lv, (lv_img, score) in enumerate(zip(levels, scores)):
        scale = cfg.scale_factor**lv
        score = mask_border(score, BORDER)
        ys, xs, resp = select_keypoints(
            score, cell=max(8, int(cfg.cell / scale ** 0.5)), k_cell=cfg.k_cell,
            n_out=quotas[lv])
        dy, dx = corner_subpix(lv_img, ys, xs)
        blurred = blur(lv_img)
        patches_blur = gather_patches(blurred, ys, xs, GATHER)
        ang = orientations_from_patches(patches_blur)
        desc = descriptors_from_patches(patches_blur, ang)
        uv = torch.stack([xs.to(torch.float32) + dx, ys.to(torch.float32) + dy], -1) * scale
        parts.append(Features(
            uv=uv, response=resp,
            octave=torch.full(resp.shape, lv, dtype=torch.int32, device=resp.device),
            angle=ang, desc=desc, valid=resp > 0,
        ))
    return Features(*[torch.cat([getattr(p, f) for p in parts], dim=-2 if f in ("uv", "desc") else -1)
                      for f in Features._fields])


# ---- stereo (frontend/stereo.py)
class StereoConfig(NamedTuple):
    max_hamming: int = 80  # absolute descriptor gate (ref TH_HIGH=100)
    ratio: float = 0.9  # best/second-best gate
    row_margin: float = 2.0  # vertical epipolar tolerance [px] (ref +-2)
    min_depth: float = 0.3  # [m]
    max_depth: float = 60.0  # [m]
    octave_tol: int = 1


def pow12(octave):
    """1.2 ** octave as float32."""
    return torch.pow(torch.tensor(1.2, dtype=torch.float32, device=octave.device),
                     octave.to(torch.float32))


def match_stereo(left: Features, right: Features, bf, cfg: StereoConfig = StereoConfig()):
    """Match left->right with epipolar/disparity gates.

    The features may carry leading batch axes (a chunk of stereo pairs);
    every image pair is matched on its own. Returns (u_right, depth,
    has_depth), each (..., N) aligned with the left features."""
    D = hamming_matrix(left.desc, right.desc).to(torch.float32)  # (..., N, M)
    du = left.uv[..., :, 0:1] - right.uv[..., None, :, 0]
    dv = torch.abs(left.uv[..., :, 1:2] - right.uv[..., None, :, 1])
    oct_ok = torch.abs(left.octave[..., :, None] - right.octave[..., None, :]) <= cfg.octave_tol
    min_disp = bf / cfg.max_depth
    max_disp = bf / cfg.min_depth
    tol = cfg.row_margin * pow12(left.octave)[..., :, None]
    mask = (left.valid[..., :, None] & right.valid[..., None, :] & oct_ok & (dv <= tol)
            & (du >= min_disp) & (du <= max_disp))
    BIG = 1e6
    cost = torch.where(mask, D, torch.full_like(D, BIG))

    j_best = torch.argmin(cost, dim=-1)  # (..., N)
    best = torch.gather(cost, -1, j_best[..., None])[..., 0]
    masked = cost.scatter(-1, j_best[..., None], float("inf"))
    second = torch.min(masked, dim=-1).values

    i_best_of_j = torch.argmin(cost, dim=-2)  # (..., M)
    mutual = (torch.gather(i_best_of_j, -1, j_best)
              == torch.arange(cost.shape[-2], device=cost.device))
    ok = ((best <= cfg.max_hamming)
          & (best <= cfg.ratio * torch.clamp(second, max=BIG - 1.0))
          & mutual & (best < BIG))

    u_r = torch.gather(right.uv[..., 0], -1, j_best)
    disp = torch.clamp(left.uv[..., 0] - u_r, min=1e-3)
    depth = bf / disp
    u_r = torch.where(ok, u_r, torch.full_like(u_r, -1.0))
    depth = torch.where(ok, depth, torch.full_like(depth, -1.0))
    return u_r, depth, ok



def fast_nms_reference(imgs, thr_hi: float = 20.0, thr_lo: float = 7.0):
    """nms3x3(max(fast_score(., thr_hi), 1e-3 * fast_score(., thr_lo)))."""
    s = torch.maximum(fast_score(imgs, thr_hi), fast_score(imgs, thr_lo) * 1e-3)
    return nms3x3(s)


BORDER = GHALF + 2  # keep full descriptor gather in-bounds


def detect_orb_batch(imgs, cfg: OrbConfig) -> Features:
    """(B, H, W) float32 -> Features with a leading batch axis B."""
    levels = build_pyramid(imgs, cfg.n_levels, cfg.scale_factor)
    scores = [fast_nms_reference(lv.contiguous(), cfg.fast_threshold, cfg.fast_threshold_min)
              for lv in levels]
    return _select_impl(levels, scores, cfg)


def detect_and_match(left_u8, right_u8, bf: float, orb_cfg: OrbConfig,
                     stereo_cfg: StereoConfig):
    """One stereo pair of (H, W) uint8 tensors -> (left Features, u_right):
    both images detected as one batch of two, the left matched to the
    right."""
    imgs = torch.stack([left_u8, right_u8]).to(torch.float32)
    f = detect_orb_batch(imgs, orb_cfg)
    featL = Features(*[a[0] for a in f])
    featR = Features(*[a[1] for a in f])
    bf_t = torch.tensor(float(bf), dtype=torch.float32, device=imgs.device)
    u_r, _, _ = match_stereo(featL, featR, bf_t, stereo_cfg)
    return featL, u_r
