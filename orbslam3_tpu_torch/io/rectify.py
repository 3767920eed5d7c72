"""Stereo undistortion + rectification for EuRoC-style radtan cameras.

Port of orbslam3_tpu/io/rectify.py: Bouguet-style rectification computed
once per sequence (host numpy over the port's quaternions), applied per
frame as a bilinear remap on the device (`remap_bilinear`: plain torch
arithmetic with the roundings the JAX expression gets under XLA:CPU, the
four taps gathered by flat index; `grid_sample` rounds its own way).

Pipeline: out pixel (u,v) -> ray through the NEW rectified pinhole ->
rotate by R_rect^T into the original camera -> apply radial-tangential
distortion -> original K -> source pixel. Lookup maps are (H, W) float32.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from orbslam3_tpu_torch.geometry import quat


class RectifyMaps(NamedTuple):
    map_x0: np.ndarray  # (H, W) source x for cam0
    map_y0: np.ndarray
    map_x1: np.ndarray  # cam1
    map_y1: np.ndarray
    K_new: np.ndarray  # (3, 3) common rectified intrinsics
    baseline: float  # rectified baseline [m]
    R_rect0: np.ndarray  # (3, 3) original-cam0 -> rectified-cam0
    R_rect1: np.ndarray


def _rodrigues(w):
    th = np.linalg.norm(w)
    if th < 1e-12:
        return np.eye(3)
    k = w / th
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K


def _log_so3(R):
    tr = np.clip((np.trace(R) - 1) / 2, -1, 1)
    th = np.arccos(tr)
    if th < 1e-12:
        return np.zeros(3)
    w = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    return th / (2 * np.sin(th)) * w


def _distort_radtan(xn, yn, d):
    k1, k2, p1, p2 = d[:4]
    r2 = xn * xn + yn * yn
    radial = 1 + k1 * r2 + k2 * r2 * r2
    xd = xn * radial + 2 * p1 * xn * yn + p2 * (r2 + 2 * xn * xn)
    yd = yn * radial + p1 * (r2 + 2 * yn * yn) + 2 * p2 * xn * yn
    return xd, yd


def stereo_rectify_maps(K0, d0, T_BS0, K1, d1, T_BS1, size) -> RectifyMaps:
    """Compute rectification maps for a stereo pair.

    Args:
      K0/K1: (3,3); d0/d1: (4,) radtan; T_BS0/T_BS1: (4,4) body-from-cam;
      size: (w, h)
    """
    w, h = size
    # relative: cam1 <- cam0
    T_10 = np.linalg.inv(T_BS1) @ T_BS0
    R = T_10[:3, :3]
    t = T_10[:3, 3]

    # split the relative rotation evenly (Bouguet)
    om = _log_so3(R)
    R_half = _rodrigues(-om / 2)  # applied to cam1
    R_half0 = _rodrigues(om / 2)  # applied to cam0 brings frames together
    t_rect = R_half @ t

    # new x-axis along the baseline
    e1 = t_rect / np.linalg.norm(t_rect)
    if e1[0] < 0:  # orient the rectified x-axis with image +x
        e1 = -e1
    e2 = np.cross(np.array([0.0, 0.0, 1.0]), e1)
    e2 /= np.linalg.norm(e2)
    e3 = np.cross(e1, e2)
    R_ww = np.stack([e1, e2, e3])  # rows

    R_rect0 = R_ww @ R_half0
    R_rect1 = R_ww @ R_half

    # common intrinsics: average focal, centered principal point
    f = (K0[0, 0] + K0[1, 1] + K1[0, 0] + K1[1, 1]) / 4
    K_new = np.array([[f, 0, w / 2.0], [0, f, h / 2.0], [0, 0, 1.0]])
    baseline = float(np.linalg.norm(t))

    def maps_for(K, d, R_rect):
        us, vs = np.meshgrid(np.arange(w, dtype=np.float64), np.arange(h, dtype=np.float64))
        x = (us - K_new[0, 2]) / K_new[0, 0]
        y = (vs - K_new[1, 2]) / K_new[1, 1]
        rays = np.stack([x, y, np.ones_like(x)], -1) @ R_rect  # = R_rect^T @ ray
        xn = rays[..., 0] / rays[..., 2]
        yn = rays[..., 1] / rays[..., 2]
        xd, yd = _distort_radtan(xn, yn, d)
        mx = (K[0, 0] * xd + K[0, 2]).astype(np.float32)
        my = (K[1, 1] * yd + K[1, 2]).astype(np.float32)
        return mx, my

    mx0, my0 = maps_for(K0, d0, R_rect0)
    mx1, my1 = maps_for(K1, d1, R_rect1)
    return RectifyMaps(mx0, my0, mx1, my1, K_new, baseline, R_rect0, R_rect1)


def body_from_rect_cam(T_BS0, R_rect0):
    """T_BC for the RECTIFIED left camera: (q_bc wxyz, p_bc) numpy.

    The rectified camera shares cam0's optical center but its frame is
    rotated by R_rect0 (rect-from-cam0), so
    T_B_rect = T_BS0 ∘ [R_rect0^T, 0]: the extrinsic accounts for the
    rectifying rotation)."""
    R = T_BS0[:3, :3] @ R_rect0.T
    t = T_BS0[:3, 3]
    q = quat.from_matrix_np(R)
    return q.astype(np.float32), t.astype(np.float32)


def _fma(a, b, c):
    """a * b + c rounded once to float32: the product of two float32 values
    is exact in float64, so only the sum rounds there before the one
    rounding to float32."""
    return (a.double() * b.double() + c.double()).float()


def remap_bilinear(img, map_x, map_y):
    """Bilinear resampling on img's device: out[v, u] = img[map_y[v, u],
    map_x[v, u]], 0 outside the image. img (H, W) float32; maps (H', W')
    float32 on the same device.

    The JAX package's expression (orbslam3_tpu/io/rectify.py:136-147) runs
    under XLA:CPU as three fused multiply-adds,
    fma(v00 (1 - wy), 1 - wx, v01 (1 - wy) wx), then + v10 wy (1 - wx), then
    + v11 wy wx, each fused step rounded once; this computes the same
    roundings, so the truncated uint8 images agree with the references'."""
    h, w = img.shape
    x0 = torch.clamp(torch.floor(map_x).to(torch.int32), 0, w - 2)
    y0 = torch.clamp(torch.floor(map_y).to(torch.int32), 0, h - 2)
    wx = torch.clamp(map_x - x0.to(torch.float32), 0.0, 1.0)
    wy = torch.clamp(map_y - y0.to(torch.float32), 0.0, 1.0)
    flat = img.reshape(-1)
    i00 = (y0 * w + x0).long()
    v00 = flat[i00]
    v01 = flat[i00 + 1]
    v10 = flat[i00 + w]
    v11 = flat[i00 + w + 1]
    owx, owy = 1 - wx, 1 - wy
    out = _fma(v00 * owy, owx, v01 * owy * wx)
    out = _fma(v10 * wy, owx, out)
    out = _fma(v11 * wy, wx, out)
    inb = (map_x >= 0) & (map_x <= w - 1) & (map_y >= 0) & (map_y <= h - 1)
    return torch.where(inb, out, torch.zeros_like(out))


def remap_u8(img_u8, map_x, map_y):
    """`remap_bilinear` of a uint8 image, truncated back to uint8 as the
    EuRoC runner feeds the tracker (scripts/run_euroc.py:112-113)."""
    return remap_bilinear(img_u8.to(torch.float32), map_x, map_y).to(torch.uint8)
