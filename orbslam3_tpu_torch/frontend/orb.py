"""ORB detection over the pyramid -> fixed-size Features struct.

Port of orbslam3_tpu/frontend/orb.py: per-level static quotas, grid top-k
selection, subpixel refinement, intensity-centroid orientation and steered
BRIEF, for a batch of same-size images at once (the stereo pair).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from orbslam3_tpu_torch.ops import brief as brief_ops
from orbslam3_tpu_torch.ops import fast as fast_ops
from orbslam3_tpu_torch.ops import pyramid as pyr_ops
from orbslam3_tpu_torch.ops.fast_cuda import fast_nms_levels

BORDER = brief_ops.GHALF + 2  # keep full descriptor gather in-bounds


class OrbConfig(NamedTuple):
    n_features: int = 1024
    n_levels: int = 8
    scale_factor: float = 1.2
    fast_threshold: float = 20.0
    fast_threshold_min: float = 7.0
    cell: int = 32
    k_cell: int = 6
    # kept for parity with the JAX config and ignored: a CUDA tensor always
    # takes the CUDA FAST/NMS kernel, a CPU tensor its plain version
    use_pallas_fast: bool = True


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


def detect_orb(img, cfg: OrbConfig = OrbConfig()) -> Features:
    """(H, W) float32 grayscale -> Features with n_features slots: a batch
    of one through the same FAST/NMS launch, with the bits the image gets
    as the left of a stereo pair (`detect_orb_pair`)."""
    return Features(*[a[0] for a in detect_orb_batch(img[None], cfg)])


def detect_orb_batch(imgs, cfg: OrbConfig = OrbConfig()) -> Features:
    """(B, H, W) float32 -> Features with a leading batch axis B."""
    levels = pyr_ops.build_pyramid(imgs, cfg.n_levels, cfg.scale_factor)
    scores = _score_maps_batched(levels, cfg)
    return _select_impl(levels, scores, cfg)


def detect_orb_pair(left, right, cfg: OrbConfig = OrbConfig()):
    """Detect on both stereo images as one batch. Returns (featL, featR)."""
    f = detect_orb_batch(torch.stack([left, right]), cfg)
    featL = Features(*[a[0] for a in f])
    featR = Features(*[a[1] for a in f])
    return featL, featR


def _score_maps_batched(levels_b, cfg: OrbConfig):
    """Per-level NMS'd two-threshold FAST scores of the (B, h, w) stacks:
    one fast_nms_levels call, one kernel launch, for the whole pyramid."""
    return fast_nms_levels([lv.contiguous() for lv in levels_b],
                           cfg.fast_threshold, cfg.fast_threshold_min)


def _select_impl(levels, scores, cfg: OrbConfig) -> Features:
    quotas = level_quotas(cfg)
    parts = []
    for lv, (lv_img, score) in enumerate(zip(levels, scores)):
        scale = cfg.scale_factor**lv
        score = fast_ops.mask_border(score, BORDER)
        ys, xs, resp = fast_ops.select_keypoints(
            score, cell=max(8, int(cfg.cell / scale ** 0.5)), k_cell=cfg.k_cell,
            n_out=quotas[lv])
        dy, dx = fast_ops.corner_subpix(lv_img, ys, xs)
        blurred = pyr_ops.blur(lv_img)
        patches_blur = brief_ops.gather_patches(blurred, ys, xs, brief_ops.GATHER)
        ang = brief_ops.orientations_from_patches(patches_blur)
        desc = brief_ops.descriptors_from_patches(patches_blur, ang)
        uv = torch.stack([xs.to(torch.float32) + dx, ys.to(torch.float32) + dy], -1) * scale
        parts.append(Features(
            uv=uv, response=resp,
            octave=torch.full(resp.shape, lv, dtype=torch.int32, device=resp.device),
            angle=ang, desc=desc, valid=resp > 0,
        ))
    return Features(*[torch.cat([getattr(p, f) for p in parts], dim=-2 if f in ("uv", "desc") else -1)
                      for f in Features._fields])
