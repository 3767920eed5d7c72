"""Epipolar-constrained stereo matching + disparity depth.

Port of orbslam3_tpu/frontend/stereo.py: a dense masked Hamming cost matrix,
best/second-best ratio test and mutual argmin. Argmin and min keep the
first (lowest-index) minimum, as lax.top_k does."""
from __future__ import annotations

from typing import NamedTuple

import torch

from orbslam3_tpu_torch.frontend.camera import Camera
from orbslam3_tpu_torch.frontend.orb import Features
from orbslam3_tpu_torch.ops.hamming import hamming_matrix


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


def match_stereo(left: Features, right: Features, cam: Camera, cfg: StereoConfig = StereoConfig()):
    """Match left->right with epipolar/disparity gates.

    The features may carry leading batch axes (a chunk of stereo pairs);
    every image pair is matched on its own. Returns (u_right, depth,
    has_depth), each (..., N) aligned with the left features."""
    D = hamming_matrix(left.desc, right.desc).to(torch.float32)  # (..., N, M)
    du = left.uv[..., :, 0:1] - right.uv[..., None, :, 0]
    dv = torch.abs(left.uv[..., :, 1:2] - right.uv[..., None, :, 1])
    oct_ok = torch.abs(left.octave[..., :, None] - right.octave[..., None, :]) <= cfg.octave_tol
    min_disp = cam.bf / cfg.max_depth
    max_disp = cam.bf / cfg.min_depth
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
    depth = cam.bf / disp
    u_r = torch.where(ok, u_r, torch.full_like(u_r, -1.0))
    depth = torch.where(ok, depth, torch.full_like(depth, -1.0))
    return u_r, depth, ok
