"""Epipolar-constrained stereo matching + disparity depth.

Port of orbslam3_tpu/frontend/stereo.py: a dense masked Hamming cost matrix,
best/second-best ratio test and mutual argmin. Argmin and min keep the
first (lowest-index) minimum, as lax.top_k does."""
from __future__ import annotations

from typing import NamedTuple

import torch

from orbslam3_tpu_torch.frontend.camera import Camera
from orbslam3_tpu_torch.frontend.orb import Features, OrbConfig, detect_orb_pair
from orbslam3_tpu_torch.ops.hamming import hamming_matrix


class StereoConfig(NamedTuple):
    max_hamming: int = 80  # absolute descriptor gate (ref TH_HIGH=100)
    ratio: float = 0.9  # best/second-best gate
    row_margin: float = 2.0  # vertical epipolar tolerance [px] (ref +-2)
    min_depth: float = 0.3  # [m]
    max_depth: float = 60.0  # [m]
    octave_tol: int = 1


class StereoFrame(NamedTuple):
    """Stereo-processed frame: left features + right matches + depth."""

    feat: Features  # left-image features
    u_right: torch.Tensor  # (N,) right-image u coord, -1 if unmatched
    depth: torch.Tensor  # (N,) metric depth, -1 if unmatched
    points_cam: torch.Tensor  # (N, 3) camera-frame 3D points (garbage if no depth)
    has_depth: torch.Tensor  # (N,) bool


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


def process_stereo(img_left, img_right, cam: Camera, orb_cfg: OrbConfig = OrbConfig(),
                   stereo_cfg: StereoConfig = StereoConfig()) -> StereoFrame:
    """The stereo front end of one (H, W) float32 pair: detect both images
    in one batch, match, unproject the matched features."""
    left, right = detect_orb_pair(img_left, img_right, orb_cfg)
    u_r, depth, has_depth = match_stereo(left, right, cam, stereo_cfg)
    pts = cam.unproject(left.uv, torch.where(has_depth, depth, torch.ones_like(depth)))
    return StereoFrame(feat=left, u_right=u_r, depth=depth, points_cam=pts, has_depth=has_depth)
