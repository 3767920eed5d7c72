"""Keyframe policy (port of orbslam3_tpu/models/policy.py)."""
from __future__ import annotations

import torch


def keyframe_wanted(mode_ok, frames_since_kf, n_inliers, ref_inliers,
                    kf_max_frames: int, kf_inlier_ratio: float, kf_min_inliers: int):
    """Visual keyframe policy on 0-d tensors: tracking OK and either the
    frame-count cap is reached or tracked inliers decayed below
    kf_inlier_ratio of the reference keyframe's (while above a floor)."""
    n_inl = torch.as_tensor(n_inliers).to(torch.float32)
    ref = torch.as_tensor(ref_inliers).to(torch.float32)
    decay = (n_inl < kf_inlier_ratio * ref) & (n_inl > kf_min_inliers)
    return torch.as_tensor(mode_ok) & ((torch.as_tensor(frames_since_kf) >= kf_max_frames) | decay)


def keyframe_wanted_lost(mode_recently_lost, imu_ok, have_imu, frames_since_kf,
                         kf_max_frames: int, allow_visual: bool = False):
    """Keyframe insertion while RecentlyLost, on IMU dead-reckoning (or on
    the motion model with allow_visual)."""
    sensor_ok = (torch.as_tensor(imu_ok) & torch.as_tensor(have_imu)) | allow_visual
    return (torch.as_tensor(mode_recently_lost) & sensor_ok
            & (torch.as_tensor(frames_since_kf) >= kf_max_frames))
