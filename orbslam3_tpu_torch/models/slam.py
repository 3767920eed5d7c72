"""SlamConfig: the pipeline configuration (port of the config half of
orbslam3_tpu/models/slam.py; the host-orchestrated SlamSystem is not
ported — FusedSlam in models/fused.py is the pipeline)."""
from __future__ import annotations

from typing import NamedTuple

from orbslam3_tpu_torch.frontend.orb import OrbConfig
from orbslam3_tpu_torch.frontend.stereo import StereoConfig
from orbslam3_tpu_torch.imu.preintegration import ImuNoise
from orbslam3_tpu_torch.map.slam_map import MapCapacity
from orbslam3_tpu_torch.models.tracker import TrackConfig


class SlamConfig(NamedTuple):
    """Every field and default of orbslam3_tpu's SlamConfig. The torch
    FusedSlam runs the stereo slice (models/fused.py::SLICE_CFG) and refuses
    the flags whose code paths are not ported yet."""

    orb: OrbConfig = OrbConfig()
    stereo: StereoConfig = StereoConfig()
    track: TrackConfig = TrackConfig()
    cap: MapCapacity = MapCapacity()
    # keyframe policy
    kf_max_frames: int = 10
    kf_inlier_ratio: float = 0.7
    kf_min_inliers: int = 25
    min_track_inliers: int = 12
    # local mapping
    ba_window: int = 8
    ba_points: int = 2048
    ba_fixed: int = 16  # fixed observer keyframes in visual local BA
    vi_ba_fixed: int = 0
    ba_iters: int = 4
    cull_every_kfs: int = 3
    new_mp_budget: int = 384
    # IMU
    use_imu: bool = True
    imu_noise: ImuNoise = ImuNoise()
    imu_init_kfs: int = 12
    imu_init_min_time: float = 1.0
    max_imu_per_frame: int = 32
    max_imu_per_kf: int = 512
    # atlas
    lost_timeout: float = 5.0
    min_kfs_keep_map: int = 10
    # recovery
    insert_kfs_lost: bool = True
    insert_kfs_lost_visual: bool = False
    ransac_fallback: bool = True
    ransac_hyps: int = 128
    bad_imu_timeout: float = 10.0
    bad_imu_min_motion: float = 0.02
    max_speed: float = 20.0
    imu_trust_recovery_s: float = 2.0
    # map maintenance
    fuse_neighbors: bool = True
    triangulate_mono: bool = True
    kf_cull_redundancy: float = 0.92  # 0 disables keyframe culling
    kf_cull_redundancy_vi: float = 0.7
    kf_cull_max_per_insert: int = 2
    kf_cull_max_gap: float = 3.0
    update_point_stats: bool = True
