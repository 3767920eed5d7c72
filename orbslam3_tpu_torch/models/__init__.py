"""Tracking, local mapping, the fused per-frame SLAM step and the
host-orchestrated SlamSystem."""
from orbslam3_tpu_torch.models.slam import FrameResult, SlamConfig, SlamSystem  # noqa: F401
