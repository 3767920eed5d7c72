"""Tracking, local mapping and the fused per-frame SLAM step."""
