"""Synthetic stereo-inertial data (host numpy)."""
