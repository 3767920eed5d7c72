"""Trajectory metrics (host numpy)."""
