"""Offline export of trajectories and maps."""
