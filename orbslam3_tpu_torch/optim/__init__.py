"""Solvers: motion-only pose Gauss-Newton and local bundle adjustment."""
