"""Whole-map bundle adjustment (one device; a torch.distributed version
extends parallel/distributed_ba.py later)."""
