"""Map / tracker-state checkpointing (save + resume).

Port of orbslam3_tpu/map/checkpoint.py with the same file layout: one npz
whose keys are `map.<field>`, `map.kf_preint.<field>` and, with a tracker
state, `ts.<field>`, `ts.kf_preint.<field>`; every leaf keeps its dtype and
shape (0-d counters stay 0-d). A file saved by either package loads in the
other.
"""
from __future__ import annotations

import numpy as np
import torch

from orbslam3_tpu_torch import default_device
from orbslam3_tpu_torch.imu.preintegration import PreintState
from orbslam3_tpu_torch.map.slam_map import MapState


def _flatten(prefix: str, tree, out: dict):
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):  # NamedTuple
        for name in tree._fields:
            _flatten(f"{prefix}{name}.", getattr(tree, name), out)
    elif isinstance(tree, torch.Tensor):
        out[prefix.rstrip(".")] = tree.detach().cpu().numpy()
    else:
        out[prefix.rstrip(".")] = np.asarray(tree)


def _unflatten(cls, prefix: str, data: dict):
    kwargs = {}
    for name in cls._fields:
        key = f"{prefix}{name}"
        if key in data:
            kwargs[name] = data[key]
        elif name == "kf_preint":  # the one nested NamedTuple
            kwargs[name] = _unflatten(PreintState, f"{key}.", data)
        else:
            raise KeyError(f"the checkpoint holds no '{key}'")
    return cls(**kwargs)


def save_map(path: str, map_state: MapState, track_state=None):
    out: dict = {}
    _flatten("map.", map_state, out)
    if track_state is not None:
        _flatten("ts.", track_state, out)
    np.savez_compressed(path, **out)


def load_map(path: str, with_track_state: bool = False, device=None):
    """MapState (and TrackState) of a checkpoint, on `device`: the CUDA
    card when None, and a RuntimeError where there is none."""
    dev = default_device(device)
    with np.load(path) as npz:
        data = {k: torch.from_numpy(np.array(v)).to(dev) for k, v in npz.items()}
    st = _unflatten(MapState, "map.", data)
    if not with_track_state:
        return st
    from orbslam3_tpu_torch.models.fused import TrackState

    return st, _unflatten(TrackState, "ts.", data)
