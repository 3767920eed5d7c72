"""Convert state NamedTuples between numpy arrays and the port's tensors.

`to_numpy_tree(nt)` / `from_numpy_tree(nt, device)` map every leaf of a
(nested) NamedTuple — MapState, TrackState, PreintState, Features,
FrameOut, VIBAProblem, VIBAResult, ImuInitResult, SE3, Sim3, Vocabulary,
PoseGraphProblem — between torch tensors and numpy arrays, keeping dtypes
(float32/int32/bool/uint8); a plain tuple of leaves (a Vocabulary's levels)
is mapped leaf by leaf, Python numbers pass through. A JAX state turned into numpy
(`jax.tree.map(np.asarray, state)`) goes through `from_numpy_tree`
unchanged, which is how the parity tests start both packages from the
same map.
"""
from __future__ import annotations

import numpy as np
import torch


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _port_types() -> dict:
    from orbslam3_tpu_torch.frontend.orb import Features
    from orbslam3_tpu_torch.geometry.se3 import SE3
    from orbslam3_tpu_torch.geometry.sim3 import Sim3
    from orbslam3_tpu_torch.imu.preintegration import PreintState
    from orbslam3_tpu_torch.loop.vocab import Vocabulary
    from orbslam3_tpu_torch.map.slam_map import MapState
    from orbslam3_tpu_torch.models.fused import FrameOut, TrackState
    from orbslam3_tpu_torch.optim.imu_init import ImuInitResult
    from orbslam3_tpu_torch.optim.pose_graph import PoseGraphProblem
    from orbslam3_tpu_torch.optim.vi_ba import VIBAProblem, VIBAResult

    return {c.__name__: c for c in (Features, PreintState, MapState, FrameOut, TrackState,
                                    VIBAProblem, VIBAResult, ImuInitResult, SE3, Sim3, Vocabulary,
                                    PoseGraphProblem)}


def to_numpy_tree(nt):
    """Tensors -> numpy arrays, leaf by leaf (NamedTuple types kept)."""
    if _is_namedtuple(nt):
        return type(nt)(*[to_numpy_tree(v) for v in nt])
    if isinstance(nt, tuple):
        return tuple(to_numpy_tree(v) for v in nt)
    if isinstance(nt, torch.Tensor):
        return nt.detach().cpu().numpy()
    return nt


def to_device(nt, device):
    """Every tensor of a (nested) NamedTuple moved to `device`."""
    if isinstance(nt, tuple):
        moved = [to_device(v, device) for v in nt]
        return type(nt)(*moved) if _is_namedtuple(nt) else tuple(moved)
    return nt.to(device) if isinstance(nt, torch.Tensor) else nt


def from_numpy_tree(nt, device=None):
    """numpy arrays -> tensors on `device`, leaf by leaf. A NamedTuple whose
    name is one of the port's types (see `_port_types`) becomes that port type, whichever
    package's NamedTuple it came in as."""
    if _is_namedtuple(nt):
        cls = _port_types().get(type(nt).__name__, type(nt))
        return cls(*[from_numpy_tree(v, device) for v in nt])
    if isinstance(nt, tuple):
        return tuple(from_numpy_tree(v, device) for v in nt)
    if nt is None or isinstance(nt, (int, float, bool, str)):
        return nt
    return torch.from_numpy(np.array(nt)).to(device)
