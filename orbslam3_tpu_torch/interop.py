"""Convert state NamedTuples between numpy arrays and the port's tensors.

`to_numpy_tree(nt)` / `from_numpy_tree(nt, device)` map every leaf of a
(nested) NamedTuple — MapState, TrackState, PreintState, Features,
FrameOut, VIBAProblem, VIBAResult, ImuInitResult, SE3, Sim3, Vocabulary,
PoseGraphProblem, LoopConfig, LoopStats, GlobalBAPoints — between torch
tensors and numpy arrays, keeping dtypes (float32/int32/bool/uint8); a
plain tuple of leaves (a Vocabulary's levels) is mapped leaf by leaf, Python
numbers pass through. A JAX state turned into numpy
(`jax.tree.map(np.asarray, state)`) goes through `from_numpy_tree`
unchanged, which is how the parity tests start both packages from the
same map. `carry_loop_closer` copies a loop closer's host and device state
into the port's.
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
    from orbslam3_tpu_torch.loop.closer import LoopConfig, LoopStats
    from orbslam3_tpu_torch.loop.vocab import Vocabulary
    from orbslam3_tpu_torch.map.slam_map import MapState
    from orbslam3_tpu_torch.models.fused import FrameOut, TrackState
    from orbslam3_tpu_torch.optim.imu_init import ImuInitResult
    from orbslam3_tpu_torch.optim.pose_graph import PoseGraphProblem
    from orbslam3_tpu_torch.optim.vi_ba import VIBAProblem, VIBAResult
    from orbslam3_tpu_torch.parallel.distributed_ba import GlobalBAPoints

    return {c.__name__: c for c in (Features, PreintState, MapState, FrameOut, TrackState,
                                    VIBAProblem, VIBAResult, ImuInitResult, SE3, Sim3, Vocabulary,
                                    PoseGraphProblem, LoopConfig, LoopStats, GlobalBAPoints)}


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


def carry_loop_closer(src, dst, device=None):
    """Copy a loop closer's state into the port's LoopCloser `dst`: the BoW
    database, the consistency chains, the last corrected keyframe, the
    accumulated loop edges, gravity and the statistics. `src` is either
    package's closer (the JAX one's arrays go through numpy), so two closers
    can start mid-session from one state. The in-flight packet and
    verification are not carried."""
    def tensor(a, dtype=None):
        if a is None:
            return None
        a = a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.array(a)
        return torch.from_numpy(np.ascontiguousarray(a)).to(device, dtype)

    dst.bow_ids = tensor(src.bow_ids, torch.int32)
    dst.bow_w = tensor(src.bow_w, torch.float32)
    dst._consistency_groups = [(set(g), int(c), int(k)) for g, c, k in src._consistency_groups]
    dst.last_loop_kf = int(src.last_loop_kf)
    dst._loop_edges = [(int(i), int(j), np.array(q, np.float32), np.array(t, np.float32),
                        float(s)) for i, j, q, t, s in src._loop_edges]
    dst.gravity_w = tensor(src.gravity_w, torch.float32)
    dst.stats = type(dst.stats)(*[int(x) for x in src.stats])
    return dst
