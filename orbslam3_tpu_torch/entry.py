"""Entry points of the port: a single-device step check and a multi-device
dryrun (the PyTorch counterpart of the repo's `__graft_entry__.py`).

entry(device=None): the tracking step of the flagship model (local-map
matching + robust motion-only Gauss-Newton) on a small synthetic map, with
the map and inputs drawn from the same numpy generator as the JAX entry
point. Returns (track_step, args); track_step(*args) gives (q, p, n_inliers).

dryrun_multichip(n_devices, device=None): one `distributed_global_ba`
solve over n spawned ranks (NCCL where the machine has n cards, gloo
otherwise), then the whole fused SLAM step over n sessions of a
MultiSessionSlam, on tiny shapes.

Both run on the CUDA card unless `device` says otherwise (device="cpu"
runs on the CPU); without a card and without a device they raise.
"""
from __future__ import annotations

import numpy as np
import torch

from orbslam3_tpu_torch import default_device


def entry(device=None):
    from orbslam3_tpu_torch.frontend.camera import Camera
    from orbslam3_tpu_torch.geometry import quat
    from orbslam3_tpu_torch.map.slam_map import MapCapacity, empty_map
    from orbslam3_tpu_torch.models.tracker import TrackConfig, match_local_map
    from orbslam3_tpu_torch.optim.pose_only import pose_optimize

    dev = default_device(device)
    cam = Camera.create(458.0, 458.0, 376.0, 240.0, 0.11).to(dev)
    cap = MapCapacity(max_kf=8, n_feat=128, max_mp=512, max_obs=8)
    st = empty_map(cap, device=dev)
    rng = np.random.default_rng(0)
    # a plausible block of map points
    P = 256
    put = lambda a, v: torch.cat([torch.as_tensor(v, dtype=a.dtype, device=dev), a[P:]])
    mp_pos = (rng.uniform(-3, 3, (P, 3)) + np.array([0, 0, 6.0])).astype(np.float32)
    mp_desc = rng.integers(0, 255, (P, 32)).astype(np.uint8)
    normal = st.mp_normal.clone()
    normal[:P, 2] = -1.0
    st = st._replace(
        mp_pos=put(st.mp_pos, mp_pos), mp_desc=put(st.mp_desc, mp_desc), mp_normal=normal,
        mp_min_dist=put(st.mp_min_dist, np.full(P, 0.5, np.float32)),
        mp_max_dist=put(st.mp_max_dist, np.full(P, 40.0, np.float32)),
        mp_valid=put(st.mp_valid, np.ones(P, bool)),
        mp_map_id=put(st.mp_map_id, np.zeros(P, np.int32)),
        n_mp=torch.tensor(P, dtype=st.n_mp.dtype, device=dev),
    )

    N = cap.n_feat
    uv = torch.from_numpy(rng.uniform(0, (752, 480), (N, 2)).astype(np.float32)).to(dev)
    desc = torch.from_numpy(rng.integers(0, 255, (N, 32)).astype(np.uint8)).to(dev)
    octave = torch.zeros(N, dtype=torch.int32, device=dev)
    valid = torch.ones(N, dtype=torch.bool, device=dev)
    q0 = quat.identity(device=dev)
    p0 = torch.zeros(3, dtype=torch.float32, device=dev)
    cfg = TrackConfig(p_local=256)

    def track_step(st, uv, desc, octave, valid, q0, p0):
        matched, mp_w, _, _ = match_local_map(st, cam, uv, desc, octave, valid, q0, p0, cfg)
        res = pose_optimize(q0, p0, cam, mp_w, uv, torch.full((N,), -1.0, device=uv.device),
                            octave, matched >= 0)
        return res.q, res.p, res.n_inliers

    return track_step, (st, uv, desc, octave, valid, q0, p0)


def gba_dryrun_problem(n_devices: int, rng) -> dict:
    """The dryrun's global-BA problem (JAX `dryrun_multichip`'s draws): 4
    keyframes, 16 points a rank seen 3 times each, poses and points pulled
    off the truth. numpy arrays, as `parallel/ranks.py::gba_rank` takes."""
    K, O = 4, 4
    P = 16 * n_devices
    p_gt = np.stack([np.linspace(0, 1.0, K), np.zeros(K), np.zeros(K)], -1).astype(np.float32)
    q_gt = np.tile(np.array([1.0, 0, 0, 0], np.float32), (K, 1))
    Xw = np.stack([rng.uniform(-2, 2, P), rng.uniform(-2, 2, P), rng.uniform(4, 8, P)],
                  -1).astype(np.float32)
    obs_kf = np.full((P, O), -1, np.int32)
    obs_uv = np.zeros((P, O, 2), np.float32)
    obs_ur = np.full((P, O), -1.0, np.float32)
    for i in range(P):
        for j, k in enumerate(rng.choice(K, 3, replace=False)):
            xc = Xw[i] - p_gt[k]
            obs_kf[i, j] = k
            obs_uv[i, j] = (458.0 * xc[0] / xc[2] + 376.0, 458.0 * xc[1] / xc[2] + 240.0)
    return dict(
        Xw=Xw + rng.normal(0, 0.05, (P, 3)).astype(np.float32), pt_valid=np.ones(P, bool),
        obs_kf=obs_kf, obs_uv=obs_uv, obs_ur=obs_ur, obs_oct=np.zeros((P, O), np.int32),
        q=q_gt, p=p_gt + np.float32(rng.normal(0, 0.02, (K, 3))),
        opt_cam=np.array([False] + [True] * (K - 1)),
        cam=(458.0, 458.0, 376.0, 240.0, 0.11, 752, 480))


def dryrun_multichip(n_devices: int, device=None) -> None:
    from orbslam3_tpu_torch.frontend.camera import Camera
    from orbslam3_tpu_torch.frontend.orb import OrbConfig
    from orbslam3_tpu_torch.map.slam_map import MapCapacity
    from orbslam3_tpu_torch.models.slam import SlamConfig
    from orbslam3_tpu_torch.models.tracker import TrackConfig
    from orbslam3_tpu_torch.parallel.multi_session import MultiSessionSlam
    from orbslam3_tpu_torch.parallel.ranks import gba_rank, run_ranks

    dev = default_device(device)
    rng = np.random.default_rng(1)
    problem = gba_dryrun_problem(n_devices, rng)
    cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    backend = "nccl" if cards >= n_devices else "gloo"
    outs = run_ranks(gba_rank, n_devices, (problem, 2, 0, dev.type), backend=backend)
    for o in outs[1:]:
        if not all(np.array_equal(o[k], outs[0][k]) for k in ("q", "p", "Xw")):
            raise RuntimeError("dryrun_multichip: the ranks' global BA results differ")
    print(f"dryrun_multichip({n_devices}): distributed BA step OK over {n_devices} ranks "
          f"({backend}, {dev.type})", flush=True)

    # the whole fused tracking/mapping step over n independent sessions on tiny
    # shapes: stereo ORB, matching, robust solves, the keyframe branch with
    # local BA, triangulation, fusion and culling
    cfg = SlamConfig(
        orb=OrbConfig(n_features=128, n_levels=2),
        cap=MapCapacity(max_kf=8, n_feat=128, max_mp=512, max_obs=4),
        track=TrackConfig(p_local=128), ba_window=4, ba_points=128,
        use_imu=True, kf_max_frames=2, new_mp_budget=64,
    )
    cam_s = Camera.create(80.0, 80.0, 64.0, 48.0, 0.11, 128, 96)
    devices = None if device is None else [dev] * n_devices
    ms = MultiSessionSlam(cam_s, cfg, n_sessions=n_devices, chunk=2, devices=devices)
    for fi in range(2):
        for s in range(n_devices):
            img = rng.integers(0, 255, (96, 128)).astype(np.uint8)
            ms.process_frame(s, img, img, np.zeros((4, 3)), np.tile([0.0, 0.0, 9.81], (4, 1)),
                             np.full(4, 0.01), fi * 0.05)
    ms.finalize()
    print(f"dryrun_multichip({n_devices}): full slam_step x{n_devices} sessions OK "
          f"over {sorted({str(d) for d in ms.devices})}", flush=True)


if __name__ == "__main__":
    fn, args = entry()
    out = fn(*args)
    print("entry() run OK:", [tuple(o.shape) for o in out])
