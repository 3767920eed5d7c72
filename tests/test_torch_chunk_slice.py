"""Chunked dispatch and the long session of the port, end to end against
the JAX package: the world and configuration of test_torch_vi_slice.py
(384x256, 4 s at 10 Hz, use_imu=True, every production flag on,
service_every=4) with a map of 16 keyframe rows, so that compaction and the
keyframe pressure evictions fire by themselves in both packages.

Held: the port at chunk 4 and at chunk 3 (which does not divide
service_every: a service round flushes mid-chunk) gives the poses of chunk 1
bit for bit, with the same compaction passes; against the JAX
FusedSlam(chunk=4): the IMU initializes in the same service round, the same
number of compaction passes with the same keyframe rows left after each, the
same evictions, per-frame modes equal, corrected trajectories within 1 cm,
the port's ATE under 0.06 m; one flag read a frame plus the rare services'
reads."""
import numpy as np
import pytest
import torch

from orbslam3_tpu.frontend.orb import OrbConfig as JOrb
from orbslam3_tpu.io.synthetic import SyntheticConfig, SyntheticWorld
from orbslam3_tpu.map.slam_map import MapCapacity as JCap
from orbslam3_tpu.models import fused as jfused
from orbslam3_tpu.models.slam import SlamConfig as JSlamConfig
from orbslam3_tpu.models.tracker import TrackConfig as JTrack
from orbslam3_tpu_torch.eval.metrics import ate_rmse
from orbslam3_tpu_torch.frontend.orb import OrbConfig as TOrb
from orbslam3_tpu_torch.map.slam_map import MapCapacity as TCap
from orbslam3_tpu_torch.models import fused as tfused
from orbslam3_tpu_torch.models.slam import SlamConfig as TSlamConfig
from orbslam3_tpu_torch.models.tracker import TrackConfig as TTrack
from test_torch_vi_slice import SERVICE_EVERY, SMALL, WORLD
from torch_parity import port_camera

MAX_KF = 16


def _small(cfg_cls, orb, cap, track):
    return cfg_cls(orb=orb(n_features=384, n_levels=4),
                   cap=cap(max_kf=MAX_KF, n_feat=384, max_mp=8192, max_obs=8),
                   track=track(p_local=2048), **SMALL)


@pytest.fixture(scope="module")
def runs():
    world = SyntheticWorld(SyntheticConfig(**WORLD))
    times = world.frame_times()
    inputs = []
    for i, t in enumerate(times):
        left, right = world.render_frame(t)
        inputs.append((left, right, *world.imu_window(times[i - 1] if i else t, t), float(t)))
    t_cfg = _small(TSlamConfig, TOrb, TCap, TTrack)
    systems = [("jax4", jfused.FusedSlam(world.cam, _small(JSlamConfig, JOrb, JCap, JTrack),
                                         service_every=SERVICE_EVERY, chunk=4))]
    systems += [(f"torch{c}", tfused.FusedSlam(port_camera(world.cam), t_cfg, chunk=c,
                                               service_every=SERVICE_EVERY, device="cpu"))
                for c in (1, 4, 3)]
    out = {}
    for name, slam in systems:
        n_kf_after = []
        compact_once = slam._compact_once

        def counted(slam=slam, compact_once=compact_once, n_kf_after=n_kf_after):
            compact_once()
            n_kf_after.append(int(slam.map.n_kf))

        slam._compact_once = counted
        init_frame, returned = None, []
        for i, args in enumerate(inputs):
            returned.append(slam.process_frame(*args))
            if init_frame is None and slam.imu_initialized:
                init_frame = i
        slam.finalize()
        _, ps, _ = slam.trajectory_arrays()
        _, ps_raw, _ = slam.trajectory_arrays(corrected=False)
        out[name] = dict(ps=ps, ps_raw=ps_raw, modes=slam.modes(), init_frame=init_frame,
                         n_kf_after=n_kf_after, compactions=slam.compactions,
                         kf_evictions=getattr(slam, "kf_evictions", 0),
                         mp_evictions=getattr(slam, "mp_evictions", 0),
                         n_kf=int(slam.map.n_kf), slam=slam, returned=returned)
    out["gt"] = world.gt_trajectory()[0]
    out["n"] = len(times)
    return out


@pytest.mark.parametrize("chunk", [4, 3])
def test_chunked_port_gives_the_poses_of_chunk_1(runs, chunk):
    a, b = runs["torch1"], runs[f"torch{chunk}"]
    fa, fb = a["slam"].frame_outputs(), b["slam"].frame_outputs()
    for name in ("p", "q", "v", "n_matches", "n_inliers", "mode", "is_kf", "kf_id", "ref_kf"):
        np.testing.assert_array_equal(getattr(fb, name), getattr(fa, name), err_msg=name)
    np.testing.assert_array_equal(b["ps"], a["ps"])
    assert b["n_kf_after"] == a["n_kf_after"] and b["init_frame"] == a["init_frame"]
    assert torch.equal(b["slam"].map.kf_p, a["slam"].map.kf_p)


def test_chunk_entries_stay_batched(runs):
    slam, n = runs["torch4"]["slam"], runs["n"]
    assert len(slam.outs) == n // 4 and not slam._pending
    times, out = slam.outs[0]
    assert isinstance(times, list) and len(times) == 4 and out.p.shape == (4, 3)
    assert out.mode.shape == (4,) and out.rel_q.shape == (4, 4)
    # process_frame hands back the chunk's batched FrameOut on the frame that fills it
    got = runs["torch4"]["returned"]
    assert [r is not None for r in got] == [(i + 1) % 4 == 0 for i in range(n)]
    assert got[3].p.shape == (4, 3)
    assert slam.frame_outputs().p.shape == (n, 3) and len(slam._out_epochs) == n // 4
    # chunk 3 does not divide service_every = 4: the service rounds cut chunks short
    sizes = [len(t) for t, _ in runs["torch3"]["slam"].outs]
    assert sum(sizes) == n and set(sizes) <= {1, 2, 3} and 1 in sizes


def test_compaction_fires_in_both_packages(runs):
    j, t = runs["jax4"], runs["torch4"]
    assert t["compactions"] == j["compactions"] >= 2
    assert t["n_kf_after"] == j["n_kf_after"], (t["n_kf_after"], j["n_kf_after"])
    assert t["kf_evictions"] == j["kf_evictions"] > 0
    assert t["mp_evictions"] == j["mp_evictions"] and t["n_kf"] == j["n_kf"] < MAX_KF
    slam = t["slam"]
    assert len(slam._kf_remaps) == slam.compactions
    assert slam._n_kf == slam._kf_ub == int(slam.map.n_kf)
    assert int(slam.map.kf_valid.sum()) == int(slam.map.n_kf)  # compacted: no dead row in use


def test_chunked_run_against_the_jax_package(runs):
    j, t, n = runs["jax4"], runs["torch4"], runs["n"]
    assert j["init_frame"] is not None and t["init_frame"] == j["init_frame"]
    assert t["slam"].imu_init_frame == t["init_frame"]
    np.testing.assert_array_equal(t["modes"], j["modes"])
    assert t["ps"].shape == j["ps"].shape == (n, 3) and np.isfinite(t["ps"]).all()
    np.testing.assert_allclose(t["ps"], j["ps"], rtol=0, atol=1e-2)
    np.testing.assert_allclose(t["ps_raw"], j["ps_raw"], rtol=0, atol=1e-2)
    ate = ate_rmse(t["ps"], runs["gt"][:n])
    assert ate < 0.06 and float((t["modes"] == tfused.MODE_OK).mean()) > 0.9, ate


def test_corrected_trajectory_goes_through_the_remaps(runs):
    """A frame recorded before a compaction names a keyframe row of that
    time: the export follows the row through every later remap."""
    slam = runs["torch1"]["slam"]
    outs, eps = slam.frame_outputs(), slam._flat_outs()[2]
    # (the last pass may come in the service round after the last frame)
    assert eps[0] == 0 and sorted(eps) == list(eps)
    assert slam.compactions - 1 <= eps[-1] <= slam.compactions
    moved = 0
    for i in range(runs["n"]):
        ref = int(outs.ref_kf[i])
        for km in slam._kf_remaps[eps[i]:]:
            ref = int(km[ref]) if ref >= 0 else -1
        moved += ref >= 0 and ref != int(outs.ref_kf[i])
    assert moved > 0
    # frames whose keyframe is still in the map are re-composed from it
    assert np.abs(runs["torch1"]["ps"] - runs["torch1"]["ps_raw"]).max() > 0


def test_host_reads_stay_one_a_frame(runs):
    """One flag read a frame at any chunk size; beyond them two reads per
    IMU attempt and, per compaction service, one read of the counts, one per
    pass and two per eviction decision."""
    n = runs["n"]
    for name in ("torch1", "torch4", "torch3"):
        slam = runs[name]["slam"]
        rep = slam.timing_report()
        assert rep["step.decide_and_flag_read"]["calls"] == rep["step"]["calls"] == n, name
        attempts = sum(slam.timing.get(k, [0, 0])[1] for k in ("imu_init", "imu_refine"))
        rounds = slam.timing["compaction"][1]
        extra = slam.host_syncs - n
        assert 0 < extra <= 2 * attempts + rounds + 3 * slam.compactions, (name, extra)
        parts = sum(v[0] for k, v in slam.timing.items() if k.startswith("step."))
        assert abs(parts - slam.timing["step"][0]) < 1e-3 * n, (name, parts,
                                                               slam.timing["step"][0])
    chunked = runs["torch4"]["slam"].timing_report()
    assert chunked["step.chunk_outputs"]["calls"] == n // 4
    assert chunked["step.frontend"]["calls"] == chunked["dispatch_chunk"]["calls"] == n // 4
    assert runs["torch4"]["slam"].host_syncs == runs["torch1"]["slam"].host_syncs
