"""The port's stereo-inertial path end to end against the JAX package: both
FusedSlams run the world and configuration of tests/test_fused.py (384x256,
4 s at 10 Hz, a biased gyro, use_imu=True and every production flag on:
RANSAC seed, triangulation, fusion, point statistics, keyframe culling) at
chunk=1 with service_every=4, on the same rendered frames and IMU windows;
the port on the CPU.

Held: both initialize the IMU, in the same service round; per-frame tracking
modes equal; gravity within 0.05 m/s^2; corrected trajectories within 1 cm;
the port's own ATE under 0.06 m and ok_frac above 0.9. Keyframe decisions
and feature counts are exact over the first 5 frames; after that a rare
descriptor bit flip (see test_torch_frontend.py) can move an inlier count
across the keyframe policy's gate."""
import numpy as np
import pytest

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
from torch_parity import port_camera

WORLD = dict(width=384, height=256, fx=240.0, fy=240.0, n_landmarks=600, duration=4.0,
             cam_hz=10.0, pos_amp=(1.2, 0.8, 0.3), gyro_bias=(0.003, -0.002, 0.004),
             accel_bias=(0.0, 0.0, 0.0), imu_noise=False)
SMALL = dict(ba_points=1024, use_imu=True, kf_max_frames=2, imu_init_kfs=8)
SERVICE_EVERY = 4


def _small(cfg_cls, orb, cap, track):
    return cfg_cls(orb=orb(n_features=384, n_levels=4),
                   cap=cap(max_kf=64, n_feat=384, max_mp=8192, max_obs=8),
                   track=track(p_local=2048), **SMALL)


@pytest.fixture(scope="module")
def runs():
    world = SyntheticWorld(SyntheticConfig(**WORLD))
    times = world.frame_times()
    inputs = []
    for i, t in enumerate(times):
        left, right = world.render_frame(t)
        inputs.append((left, right, *world.imu_window(times[i - 1] if i else t, t), float(t)))
    out = {}
    for name, slam in (
            ("jax", jfused.FusedSlam(world.cam, _small(JSlamConfig, JOrb, JCap, JTrack),
                                     service_every=SERVICE_EVERY)),
            ("torch", tfused.FusedSlam(port_camera(world.cam),
                                       _small(TSlamConfig, TOrb, TCap, TTrack),
                                       service_every=SERVICE_EVERY, device="cpu"))):
        init_frame = None
        for i, args in enumerate(inputs):
            slam.process_frame(*args)
            if init_frame is None and slam.imu_initialized:
                init_frame = i
        slam.finalize()
        _, ps, _ = slam.trajectory_arrays()
        if name == "jax":  # a list of per-frame FrameOuts
            outs = jfused.FrameOut(*[np.stack(f) for f in zip(*slam._flat_outs()[1])])
        else:  # one FrameOut of stacked arrays
            outs = slam._flat_outs()[1]
        out[name] = dict(ps=ps, outs=outs, modes=slam.modes(), init_frame=init_frame,
                         initialized=slam.imu_initialized, n_kf=int(slam.map.n_kf),
                         kf_valid=int(np.asarray(slam.map.kf_valid).sum()),
                         gravity=np.asarray(slam.ts.gravity_w), bg=np.asarray(slam.ts.bg),
                         imu_ok=bool(slam.ts.imu_ok), slam=slam)
    out["gt"] = world.gt_trajectory()[0]
    out["n"] = len(times)
    return out


def test_vi_slice_imu_initializes_in_the_same_round(runs):
    j, t = runs["jax"], runs["torch"]
    assert j["initialized"] and t["initialized"] and t["imu_ok"]
    assert t["init_frame"] == j["init_frame"], (t["init_frame"], j["init_frame"])
    assert (t["init_frame"] + 1) % SERVICE_EVERY == 0
    np.testing.assert_allclose(t["gravity"], j["gravity"], rtol=0, atol=0.05)
    assert 9.0 < float(np.linalg.norm(t["gravity"])) < 10.6
    np.testing.assert_allclose(t["bg"], j["bg"], rtol=0, atol=2e-3)


def test_vi_slice_modes_and_keyframes(runs):
    j, t = runs["jax"], runs["torch"]
    np.testing.assert_array_equal(t["modes"], j["modes"])
    np.testing.assert_array_equal(t["outs"].is_kf[:5], j["outs"].is_kf[:5])
    np.testing.assert_array_equal(t["outs"].n_features[:5], j["outs"].n_features[:5])
    assert abs(t["n_kf"] - j["n_kf"]) <= 2, (t["n_kf"], j["n_kf"])
    assert abs(t["kf_valid"] - j["kf_valid"]) <= 2, (t["kf_valid"], j["kf_valid"])


def test_vi_slice_trajectory(runs):
    j, t = runs["jax"], runs["torch"]
    n = runs["n"]
    assert t["ps"].shape == j["ps"].shape == (n, 3) and t["ps"].dtype == np.float32
    assert np.all(np.isfinite(t["ps"]))
    np.testing.assert_allclose(t["ps"], j["ps"], rtol=0, atol=1e-2)
    ate = ate_rmse(t["ps"], runs["gt"][:n])
    ok_frac = float((t["modes"] == tfused.MODE_OK).mean())
    assert ate < 0.06 and ok_frac > 0.9, (ate, ok_frac)


def test_vi_slice_host_reads(runs):
    """One flag read a frame, plus two reads per IMU init or refine attempt
    that reached its solve (the keyframe table and the result), plus one
    read of the row counts in each round after the IMU initialized: as on
    the JAX host, such a round is due only when the host's row bounds reach
    the capacity margin, and its capacity check reads the true counts (no
    compaction pass follows here)."""
    slam = runs["torch"]["slam"]
    attempts = slam.timing.get("imu_init", [0, 0])[1] + slam.timing.get("imu_refine", [0, 0])[1]
    checks = slam._service_round - (runs["torch"]["init_frame"] + 1) // SERVICE_EVERY
    assert slam.compactions == 0 and not slam.timing.get("imu_refine")
    assert runs["n"] + checks <= slam.host_syncs <= runs["n"] + 2 * attempts + checks
    assert "imu_init" in slam.timing_report()


def test_vi_slice_stage_times(runs):
    """timing_report() splits the step into its stages: both pose solves and
    both BAs ran (before and after the IMU initialized), every keyframe stage
    ran, and the stages' host times add up to the step's."""
    slam = runs["torch"]["slam"]
    rep = slam.timing_report()
    for stage in ("frontend", "imu_predict", "match", "ransac_seed", "pose_solve_visual",
                  "pose_solve_vi", "decide_and_flag_read", "kf_insert", "local_ba", "vi_ba",
                  "triangulate", "fuse", "point_stats", "kf_cull", "bookkeeping"):
        assert rep["step." + stage]["calls"] > 0, stage
    n = runs["n"]
    assert rep["step"]["calls"] == rep["step.frontend"]["calls"] == n
    assert rep["step.pose_solve_visual"]["calls"] + rep["step.pose_solve_vi"]["calls"] == n
    assert rep["step.pose_solve_visual"]["calls"] >= runs["torch"]["init_frame"] + 1
    assert rep["step.kf_insert"]["calls"] == int(runs["torch"]["outs"].is_kf.sum())
    parts = sum(v[0] for k, v in slam.timing.items() if k.startswith("step."))
    assert parts == pytest.approx(slam.timing["step"][0], rel=1e-9)
    assert slam.imu_init_frame == runs["torch"]["init_frame"]
    assert slam.frame_outputs().p.shape == (n, 3)


@pytest.mark.parametrize("name", ["default", "bench"])
def test_vi_configs_construct_and_run(name):
    """The production default and bench.py's odometry configuration are
    accepted as they stand (only the map is sized down to run two frames
    quickly) and run on the CPU when asked to."""
    base = TSlamConfig() if name == "default" else tfused.BENCH_CFG
    assert base.use_imu and base.ransac_fallback and base.triangulate_mono
    assert base.fuse_neighbors and base.update_point_stats and base.kf_cull_redundancy > 0
    world = SyntheticWorld(SyntheticConfig(width=256, height=160, fx=160.0, fy=160.0,
                                           n_landmarks=300, duration=0.2, cam_hz=10.0))
    full = tfused.FusedSlam(port_camera(world.cam), base, device="cpu")
    assert full.cfg == base and full.map.kf_valid.shape[0] == 256
    cfg = base._replace(orb=TOrb(n_features=128, n_levels=2),
                        cap=TCap(max_kf=8, n_feat=128, max_mp=1024, max_obs=4),
                        track=TTrack(p_local=512), ba_points=512)
    slam = tfused.FusedSlam(port_camera(world.cam), cfg, device="cpu")
    times = world.frame_times()[:2]
    for i, t in enumerate(times):
        left, right = world.render_frame(t)
        out = slam.process_frame(left, right, *world.imu_window(times[i - 1] if i else t, t),
                                 float(t))
    slam.finalize()
    assert int(out.mode) == tfused.MODE_OK and int(slam.map.n_kf) >= 1
    # one flag read a frame, and the capacity check of the final service round
    # (the 1024-row point array is within two spawn budgets of full)
    assert not slam.imu_initialized and 2 <= slam.host_syncs <= 3
    if name == "bench":
        assert (cfg.kf_max_frames, cfg.ba_iters, cfg.ba_window, cfg.lost_timeout) == (6, 3, 6, 5.0)
