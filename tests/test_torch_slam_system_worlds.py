"""The port's SlamSystem on the atlas and static worlds, the fleet's
make_multi_session_step and scripts/profile_pipeline_torch.py, on the CPU.

The atlas world of tests/test_atlas.py (a 1 s camera blackout, lost_timeout
0.3 s) cut to 3.6 s, past the new map, and the static world of
tests/test_recovery.py::test_static_start_triggers_bad_imu_reset cut to
9.5 s, past the bad-IMU reset, each run by the JAX SlamSystem and by the
port's fed the JAX front end's features: n_maps_created, kf_map_id,
kf_valid, active_map and bad_imu_resets exact. The fleet's step against
MultiSessionSlam.flush bit for bit, and its valid mask; the profiling script
at a small size prints every stage of scripts/profile_pipeline.py."""
import numpy as np
import pytest
import torch

import chip_smoke
from orbslam3_tpu.io.synthetic import SyntheticConfig, SyntheticWorld
from orbslam3_tpu_torch.map.slam_map import MapCapacity as TCap
from slam_system_parity import clear_jax, configs, jax_run, port_run
from torch_parity import SMALL_WORLD

# the shortened atlas and static worlds: past the map change and the reset
SHORT = {"atlas": 3.6, "static": 9.5}


@pytest.fixture(scope="module")
def shortened():
    """The atlas and static worlds, shortened, JAX and the port fed its
    features."""
    out = {}
    for name, duration in SHORT.items():
        (wkw, _, blackout), (jcfg, tcfg) = chip_smoke.SLAM_SYSTEM_WORLDS[name], configs(name)
        world = SyntheticWorld(SyntheticConfig(**dict(wkw, duration=duration)))
        inputs = chip_smoke.slam_system_inputs(world, blackout)
        j = jax_run(world, jcfg, inputs)
        clear_jax()
        out[name] = dict(jax=j["slam"], port=port_run(world, tcfg, inputs, fed=j["frames"])["slam"])
    yield out
    clear_jax()


@pytest.mark.parametrize("name", list(SHORT))
def test_fed_atlas_and_static_worlds(shortened, name):
    """The atlas's map ids and the static start's reset exact."""
    j, t = shortened[name]["jax"], shortened[name]["port"]
    assert t.n_maps_created == j.n_maps_created
    assert t.bad_imu_resets == getattr(j, "bad_imu_resets", 0)
    np.testing.assert_array_equal(t.map.kf_map_id.numpy(), np.asarray(j.map.kf_map_id))
    np.testing.assert_array_equal(t.map.kf_valid.numpy(), np.asarray(j.map.kf_valid))
    assert int(t.map.active_map) == int(j.map.active_map)
    assert t.imu_initialized == j.imu_initialized
    if name == "atlas":
        assert t.n_maps_created >= 2
    else:
        assert t.bad_imu_resets >= 1 and not t.imu_initialized


# ---------------------------------------------------------------- the fleet
FLEET_CHUNK = 3


@pytest.fixture(scope="module")
def fleet():
    """Two sessions on the CPU, 5 and 2 frames of two small worlds: the
    MultiSessionSlam run, and its inputs."""
    from orbslam3_tpu_torch.io import synthetic as tsyn
    from orbslam3_tpu_torch.parallel.multi_session import MultiSessionSlam

    cfg = configs("inertial")[1]._replace(cap=TCap(max_kf=16, n_feat=384, max_mp=2048))
    streams = []
    for seed, n in ((0, 5), (1, 2)):
        w = tsyn.SyntheticWorld(tsyn.SyntheticConfig(**dict(SMALL_WORLD, seed=seed)))
        times = w.frame_times()[:n]
        streams.append((w, [(*w.render_frame(t), *w.imu_window(times[i - 1] if i else t, t),
                             float(t)) for i, t in enumerate(times)]))
    ms = MultiSessionSlam(streams[0][0].cam, cfg, n_sessions=2, chunk=FLEET_CHUNK,
                          devices=["cpu", "cpu"])
    for i in range(5):
        for s, (_, frames) in enumerate(streams):
            if i < len(frames):
                ms.process_frame(s, *frames[i])
    ms.finalize()
    return dict(ms=ms, cfg=cfg, streams=streams)


def _fleet_batches(streams, cfg, lo, hi):
    """Frames [lo, hi) of each stream as the (D, chunk, ...) step inputs,
    slots past a stream's end zero (as MultiSessionSlam.flush pads them);
    returns (batches, valid)."""
    from orbslam3_tpu_torch.imu.preintegration import pad_imu_window

    def slot(frame):
        left, right, g, a, d, t = frame
        return (np.asarray(left, np.uint8), np.asarray(right, np.uint8),
                *pad_imu_window(g, a, d, cfg.max_imu_per_frame), np.float32(t))

    blank = tuple(np.zeros_like(x) for x in slot(streams[0][1][0]))
    valid = np.array([[i < len(frames) for i in range(lo, hi)] for _, frames in streams])
    rows = [[slot(frames[i]) if i < len(frames) else blank for i in range(lo, hi)]
            for _, frames in streams]
    return [np.stack([np.stack([r[k] for r in sr]) for sr in rows]) for k in range(7)], valid


def test_multi_session_step_equals_flush(fleet):
    """The fleet's step called directly on the same slots gives the flushes'
    outputs and states bit for bit."""
    from orbslam3_tpu_torch.map.slam_map import empty_map
    from orbslam3_tpu_torch.models.fused import FrameOut, TrackState
    from orbslam3_tpu_torch.parallel.multi_session import make_multi_session_step

    ms, cfg, streams = fleet["ms"], fleet["cfg"], fleet["streams"]
    step = make_multi_session_step(["cpu", "cpu"], streams[0][0].cam, cfg)
    sts = [empty_map(cfg.cap, device="cpu") for _ in range(2)]
    tss = [TrackState.initial("cpu") for _ in range(2)]
    lo = 0
    for times, outs, valid in ms.outs:
        c = valid.shape[1]
        batches, v = _fleet_batches(streams, cfg, lo, lo + c)
        np.testing.assert_array_equal(v, valid)
        sts, tss, got = step(sts, tss, *batches, v)
        for s in range(2):
            for f in FrameOut._fields:
                assert torch.equal(getattr(got[s], f), getattr(outs[s], f)), (lo, s, f)
        lo += c
    for s in range(2):
        assert all(torch.equal(a, b) for a, b in zip(sts[s], ms.maps[s])
                   if isinstance(a, torch.Tensor))
    assert ms.launches == [2, 1]


def test_multi_session_step_valid_mask(fleet):
    """A valid=False slot between two valid ones: its session steps the two
    frames as consecutive ones and records the placeholder of its state
    between them; an all-False session is untouched."""
    from orbslam3_tpu_torch.map.slam_map import empty_map
    from orbslam3_tpu_torch.models.fused import FrameOut, TrackState
    from orbslam3_tpu_torch.parallel.multi_session import make_multi_session_step

    cfg, streams = fleet["cfg"], fleet["streams"]
    step = make_multi_session_step(["cpu", "cpu"], streams[0][0].cam, cfg)
    batches, _ = _fleet_batches(streams, cfg, 0, 3)
    # slot 1 of session 0 carries frame 1's data but is masked; slot 2 is frame 1
    for b in batches:
        b[0, 2] = b[0, 1]
    valid = np.array([[True, False, True], [False, False, False]])
    fresh = lambda: ([empty_map(cfg.cap, device="cpu") for _ in range(2)],  # noqa: E731
                     [TrackState.initial("cpu") for _ in range(2)])
    sts, tss = fresh()
    sts, tss, outs = step(sts, tss, *batches, valid)
    ref_sts, ref_tss = fresh()
    ref = step(ref_sts, ref_tss, *[b[:, [0, 2]] for b in batches],
               np.array([[True, True], [False, False]]))
    for f in FrameOut._fields:
        assert torch.equal(getattr(outs[0], f)[[0, 2]], getattr(ref[2][0], f)), f
    assert int(outs[0].n_matches[1]) == 0 and int(outs[0].kf_id[1]) == -1
    assert torch.equal(outs[0].p[1], outs[0].p[0])  # the placeholder: the state after slot 0
    assert int(outs[1].n_kf[0]) == 0 and not bool(outs[1].is_kf.any())
    blank = empty_map(cfg.cap, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(sts[1], blank) if isinstance(a, torch.Tensor))


def test_profile_pipeline_torch_small(capsys):
    """scripts/profile_pipeline_torch.py on the CPU at the small size prints
    every stage of scripts/profile_pipeline.py, with finite times."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(__file__)), "scripts",
                        "profile_pipeline_torch.py")
    spec = importlib.util.spec_from_file_location("profile_pipeline_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out = mod.profile("cpu", small=True)
    text = capsys.readouterr().out
    jax_script = open(os.path.join(os.path.dirname(path), "profile_pipeline.py")).read()
    for name in mod.STAGES:
        assert name in jax_script
        assert f"{name}: host" in text
        assert np.isfinite(out[name]["device_ms"]) and out[name]["launches"] == 0
