"""The benchmark's arithmetic on made-up numbers: rates over the whole
window, tails over every frame, the FAST/NMS byte count, the trace's
reduction, the readers."""
import numpy as np
import pytest

from slambench import manifest, roofline, stats
from slambench.harness import WindowRecord
from slambench.trace import Trace


def test_rate_is_over_the_whole_window():
    # 10 frames in 5 s are 2 frames/s whatever their spacing
    assert stats.rate(10, 5.0) == 2.0


def test_p90_is_over_every_frame():
    lat = [0.1] * 90 + [1.0] * 10
    assert stats.percentile(lat, 90) == pytest.approx(0.1 + 0.1 * 0.9)
    lat = list(range(1, 101))
    assert stats.percentile(lat, 90) == pytest.approx(90.1)


def test_fast_nms_bytes_752x480_8_levels():
    b = roofline.fast_nms_bytes(480, 752, 8, 1.2, images=2)
    assert b == 2234734 * 8  # PERF.md §6: 2,234,734 pixels a stereo pair
    assert round(b / 1e6, 1) == 17.9
    assert b / 3.35e12 == pytest.approx(5.34e-6, rel=1e-3)


def test_ate_matches_the_program_metric():
    from orbslam3_tpu_torch.eval.metrics import ate_rmse

    rng = np.random.default_rng(3)
    gt = rng.normal(size=(50, 3))
    R, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    R *= np.sign(np.linalg.det(R))
    est = (R @ gt.T).T + 0.3 + rng.normal(scale=0.01, size=gt.shape)
    err, _, _ = stats.aligned_errors(est, gt)
    assert stats.rmse(err) == pytest.approx(ate_rmse(est, gt), rel=1e-9)


def test_box_distance():
    half = [5.0, 5.0, 2.0]
    pts = np.array([[5.0, 0, 0], [4.0, 0, 0], [0, 0, 1.5], [6.0, 0, 0], [0, 0, 0]])
    assert np.allclose(stats.box_distance(pts, half), [0.0, 1.0, 0.5, 1.0, 2.0])


def _trace(device, t0=1000, t1=2000):
    tr = Trace(False)
    tr.device = device
    tr.t0 = {"perf": t0, "real": t0}
    tr.t1 = {"perf": t1, "real": t1}
    tr.clock = "perf"
    return tr


def test_trace_busy_union_and_idle_attribution():
    tr = _trace([("k_a", 1100, 1300), ("k_b", 1200, 1400), ("fast_nms_kernel", 1800, 1900),
                 ("k_c", 900, 1050)])
    # union inside the window: [1000,1050] + [1100,1400] + [1800,1900] = 450 ns
    assert tr.busy_s() == pytest.approx(450e-9)
    assert tr.kernel_seconds("fast_nms") == (1, pytest.approx(100e-9))
    assert tr.top_ops(2)[0][0] == "k_a"
    spans = [("step.pose", 1400e-9, 1800e-9), ("process_frame", 1000e-9, 2000e-9)]
    idle = dict(tr.idle_by_host(spans))
    assert idle["step.pose"] == pytest.approx(400e-9)
    assert idle["process_frame"] == pytest.approx(150e-9)
    assert sum(idle.values()) == pytest.approx(550e-9)


def _record(**kw):
    base = dict(cell="euroc_mh_vi.steady", config=manifest.read_json(
        manifest.config_file(manifest.load(), "euroc_mh_vi")), frames=10, keyframes=2,
        window_s=5.0, counters={"timing": {"step.frontend": [0.5, 10],
                                           "step.pose_solve_vi": [3.0, 10],
                                           "step.kf_insert": [0.1, 2], "step.vi_ba": [0.5, 2],
                                           "host_services": [0.2, 1]},
                                "host_syncs": 12},
        device_kind="NVIDIA H100 80GB HBM3")
    base.update(kw)
    return WindowRecord(**base)


@pytest.mark.parametrize("name,value", [
    ("frontend_ms", 50.0), ("pose_solve_ms", 300.0), ("kf_branch_ms", 300.0),
    ("host_services_ms", 20.0), ("host_syncs", 1.2)])
def test_span_readers(name, value):
    assert manifest.load_reader(name)(_record()) == pytest.approx(value)


def test_roofline_reader_and_silence():
    read = manifest.load_reader("fast_nms_roofline")
    assert read(_record()) is None  # no trace: nothing to read
    # 10 frames, each 17.9 MB: 53.4 us of bound; 10 launches of 41 us
    tr = _trace([("fast_nms_kernel", 1000 + 100000 * i, 1000 + 100000 * i + 41000)
                 for i in range(10)], t0=0, t1=10**7)
    v = read(_record(trace=tr))
    assert v == pytest.approx(100 * 10 * 17877872 / 3.35e12 / 410e-6)
    assert read(_record(trace=_trace([("other", 0, 10)]))) is None
    idle = manifest.load_reader("device_idle")(_record(trace=tr))
    assert idle == pytest.approx(100 * (1 - 410e-6 / 10e-3))


TWINS = [m["name"] for m in manifest.load()["per_layer"] if m["name"].endswith(".steady")
         and manifest.reader_file(m["name"][:-len(".steady")]).is_file()]


def test_every_cold_layer_metric_has_a_steady_twin():
    cold = [m["name"] for m in manifest.load()["per_layer"] if not m["name"].endswith(".steady")]
    assert sorted(TWINS) == sorted(n + ".steady" for n in cold)


@pytest.mark.parametrize("name", TWINS)
def test_steady_twin_reads_as_its_reader(name):
    """A `.steady` metric is its reader's number under the steady cell's
    name (it moves setup_s there, BENCHMARK.json)."""
    base = name[:-len(".steady")]
    rec = _record(latencies=[0.5, 0.7, 0.6, 1.9, 0.55])
    assert manifest.load_reader(name)(rec) == manifest.load_reader(base)(rec)


def test_traced_rate_and_tail_readers():
    lat = [0.1 * i for i in range(1, 11)]
    rec = _record(latencies=lat)
    assert manifest.load_reader("tracked_fps.traced.steady")(rec) == pytest.approx(2.0)
    assert manifest.load_reader("frame_latency_p90_ms.traced")(rec) == pytest.approx(910.0)
    empty = _record(frames=0, latencies=[])
    assert manifest.load_reader("tracked_fps.traced.steady")(empty) is None
    assert manifest.load_reader("frame_latency_p90_ms.traced")(empty) is None
