"""Launches and device time by span (slambench/launches.py) on made-up
events, the stage readers and the launch check, the host_sync_wait_ms and
pose_row_inlier_share readers, and on a card the profiler's launches
counted inside a span of the host's clock."""
import time

import numpy as np
import pytest

from slambench import manifest
from slambench.harness import WindowRecord
from slambench.launches import Launches, union_s

T0, PERF0 = 1_000, 50_000  # the window's start on the trace's clock and on perf_counter_ns


def _spans():
    """Two frames' program spans, (name, frame, t0_ns, t1_ns) on perf_counter_ns."""
    rel = [("step", 0, 0, 100), ("step.a", 0, 0, 40), ("step.b", 0, 40, 100),
           ("sync_wait", 0, 50, 60), ("step", 1, 200, 300), ("step.a", 1, 200, 300)]
    return [(n, f, PERF0 + a, PERF0 + b) for n, f, a, b in rel]


HOST = [(1, 10, "cudaLaunchKernel"), (1, 12, "cuLaunchKernel"),  # one launch, two calls
        (2, 45, "cudaLaunchKernel"), (3, 55, "cudaMemcpyAsync"),  # 3: a copy inside the wait
        (4, 210, "cudaGraphLaunch"),  # a graph launch: three kernels, one launch
        (5, 150, "cudaMemsetAsync"),  # between the frames' spans
        (6, 70, "cudaStreamSynchronize")]  # no work on the device
DEVICE = [(1, 20, 30), (2, 120, 180),  # 2 runs after its span closed
          (3, 56, 58), (4, 220, 230), (4, 225, 240), (4, 250, 260), (5, 160, 170),
          (99, 0, 5)]  # launched before the window


def _launches(host=HOST, device=DEVICE):
    return Launches.from_events([(c, T0 + s, n) for c, s, n in host],
                                [(c, T0 + s, T0 + e) for c, s, e in device], T0, PERF0)


def test_union_of_intervals():
    iv = np.array([[0, 10], [5, 20], [20, 25], [30, 40], [32, 35]])
    assert union_s(iv) == pytest.approx(35e-9)
    assert union_s(np.zeros((0, 2), np.int64)) == 0.0


def test_launch_in_its_innermost_span_and_device_time_after_it_closed():
    lz = _launches()
    assert len(lz.at) == 5  # ids 1-5; 6 made no device work
    every = _spans()
    assert lz.by_name(every) == {"step": [0, 0.0], "step.a": [2, pytest.approx(40e-9)],
                                 "step.b": [1, pytest.approx(60e-9)],
                                 "sync_wait": [1, pytest.approx(2e-9)]}
    # among the step's spans alone, the copy made inside the wait is its stage's
    steps = [s for s in every if s[0].startswith("step")]
    assert lz.work(steps, {"step.b"}) == (2, pytest.approx(62e-9))
    # a graph launch is one launch, its kernels' time the union of theirs
    assert lz.work(steps[4:], {"step.a"}) == (1, pytest.approx(30e-9))
    # the launches of the stages are those inside the steps
    inside = int((lz.owners([s for s in steps if s[0] == "step"]) >= 0).sum())
    assert inside == sum(lz.work(steps, {n})[0] for n in ("step.a", "step.b")) == 4
    assert lz.work([], {"step"}) == (0, 0.0)


@pytest.mark.parametrize("lost", [False, True])
def test_launch_calls_by_name_check_the_ids(lost):
    """Every launch, copy, set or graph launch call found its device work by
    id: the calls by name equal the launches. A kernel whose id is lost
    leaves its call counted and its launch missing."""
    device = [d for d in DEVICE if not (lost and d[0] == 2)]
    lz = _launches(device=device)
    assert lz.calls == 5
    assert len(lz.at) == (4 if lost else 5)
    assert int((lz.dev_of < 0).sum()) == 1  # the activity launched before the window


def _stage_record(lz, frames=2, keyframes=1):
    rel = [("step", 0, 0, 100), ("step.pose_solve_vi", 0, 0, 40), ("step.kf_insert", 0, 40, 100),
           ("sync_wait", 0, 50, 60), ("step", 1, 200, 300), ("step.pose_solve_visual", 1, 200, 300)]
    spans = [(n, f, PERF0 + a, PERF0 + b) for n, f, a, b in rel]
    timing = {"step.pose_solve_vi": [0.001, 1], "step.pose_solve_visual": [0.002, 1],
              "step.kf_insert": [0.004, 1], "step": [0.007, 2]}
    return WindowRecord(cell="euroc_mh_vi.steady", config={}, frames=frames, keyframes=keyframes,
                        window_s=5.0, counters={"timing": timing}, spans=spans, launches=lz)


def test_stage_figures_and_their_checks():
    """The stage readers: launches and device time of the pose solve a
    frame and of the keyframe branch a keyframe, host time a launch, and
    both checks."""
    rec = _stage_record(_launches())
    read = {n: manifest.load_reader(n)(rec) for n in (
        "pose_solve_launches", "pose_solve_busy_ms", "kf_branch_launches", "kf_branch_busy_ms",
        "pose_solve_ms")}
    # the pose solve: ids 1 and 4 (a graph's three kernels, one launch)
    assert read["pose_solve_launches"] == 1.0
    assert read["pose_solve_busy_ms"] == pytest.approx(1e3 * 40e-9 / 2)
    # host µs a launch, from the two readers
    assert 1e3 * read["pose_solve_ms"] / read["pose_solve_launches"] == pytest.approx(
        1e6 * 0.003 / 2)
    # the keyframe branch: ids 2 (ran after its span) and 3 (inside the wait)
    assert read["kf_branch_launches"] == 2.0
    assert read["kf_branch_busy_ms"] == pytest.approx(1e3 * 62e-9)
    assert rec.stage_work("step.kf_insert") == (2, pytest.approx(62e-9))
    assert rec.step_attribution()[2] == {"in_step_spans": 4, "in_stage_spans": 4, "launches": 5,
                                         "launch_calls": 5, "activities": 8,
                                         "activities_unmatched": 1, "holds": True}


@pytest.mark.parametrize("name", ["pose_solve_launches", "pose_solve_busy_ms",
                                  "kf_branch_launches", "kf_branch_busy_ms"])
def test_stage_readers_silent_without_launches(name):
    """Nothing to read without the trace's launches, or without frames or
    keyframes; a window whose correlation check falls short (a kernel's id
    lost) still reads, its check logged beside it."""
    read = manifest.load_reader(name)
    assert read(_stage_record(None)) is None
    assert read(_stage_record(_launches(), frames=0, keyframes=0)) is None
    lost = _stage_record(_launches(device=[d for d in DEVICE if d[0] != 2]))
    assert not lost.step_attribution()[2]["holds"]
    assert read(lost) is not None


def test_pose_row_inlier_share_reader():
    read = manifest.load_reader("pose_row_inlier_share")
    rec = WindowRecord(cell="euroc_mh_vi.steady", config={"slam": {"cap": {"n_feat": 1200}}},
                       frames=10, keyframes=1, window_s=5.0,
                       counters={"timing": {}, "inliers": 3000})
    assert read(rec) == pytest.approx(25.0)
    rec.counters = {"timing": {}}
    assert read(rec) is None


def test_without_correlation_ids_there_is_nothing_to_read():
    host = [(0, T0 + 10, "cudaLaunchKernel"), (7, T0 + 45, "cudaLaunchKernel")]
    device = [(0, T0 + 20, T0 + 30), (8, T0 + 50, T0 + 52)]
    assert Launches.from_events(host, device, T0, PERF0) is None


def _record(timing, frames=10):
    return WindowRecord(cell="euroc_mh_vi.steady", config={}, frames=frames, keyframes=1,
                        window_s=5.0, counters={"timing": timing, "host_syncs": frames})


def test_host_sync_wait_reader():
    read = manifest.load_reader("host_sync_wait_ms")
    timing = {"step.frontend": [0.5, 10], "sync_wait": [0.03, 12]}
    assert read(_record(timing)) == pytest.approx(3.0)
    # a program without the timer, or a window without frames: nothing to read
    assert read(_record({"step.frontend": [0.5, 10]})) is None
    assert read(_record(timing, frames=0)) is None


@pytest.mark.gpu
def test_span_counts_its_launches_on_the_card(cuda_device):
    """A span of the host's clock around 40 kernel launches and one replay
    of a graph of 5 holds exactly 41 launches, and their 45 kernels ran
    inside the traced window, after the kernel launched before the span.
    (The trace's device stamps run some tens of microseconds early against
    its host stamps on the card, so a kernel is not held to start after its
    own host call.)"""
    import torch

    from slambench.trace import Trace

    x = torch.zeros(1 << 16, device=cuda_device)
    stream = torch.cuda.Stream()
    with torch.cuda.stream(stream):
        x.add_(1.0)  # warm up outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(5):
            x.mul_(1.0)
    torch.cuda.synchronize()
    with Trace(True, True) as tr:
        x.add_(1.0)  # before the span
        torch.cuda.synchronize()
        t0 = time.perf_counter_ns()
        for _ in range(40):
            x.add_(1.0)
        graph.replay()
        t1 = time.perf_counter_ns()
        torch.cuda.synchronize()
    lz = Launches.from_trace(tr)
    assert lz is not None and len(lz.at) == lz.calls == 42
    spans = [("probe", 0, t0, t1)]
    assert lz.work(spans, {"probe"})[0] == 41
    own = lz.owners(spans)
    assert own.tolist() == [-1] + [0] * 41
    ran = lz.dev[(lz.dev_of >= 0) & (own[np.clip(lz.dev_of, 0, None)] == 0)]
    before = lz.dev[lz.dev_of == 0]
    window = tr.t1[tr.clock] - tr.t0[tr.clock]
    assert len(ran) == 45 and len(before) == 1
    assert (ran[:, 0] >= before[0, 1]).all() and (ran[:, 1] <= window).all()
