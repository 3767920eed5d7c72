"""Launches and device time by host span, through the correlation ids of a
`--trace 1` run's profiler trace (slambench/trace.py::Trace).

CUPTI gives every host call that puts work on the device (a kernel launch,
an asynchronous copy or set, a graph launch) a correlation id, and each
kernel, copy and set that the call produced carries the same id. A launch
here is one id that has a host call and at least one device activity (a
graph launch's kernels are one launch), at the time of its first host call.
Each launch belongs to the innermost span that contains that time, and its
activities' device time goes with it wherever they ran, also after the span
closed: that holds whether the step is host-bound, device-bound or replayed
from a graph, where a span's own clock reads only the host's part.

The ids are checked by name as well: `calls` counts the window's host calls
named as a kernel launch, a copy, a set or a graph launch, whether or not
any device work carries their id. Where every such call found its device
work, and nothing else did, it equals the number of launches.

A trace in which no host call shares an id with a device activity gives
None: nothing to read, never a count of zero. (On the H100 every kernel,
copy and set carries the id of its host call, and a graph's kernels that of
the graph launch.)

Spans are the program's (`FusedSlam.spans`: name, frame, t0_ns, t1_ns on
time.perf_counter_ns), the clock `Trace` matched against the profiler's.
The per-layer readers take the step's ("step" and its parts "step.<stage>",
which tile it) through slambench/harness.py::WindowRecord.stage_work; the
harness logs `launch_check` beside them. A host call by a launch's name
that puts no work on the device leaves the second check short by one
without any id lost.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

# host API calls that put work on the device, by the start of their names
LAUNCH_CALLS = ("cudaLaunch", "cuLaunch", "cudaGraphLaunch", "cuGraphLaunch", "cudaMemcpy",
                "cuMemcpy", "cudaMemset", "cuMemset")


@dataclass
class Launches:
    """The window's launches and device activities, in ns from the window's
    start on the profiler's clock."""

    at: np.ndarray  # (L,) each launch's first host call
    dev: np.ndarray  # (D, 2) each device activity's start and end
    dev_of: np.ndarray  # (D,) the launch each activity came from, -1 for none in the window
    perf0: int  # time.perf_counter_ns at the window's start
    calls: int  # host calls named in LAUNCH_CALLS, one an id

    @classmethod
    def from_events(cls, host, device, t0: int, perf0: int) -> "Launches | None":
        """`host`: (correlation id, start ns, name) of each host call;
        `device`: (correlation id, start ns, end ns) of each device activity;
        `t0`: the window's start on their clock."""
        ids = {c for c, _, _ in device if c}
        first = {}
        for c, s, _ in host:
            if c in ids and s < first.get(c, s + 1):
                first[c] = s
        if not first:
            return None
        index = {c: i for i, c in enumerate(first)}
        return cls(at=np.array(list(first.values()), np.int64) - t0,
                   dev=np.array([(s - t0, e - t0) for _, s, e in device], np.int64),
                   dev_of=np.array([index.get(c, -1) for c, _, _ in device], np.int64),
                   perf0=perf0,
                   calls=len({c for c, _, n in host if n.startswith(LAUNCH_CALLS)}))

    @classmethod
    def from_trace(cls, trace) -> "Launches | None":
        """From a Trace that ran its profiler; None without one."""
        if trace is None or trace.prof is None or trace.clock is None:
            return None
        from torch.autograd import DeviceType

        host, device = [], []
        for e in trace.prof.profiler.kineto_results.events():
            start = e.start_ns()
            if e.device_type() == DeviceType.CUDA:
                device.append((e.correlation_id(), start, start + e.duration_ns()))
            else:
                host.append((e.correlation_id(), start, e.name()))
        return cls.from_events(host, device, trace.t0[trace.clock], trace.t0["perf"])

    def owners(self, spans) -> np.ndarray:
        """(L,) the index in `spans` of the innermost span that contains
        each launch's host call, -1 where none does."""
        out = np.full(len(self.at), -1, np.int64)
        if not spans or not len(self.at):
            return out
        a = np.array([s[2] for s in spans], np.int64) - self.perf0
        b = np.array([s[3] for s in spans], np.int64) - self.perf0
        edges = np.unique(np.concatenate([a, b]))
        seg = np.full(len(edges), -1, np.int64)  # the innermost span from each edge on
        for i in np.argsort(a - b, kind="stable"):  # longest first, inner spans paint over
            seg[np.searchsorted(edges, a[i]):np.searchsorted(edges, b[i])] = i
        k = np.searchsorted(edges, self.at, side="right") - 1
        return np.where(k >= 0, seg[np.clip(k, 0, None)], -1)

    def work(self, spans, names, own=None) -> tuple[int, float]:
        """(launches, device seconds) of the launches whose innermost span
        in `spans` is named in `names`: the union of their activities'
        intervals, wherever they ran. `own`: `owners(spans)`, if known."""
        own = self.owners(spans) if own is None else own
        named = np.array([s[0] in names for s in spans] + [False], bool)  # own -1 reads False
        hit = named[own]
        mine = (self.dev_of >= 0) & hit[self.dev_of]
        return int(hit.sum()), union_s(self.dev[mine])

    def by_name(self, spans) -> dict:
        """{span name: [launches, device seconds]} over every name in
        `spans`, each launch in its innermost span."""
        own = self.owners(spans)
        return {n: list(self.work(spans, {n}, own)) for n in sorted({s[0] for s in spans})}


def step_spans(spans) -> list:
    """The program's "step" spans and their "step.<stage>" parts."""
    return [s for s in spans if s[0] == "step" or s[0].startswith("step.")]


def launch_check(lz: Launches, steps, own) -> dict:
    """Two checks on a window's attribution (`own`: `lz.owners(steps)`), and
    whether both hold:

    * the innermost-span assignment: every launch inside a "step" span lands
      in one of its parts (`in_step_spans` == `in_stage_spans`; the parts tile
      the step, so this tests the assignment alone);
    * the correlation: every host call that launches, copies or sets found
      its device work by id (`launches` == `launch_calls`); the window's
      device activities that found no launch are those launched before it.
    """
    part = np.array([s[0] != "step" for s in steps] + [False], bool)  # own -1 reads False
    out = {"in_step_spans": int((lz.owners([s for s in steps if s[0] == "step"]) >= 0).sum()),
           "in_stage_spans": int(part[own].sum()), "launches": len(lz.at),
           "launch_calls": lz.calls, "activities": len(lz.dev_of),
           "activities_unmatched": int((lz.dev_of < 0).sum())}
    out["holds"] = (out["in_step_spans"] == out["in_stage_spans"]
                    and out["launches"] == out["launch_calls"])
    return out


def union_s(iv: np.ndarray) -> float:
    """Seconds covered by the union of (n, 2) ns intervals."""
    if not len(iv):
        return 0.0
    iv = iv[np.argsort(iv[:, 0], kind="stable")]
    reach = np.maximum.accumulate(iv[:, 1])
    first = np.flatnonzero(np.r_[True, iv[1:, 0] > reach[:-1]])  # each merged run's first
    last = np.r_[first[1:] - 1, len(iv) - 1]
    return float((reach[last] - iv[first, 0]).sum()) * 1e-9
