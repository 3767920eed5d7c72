"""The device trace of a `--trace 1` run, reduced to what the readers need.

`Trace` wraps torch.profiler over the measured window with CUDA activity
only (CPU operator events would multiply the profiler's cost a launch).
From the raw events it keeps each device activity (kernel, copy, set) as
(name, start, end) in nanoseconds, and the host spans that the harness
recorded (slambench/harness.py) on the profiler's own clock, so that an
idle gap on the device can be named by what the host was doing then.
"""
from __future__ import annotations

import time
from collections import defaultdict

import numpy as np

_CLOCKS = (("perf", time.perf_counter_ns), ("real", time.time_ns))


class Trace:
    def __init__(self, enabled: bool, cuda: bool = True):
        self.enabled = enabled
        self.cuda = cuda
        self.prof = None
        self.device = []  # (name, start_ns, end_ns) on the profiler's clock
        self.t0 = {}  # each host clock at the window's start
        self.t1 = {}
        self.clock = None  # the host clock the profiler's timestamps follow

    def __enter__(self):
        if self.enabled:
            from torch.profiler import ProfilerActivity, profile

            # a CPU run (the benchmark's own tests) traces host operators:
            # it has no device activity to read
            self.prof = profile(activities=[ProfilerActivity.CUDA if self.cuda
                                            else ProfilerActivity.CPU])
            self.prof.__enter__()
        self.t0 = {k: f() for k, f in _CLOCKS}
        return self

    def __exit__(self, *exc):
        self.t1 = {k: f() for k, f in _CLOCKS}
        if self.prof is not None:
            self.prof.__exit__(*exc)
            self._collect()
        return False

    def _collect(self):
        from torch.autograd import DeviceType

        host_first = None
        for e in self.prof.profiler.kineto_results.events():
            start = e.start_ns()
            if e.device_type() == DeviceType.CUDA:
                self.device.append((e.name(), start, start + e.duration_ns()))
            elif host_first is None or start < host_first:
                host_first = start
        first = host_first if host_first is not None else min(
            (s for _, s, _ in self.device), default=None)
        if first is not None:
            # the clock on which the first event fell inside the window
            for k, _ in _CLOCKS:
                if self.t0[k] - 10**9 <= first <= self.t1[k] + 10**9:
                    self.clock = k
                    break

    @property
    def window_s(self) -> float:
        return (self.t1["perf"] - self.t0["perf"]) * 1e-9

    def intervals(self) -> np.ndarray:
        """Device activity inside the window, merged: (n, 2) ns from the
        window's start."""
        if getattr(self, "_merged", None) is not None:
            return self._merged
        merged = []
        if self.device:
            lo = self.t0[self.clock or "real"]
            hi = self.t1[self.clock or "real"]
            iv = np.clip(np.array([(s - lo, e - lo) for _, s, e in self.device], np.float64),
                         0.0, float(hi - lo))
            iv = iv[iv[:, 1] > iv[:, 0]]
            iv = iv[np.argsort(iv[:, 0], kind="stable")]
            for s, e in iv.tolist():
                if merged and s <= merged[-1][1]:
                    merged[-1][1] = max(merged[-1][1], e)
                else:
                    merged.append([s, e])
        self._merged = np.array(merged) if merged else np.zeros((0, 2))
        return self._merged

    def busy_s(self) -> float:
        iv = self.intervals()
        return float((iv[:, 1] - iv[:, 0]).sum() * 1e-9)

    def _busy_before(self, x: np.ndarray) -> np.ndarray:
        """Device busy ns before each time x (ns from the window's start)."""
        iv = self.intervals()
        if len(iv) == 0:
            return np.zeros_like(x)
        length = iv[:, 1] - iv[:, 0]
        cum = np.concatenate([[0.0], np.cumsum(length)])
        k = np.searchsorted(iv[:, 0], x, side="right") - 1
        kk = np.clip(k, 0, len(iv) - 1)
        part = np.clip(x - iv[kk, 0], 0.0, length[kk])
        return np.where(k >= 0, cum[kk] + part, 0.0)

    def kernel_seconds(self, pattern: str):
        """(launches, total seconds) of device activities whose name holds
        `pattern`."""
        hits = [(e - s) for n, s, e in self.device if pattern in n]
        return len(hits), sum(hits) * 1e-9

    def top_ops(self, n: int = 10, width: int = 160):
        """The n device operations that took most time, [name, seconds],
        names cut to `width` characters (a template's full signature says
        no more)."""
        by = defaultdict(float)
        for name, s, e in self.device:
            by[name[:width]] += (e - s) * 1e-9
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_by_host(self, spans, n: int = 10):
        """The device's idle time inside the window, summed by the innermost
        host span (name, start_s, end_s on time.perf_counter) that covers
        it; "unattributed" for idle time that no span covers."""
        if self.clock is None:
            return []
        span = float(self.t1[self.clock] - self.t0[self.clock])
        sp = [(max(a * 1e9 - self.t0["perf"], 0.0), min(b * 1e9 - self.t0["perf"], span), name)
              for name, a, b in spans]
        sp = [x for x in sp if x[1] > x[0]]
        by = defaultdict(float)
        if sp:
            a = np.array([x[0] for x in sp])
            b = np.array([x[1] for x in sp])
            edges = np.unique(np.concatenate([a, b]))
            mids = 0.5 * (edges[:-1] + edges[1:])
            idle = np.diff(edges) - np.diff(self._busy_before(edges))
            for m, t in zip(mids, idle):
                cover = np.nonzero((a <= m) & (b >= m))[0]
                if len(cover) and t > 0:
                    by[sp[cover[np.argmin(b[cover] - a[cover])]][2]] += t * 1e-9
        total_idle = span * 1e-9 - self.busy_s()
        rest = total_idle - sum(by.values())
        if rest > 0:
            by["unattributed"] += rest
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]
