"""The traced window: host spans from the harness's own files, the
profiler's record of the device, and what the per-layer metrics read from
them.

`Spans` times named host spans around the calls into each layer. Under a
trace each span is also a `torch.profiler.record_function` range, so that
the device's idle gaps can be put down to the span the host was in.
`Trace.read` turns the profiler's Chrome trace into device intervals
(kernels, copies, sets), clipped to the traced window, each with the host
time of the call that launched it (the runtime call of the same
correlation id), so that a metric can count the ops one span launched.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import re
import shutil
import tempfile
import time
from collections import defaultdict

WINDOW = "bench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Spans:
    """Named host spans: (name, start, end) on the host's monotonic clock,
    kept in memory. `traced` adds a profiler range to each span."""

    def __init__(self, traced: bool = False):
        self.traced = traced
        self.items: list = []
        self._rf = None
        if traced:
            from torch.profiler import record_function
            self._rf = record_function

    @contextlib.contextmanager
    def span(self, name: str):
        rf = self._rf(name) if self._rf is not None else None
        if rf is not None:
            rf.__enter__()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            t1 = time.perf_counter()
            if rf is not None:
                rf.__exit__(None, None, None)
            self.items.append((name, t0, t1))

    def durations(self, name: str) -> list:
        return [t1 - t0 for n, t0, t1 in self.items if n == name]


def _clean(name: str) -> str:
    return re.sub(r"[^A-Za-z0-9_.:-]", "_", name)[:64]


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return out


class Trace:
    """The device's activity in the traced window, in seconds.

    `ops` lists (name, start, duration, launched) of every kernel, copy
    and set that ran on the device inside the window, `launched` the host
    time of the call that launched it (on a CPU rehearsal, the profiler's
    CPU operators stand in, launched when they start); `spans` the
    harness's ranges."""

    def __init__(self, ops, spans, window):
        self.ops = ops
        self.spans = spans
        self.t0, self.t1 = window
        self.window_s = self.t1 - self.t0
        self.busy_intervals = _union([(s, s + d) for _, s, d, _ in ops])
        self.busy_s = sum(b - a for a, b in self.busy_intervals)

    @staticmethod
    def read(prof, on_device: bool) -> "Trace":
        tmp = tempfile.mkdtemp(prefix="bench_trace_")
        try:
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        if isinstance(events, dict):
            events = events.get("traceEvents", [])
        cats = DEVICE_CATS if on_device else ("cpu_op",)
        ops, spans, window, launches = [], [], None, {}
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            cat = e.get("cat", "")
            ts, dur = float(e["ts"]) * 1e-6, float(e["dur"]) * 1e-6
            corr = (e.get("args") or {}).get("correlation")
            if cat == "user_annotation":
                if e.get("name") == WINDOW:
                    window = (ts, ts + dur)
                else:
                    spans.append((e.get("name", ""), ts, ts + dur))
            elif cat in cats:
                ops.append((e.get("name", ""), ts, dur,
                            corr if on_device else ts))
            elif cat in ("cuda_runtime", "cuda_driver") and corr is not None:
                launches[corr] = ts
        if window is None:
            raise RuntimeError("the trace holds no window range")
        t0, t1 = window
        clipped = []
        for name, s, d, corr in ops:
            a, b = max(s, t0), min(s + d, t1)
            if b > a:
                launched = launches.get(corr) if on_device else corr
                clipped.append((name, a, b - a, launched))
        return Trace(clipped, spans, window)

    def time_by(self, match, launched_in: str | None = None) -> tuple:
        """(seconds, count) of the device ops whose name `match` accepts;
        with `launched_in`, only those launched inside a harness span of
        that name."""
        inside = (lambda t: True) if launched_in is None else \
            self._within(launched_in)
        sel = [d for n, _, d, t in self.ops if match(n) and inside(t)]
        return sum(sel), len(sel)

    def _within(self, name: str):
        """A test of whether a host time lies inside a span `name`."""
        iv = sorted((a, b) for n, a, b in self.spans if n == name)
        starts = [a for a, _ in iv]

        def inside(t):
            if t is None:
                return False
            i = bisect.bisect_right(starts, t) - 1
            return i >= 0 and t <= iv[i][1]
        return inside

    def breakdown(self) -> dict:
        """The device ops that took most time, and the longest idle time
        by the innermost harness span open at each gap's middle: at most
        10 entries each, [name, seconds]."""
        by_op = defaultdict(float)
        for n, _, d, _ in self.ops:
            by_op[_clean(n)] += d
        gaps = []
        edge = self.t0
        for a, b in self.busy_intervals:
            if a > edge:
                gaps.append((edge, a))
            edge = max(edge, b)
        if self.t1 > edge:
            gaps.append((edge, self.t1))
        # one sweep: the harness's spans nest (one host thread), so the
        # innermost span open at a time is the top of a stack of the
        # spans begun before it and not yet ended
        spans = sorted(self.spans, key=lambda s: (s[1], -s[2]))
        by_span = defaultdict(float)
        stack, i = [], 0
        for a, b in gaps:
            mid = 0.5 * (a + b)
            while i < len(spans) and spans[i][1] <= mid:
                while stack and stack[-1][2] < spans[i][1]:
                    stack.pop()
                stack.append(spans[i])
                i += 1
            while stack and stack[-1][2] < mid:
                stack.pop()
            label = stack[-1][0] if stack else "host.other"
            by_span[_clean(label)] += b - a
        top = sorted(by_op.items(), key=lambda kv: -kv[1])[:10]
        idle = sorted(by_span.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[k, v] for k, v in top],
                "idle_gaps": [[k, v] for k, v in idle]}


@contextlib.contextmanager
def profiled(enabled: bool, on_device: bool):
    """A profiler over the block (None when not `enabled`); the caller
    reads it with `Trace.read` after the block."""
    if not enabled:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if on_device:
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.start()
    try:
        yield prof
    finally:
        if on_device:
            torch.cuda.synchronize()
        prof.stop()
