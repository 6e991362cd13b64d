"""Phase timers, named spans and profiler hooks (counterpart of
`mpc_ros_tpu/obs/timers.py`).

Lightweight wall-clock phase timers for the host-side control path, the
named spans the port's hot path opens around its phases, and a thin
wrapper over `torch.profiler` for traces of the batched solve: the CPU's
activity always, the card's (CUDA) when one is present, written as a
Chrome trace under `log_dir` (view it in chrome://tracing or Perfetto).

`span(name)` is off by default: with no profiler running and no collector
installed it reads one flag and returns a shared no-op context manager.
While a profiler runs (`device_trace`, or any `torch.profiler.profile`),
each span is also a `record_function` range, so it lands in the trace as
a `user_annotation` event on the same clock as the card's kernels and
copies, and an idle gap of the card can be named by the phase the host
was in. While a `PhaseTimers` is installed by `collect`, each span adds
its host time (`time.perf_counter`) to it, with or without a profiler:
that times a phase where the profiler would stretch it (a captured CUDA
graph's thousands of nodes).
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

import torch.profiler
from torch.autograd import profiler as _profiler

# the PhaseTimers every span feeds (`collect`); None: spans time nothing
_collector = None


class _Span:
    """One open span: a profiler range while a profiler runs, and its host
    time added to `timers` (a PhaseTimers or None) when it closes, also
    on an exception."""

    __slots__ = ("name", "timers", "rf", "t0")

    def __init__(self, name: str, timers):
        self.name = name
        self.timers = timers
        self.rf = None

    def __enter__(self):
        if _profiler._is_profiler_enabled:
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self.t0
        if self.rf is not None:
            self.rf.__exit__(*exc)
        if self.timers is not None:
            self.timers.totals[self.name] += dt
            self.timers.counts[self.name] += 1
        return False


_OFF = contextlib.nullcontext()


def span(name: str):
    """A named span of the program around one phase (a context manager).
    Off (a no-op) unless a profiler runs or a collector is installed."""
    if _collector is None and not _profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, _collector)


@contextlib.contextmanager
def collect(timers: "PhaseTimers"):
    """Install `timers` as the collector of every span opened in the block
    (in any thread of the process); the one installed before comes back
    when it exits. Yields `timers`; `timers.summary()` then has each
    span's total, count and mean."""
    global _collector
    before = _collector
    _collector = timers
    try:
        yield timers
    finally:
        _collector = before


class PhaseTimers:
    """Accumulating named wall-clock timers (host side, control-rate code).
    `phase(name)` is a span that feeds these timers (and, while a profiler
    runs, the trace); installed by `collect`, they also take the
    program's own spans."""

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    def phase(self, name: str):
        return _Span(name, self)

    def summary(self) -> dict:
        return {
            name: {
                "total_s": self.totals[name],
                "count": self.counts[name],
                "mean_ms": self.totals[name] / max(self.counts[name], 1) * 1e3,
            }
            for name in self.totals
        }


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Trace a block with `torch.profiler` and write it to
    `log_dir/trace.json` (Chrome trace format). Usage:

        with device_trace("traces/solve") as prof:
            batch_solve_lane(...)
        prof.key_averages()        # the profiler itself, for tables

    The card's kernels and copies are traced when CUDA is available, and
    the program's spans (`span`) as `user_annotation` ranges; the trace
    is written when the block exits, also on an exception."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
