"""Phase timers + profiler hooks (counterpart of `mpc_ros_tpu/obs/timers.py`).

Lightweight wall-clock phase timers for the host-side control path, and a
thin wrapper over `torch.profiler` for traces of the batched solve: the
CPU's activity always, the card's (CUDA) when one is present, written as
a Chrome trace under `log_dir` (view it in chrome://tracing or Perfetto).
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict


class PhaseTimers:
    """Accumulating named wall-clock timers (host side, control-rate code)."""

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1

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

    The card's kernels and copies are traced when CUDA is available; the
    trace is written when the block exits, also on an exception."""
    import torch
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
