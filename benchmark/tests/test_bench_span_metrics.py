"""The per-layer metrics that read the program's own spans
(`serve.host_ms_per_cycle`, `serve.idle_ms_per_cycle`,
`dispatch.k1_host_ms_per_launch.*`) on hand-made traces: their values,
the window's clipping, the breakdown's rule for an idle gap, and None
untraced or where the program opened no such span."""

from __future__ import annotations

import pytest

import _bench_env as env
from harness import core
from harness.trace import Trace

NEW = ("serve.host_ms_per_cycle", "serve.idle_ms_per_cycle",
       "dispatch.k1_host_ms_per_launch.batch",
       "dispatch.k1_host_ms_per_launch.serve")


def _reader(name):
    return core.load_module(env.BENCH / "metrics" / f"{name}.py",
                            "bench_metric_" + name.replace(".", "_"))


def _record(ops, spans, window=(0.0, 1.0)):
    """A traced record: ops as (start, end) device intervals, spans as
    (name, start, end) host ranges, times in seconds."""
    trace = Trace([("k", a, b - a, a) for a, b in ops], spans, window)
    return core.Record(window_s=window[1] - window[0], attempted=1,
                       failed=0, trace=trace)


SERVE = "serve.receding_horizon_rollout"
# two cycles inside the harness's call; the device idles 0.03 s in the
# first (middle 0.135), 0.02 s in the second (middle 0.31), 0.05 s
# between the cycles (middle 0.475) and 0.1 s after the call
OPS = [(0.0, 0.12), (0.15, 0.30), (0.32, 0.45), (0.50, 0.80), (0.9, 1.0)]
SPANS = [(SERVE, 0.05, 0.85), ("serve.cycle", 0.10, 0.20),
         ("serve.cycle", 0.30, 0.45), ("serve.solve", 0.31, 0.40)]


def test_the_new_metrics_are_in_the_spec():
    per_layer = {m["name"]: m for m in env.SPEC["per_layer"]}
    for name in NEW:
        m = per_layer[name]
        assert m["source"] == "program_span" and m["unit"] == "ms"
        assert (env.BENCH / "metrics" / f"{name}.py").is_file()
    assert per_layer[NEW[2]]["workloads"] == ["k1_batch_n30_b524k"]
    for name in (NEW[0], NEW[1], NEW[3]):
        assert per_layer[name]["workloads"] == ["rollout_n30_b131k_warm"]


def test_host_ms_per_cycle_is_the_mean_cycle_span():
    rec = _record(OPS, SPANS)
    assert _reader(NEW[0]).read(rec) == pytest.approx(125.0)


def test_idle_ms_per_cycle_counts_the_gaps_inside_cycles():
    """0.03 s + 0.02 s of idle inside two cycles: 25 ms per cycle; the gap
    between the cycles and the one after the call are the call's, not a
    cycle's. The breakdown names the same gaps by their innermost span:
    the idle inside the cycles over the cycles is the metric."""
    rec = _record(OPS, SPANS)
    assert _reader(NEW[1]).read(rec) == pytest.approx(25.0)
    gaps = dict(rec.trace.breakdown()["idle_gaps"])
    assert gaps["serve.cycle"] + gaps["serve.solve"] == pytest.approx(0.05)
    assert gaps[SERVE] == pytest.approx(0.05)
    assert gaps["host.other"] == pytest.approx(0.1)


def test_spans_are_clipped_to_the_window():
    """A cycle cut by the window's end counts its part inside; a cycle
    wholly outside it does not count."""
    spans = [("serve.cycle", 0.1, 0.2), ("serve.cycle", 0.9, 1.3),
             ("serve.cycle", 1.5, 1.7)]
    rec = _record([(0.0, 0.15), (0.18, 1.0)], spans)
    assert _reader(NEW[0]).read(rec) == pytest.approx(100.0)
    # the one gap (0.15-0.18) lies in the first cycle: 30 ms over 2
    assert _reader(NEW[1]).read(rec) == pytest.approx(15.0)


@pytest.mark.parametrize("name", NEW[2:])
def test_k1_host_ms_per_launch_is_the_mean_dispatch_span(name):
    spans = [("k1.dispatch", 0.1, 0.102), ("k1.prepare", 0.1, 0.101),
             ("k1.dispatch", 0.5, 0.504), ("dispatch.batch_solve_lane",
                                           0.09, 0.2)]
    rec = _record([(0.0, 1.0)], spans)
    assert _reader(name).read(rec) == pytest.approx(3.0)


@pytest.mark.parametrize("name", NEW)
def test_none_untraced_or_without_the_span(name):
    """Untraced there is no trace; in a trace of a program without the
    span (a parent tree, or K1's plain version on a CPU rehearsal) there
    is nothing to read."""
    untraced = core.Record(window_s=1.0, attempted=1, failed=0)
    assert _reader(name).read(untraced) is None
    bare = _record(OPS, [(SERVE, 0.05, 0.85),
                         ("dispatch.batch_solve_lane", 0.1, 0.2)])
    assert _reader(name).read(bare) is None
