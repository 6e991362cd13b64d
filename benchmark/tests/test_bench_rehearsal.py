"""A tiny-size rehearsal of every cell on the CPU, on K1's plain
version: the whole run (set-up, window, trace, the reference's
comparison) and the result line's keys."""

from __future__ import annotations

import json

import pytest

import _bench_env as env
from harness import core


@pytest.mark.parametrize("traced", [False, True], ids=["trace0", "trace1"])
@pytest.mark.parametrize("workload", env.workloads())
def test_cell_rehearsal_on_the_cpu(workload, traced):
    out = env.rehearse(workload, traced=traced)
    json.dumps(out)
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    keys += ["breakdown", "checks"] if traced else ["checks"]
    assert list(out) == keys
    assert out["correct"] is True, out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert set(out["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    cell = core.find_cell(env.SPEC, workload)
    want = {m["name"]: m["unit"] for m in core.cell_metrics(
        env.SPEC, cell, traced)}
    assert set(out["metrics"]) <= set(want)
    for k, v in out["metrics"].items():
        assert v["unit"] == want[k]
    if traced:
        assert out["device"]["busy_s"] > 0
        assert out["device"]["window_s"] > 0
        for k in ("device_ops", "idle_gaps"):
            assert len(out["breakdown"][k]) <= 10
    else:
        # every end-to-end metric of the cell is read from a CPU run too
        assert set(out["metrics"]) == set(want)
    for c in out["checks"].values():
        assert c["value"] <= c["limit"]
