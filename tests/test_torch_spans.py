"""The port's named spans (`mpc_ros_tpu_torch/obs/timers.py`: `span`,
`collect`, `PhaseTimers`) on the CPU:

* off by default: with no profiler and no collector a span enters no
  `record_function` and records nothing;
* under `torch.profiler` the serving loop's spans are `user_annotation`
  ranges of the Chrome trace, nested cycle by cycle as the loop runs
  them, with the kernel route's dispatch spans inside each solve (K1's
  plain version runs here, so no `k1.*` span);
* under a collector the same names count the cycles, and
  `PhaseTimers.summary()` keeps the JAX package's structure;
* the spans of the other layers where they fire on the CPU: the captured
  single-robot cycle (its bodies called directly) and the planner's
  cycle, the deliberate host reads (`sync.*`), K3's schedules between
  passes (`k1.schedule`), K1's host path up to its checks
  (`k1.dispatch`, `k1.prepare`) and the kernel build on a miss only.
"""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from mpc_ros_tpu_torch import obs
from mpc_ros_tpu_torch.config import MPCParams, PlannerConfig, SolverConfig
from mpc_ros_tpu_torch.engine import receding_horizon_rollout
from mpc_ros_tpu_torch.kernels import _build, solve_mega
from mpc_ros_tpu_torch.obs import timers
from mpc_ros_tpu_torch.planner import MPCPlanner
from mpc_ros_tpu_torch.sim import get_shape
from mpc_ros_tpu_torch.solver import batch_lane, ilqr, riccati
from mpc_ros_tpu_torch.testing import (lockstep_cycles, numpy_scenarios,
                                       torch_threads)

B = 128
CYCLES = 3
KW = dict(n_steps=12, max_sqp_iters=12, ls_iters=4, tol_grad=1e-4)
SERVE = ("serve.cycle", "serve.solve", "serve.plant_step",
         "serve.warm_shift", "dispatch.lane_inputs", "dispatch.result")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these tests run many small ops, and the suite
    runs in several processes at once (`testing.torch_threads`)."""
    with torch_threads(1):
        yield


def _rollout(cycles=CYCLES, **cfg):
    z0, coeffs = numpy_scenarios(11, B)
    t = lambda a: torch.tensor(a, dtype=torch.float32)
    return receding_horizon_rollout(
        t(z0), t(coeffs), MPCParams().astype(torch.float32),
        SolverConfig(**dict(KW, backward="mega", **cfg)), n_cycles=cycles)


def _ranges(prof, tmp_path):
    """The `user_annotation` ranges of a profiler's Chrome trace:
    [(name, start, end)] in start order."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())
    if isinstance(events, dict):
        events = events["traceEvents"]
    return sorted(((e["name"], float(e["ts"]),
                    float(e["ts"]) + float(e["dur"]))
                   for e in events if e.get("cat") == "user_annotation"
                   and e.get("ph") == "X"), key=lambda s: s[1])


def _inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def _counts(tm):
    return {k: v["count"] for k, v in tm.summary().items()}


def test_off_spans_enter_no_record_function(monkeypatch):
    """No profiler and no collector: `span` hands out one shared no-op, a
    whole serving call runs without touching `record_function`, and a
    PhaseTimers made before it records nothing."""
    def refuse(*a, **k):
        raise AssertionError("record_function entered with spans off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert timers._collector is None
    assert obs.span("serve.cycle") is obs.span("k1.dispatch")
    idle = obs.PhaseTimers()
    tr = _rollout(cycles=2)
    assert tuple(tr.zs.shape) == (2, B, 6)
    assert idle.summary() == {} and timers._collector is None


def test_traced_rollout_emits_the_serving_spans(tmp_path):
    """Under the profiler: `serve.cycle` x 3, each holding one
    `serve.solve`, `serve.plant_step` and `serve.warm_shift` in that
    order; `dispatch.lane_inputs` and `dispatch.result` once per cycle,
    inside its `serve.solve`; `serve.stack` once, after the cycles."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _rollout()
    spans = _ranges(prof, tmp_path)
    by = {}
    for s in spans:
        by.setdefault(s[0], []).append(s)
    assert {k: len(v) for k, v in by.items()} == dict(
        {k: CYCLES for k in SERVE}, **{"serve.stack": 1})
    for k, cyc in enumerate(by["serve.cycle"]):
        solve, step, shift = (by[n][k] for n in ("serve.solve",
                                                 "serve.plant_step",
                                                 "serve.warm_shift"))
        assert all(_inside(s, cyc) for s in (solve, step, shift))
        assert solve[2] <= step[1] and step[2] <= shift[1]
        for n in ("dispatch.lane_inputs", "dispatch.result"):
            assert _inside(by[n][k], solve)
        lanes, result = by["dispatch.lane_inputs"][k], by["dispatch.result"][k]
        assert lanes[2] <= result[1]
    assert by["serve.stack"][0][1] >= by["serve.cycle"][-1][2]
    # K1's plain version runs on the CPU: its host path has no span
    assert not any(n.startswith("k1.") for n in by)


def test_collector_counts_the_serving_spans():
    """Under `collect`: each serving span counted once per cycle,
    `serve.stack` once; the summary has the JAX package's keys and the
    spans' times nest (a cycle's solve is within the cycle)."""
    with obs.collect(obs.PhaseTimers()) as tm:
        _rollout()
    assert timers._collector is None
    got = tm.summary()
    assert _counts(tm) == dict({k: CYCLES for k in SERVE},
                               **{"serve.stack": 1})
    for name, row in got.items():
        assert set(row) == {"total_s", "count", "mean_ms"}
        assert row["mean_ms"] == pytest.approx(
            row["total_s"] / row["count"] * 1e3)
    assert got["serve.solve"]["total_s"] <= got["serve.cycle"]["total_s"]
    assert (got["dispatch.lane_inputs"]["total_s"]
            <= got["serve.solve"]["total_s"])


def test_collect_nests_and_restores_on_an_exception():
    """The inner collector takes the spans of its block only; the outer
    one comes back after it, also when the block raises; a span that
    raises is still counted."""
    outer, inner = obs.PhaseTimers(), obs.PhaseTimers()
    with obs.collect(outer):
        with obs.span("a"):
            pass
        with pytest.raises(ValueError):
            with obs.collect(inner):
                with obs.span("b"):
                    raise ValueError("inside")
        assert timers._collector is outer
        with obs.span("a"):
            pass
    assert timers._collector is None
    assert _counts(outer) == {"a": 2} and _counts(inner) == {"b": 1}


def test_phase_is_a_span_of_its_own_timers(tmp_path):
    """`PhaseTimers.phase` feeds its own timers (not an installed
    collector) and, under the profiler, is a trace range like a span."""
    mine, other = obs.PhaseTimers(), obs.PhaseTimers()
    with obs.collect(other):
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with mine.phase("fit"):
                torch.ones(8).sum()
            with obs.span("solve"):
                torch.ones(8).sum()
    assert _counts(mine) == {"fit": 1} and _counts(other) == {"solve": 1}
    assert [s[0] for s in _ranges(prof, tmp_path)] == ["fit", "solve"]


def _planner():
    p = MPCPlanner(MPCParams(dt=0.1, ref_vel=0.5, max_angvel=1.5,
                             w_cte=300.0, w_angvel_d=10.0, w_accel_d=10.0),
                   SolverConfig(n_steps=12), PlannerConfig(
                       local_plan_length=2.5), device="cpu")
    p.initialize()
    return p


def test_captured_planner_cycle_spans():
    """The planner's captured cycle on the CPU (the three bodies called
    directly): per cycle one `planner.cycle` holding `planner.plan` and
    `planner.track`, one `graphed.prologue` and `graphed.epilogue`, and
    as many `graphed.body` as the solve's iterations, with one flag read
    after each body but the last of a solve that ran to its cap."""
    pl = _planner()
    cap = pl.solver_cfg.max_sqp_iters
    with obs.collect(obs.PhaseTimers()) as tm:
        recs, = lockstep_cycles([pl], 4, plan=get_shape("infinity"))
    solved = [r for r in recs if r["solve"] is not None]
    assert len(solved) == 4
    iters = [r["solve"]["iters"] for r in solved]
    c = _counts(tm)
    assert c["planner.cycle"] == c["planner.plan"] == 4
    assert c["planner.track"] == 4
    assert c["graphed.prologue"] == c["graphed.epilogue"] == 4
    assert c["graphed.body"] == sum(iters)
    assert c["sync.graphed_flag"] == sum(n if n < cap else n - 1
                                         for n in iters)
    assert "graphed.capture" not in c and "sync.ilqr" not in c


def test_eager_solve_and_riccati_reads_are_sync_spans():
    """Each host read of the eager single-scenario loop is one
    `sync.ilqr`, and each of the horizon-parallel backward's active-set
    reads one `sync.riccati`, as their counters count them."""
    z0, coeffs = numpy_scenarios(3, 4)
    p = MPCParams().astype(torch.float64)
    for cfg in (SolverConfig(n_steps=10),
                SolverConfig(n_steps=10, horizon_parallel=True)):
        reads, sweeps_read = ilqr.host_reads, riccati.host_reads
        with obs.collect(obs.PhaseTimers()) as tm:
            ilqr.solve(torch.tensor(z0), torch.tensor(coeffs), p, cfg)
        c = _counts(tm)
        assert c["sync.ilqr"] == ilqr.host_reads - reads > 0
        assert c.get("sync.riccati", 0) == riccati.host_reads - sweeps_read
        assert (c.get("sync.riccati", 0) > 0) == cfg.horizon_parallel


def test_xla_lane_loop_condition_is_a_sync_span():
    """The XLA lane path reads its loop condition on the host once per
    check (`LaneSQP.running`): each read is one `sync.batch_lane`; the
    kernel route's dispatch spans do not open on this path."""
    z0, coeffs = numpy_scenarios(5, 16)
    p = MPCParams().astype(torch.float64)
    t = lambda a: torch.tensor(a, dtype=torch.float64)
    with obs.collect(obs.PhaseTimers()) as tm:
        res = batch_lane.batch_solve_lane(t(z0), t(coeffs), p,
                                          SolverConfig(n_steps=10))
    c = _counts(tm)
    assert c["sync.batch_lane"] >= int(res.n_iters.max())
    assert "dispatch.lane_inputs" not in c and "dispatch.result" not in c


@pytest.mark.parametrize("schedule,spans", [("sorted", 2), ("compact", 2),
                                            ("single", 0)])
def test_schedules_host_work_is_k1_schedule(schedule, spans):
    """K3's host work around a schedule's passes (the sort and its
    inverse, the tail's gather and the scatter back) is `k1.schedule`:
    two spans per sorted or compact solve, none for one pass."""
    z0, coeffs = numpy_scenarios(7, 2 * B)
    p = MPCParams().astype(torch.float32)
    cfg = SolverConfig(**dict(KW, n_steps=8, max_sqp_iters=6,
                              schedule=schedule, presolve_iters=2,
                              compact_tail=0.25))
    ins = batch_lane.lane_inputs(torch.tensor(z0, dtype=torch.float32),
                                 torch.tensor(coeffs, dtype=torch.float32),
                                 p, cfg)
    passes = solve_mega.passes
    with obs.collect(obs.PhaseTimers()) as tm:
        solve_mega.solve_mega_scheduled(*ins, cfg)
    assert solve_mega.passes - passes == (2 if spans else 1)
    assert _counts(tm).get("k1.schedule", 0) == spans


def test_k1_host_path_spans_up_to_its_checks():
    """K1's host path on CPU tensors stops at its first check: the
    `k1.dispatch` and `k1.prepare` spans close (counted) as it raises,
    and no `k1.launch` opens."""
    ins = batch_lane.lane_inputs(*(torch.zeros((B, n)) for n in (6, 4)),
                                 MPCParams(), SolverConfig(**KW))
    with obs.collect(obs.PhaseTimers()) as tm:
        with pytest.raises(ValueError, match="needs CUDA tensors"):
            solve_mega.solve_mega_cuda(*ins, SolverConfig(**KW))
    assert _counts(tm) == {"k1.prepare": 1, "k1.dispatch": 1}


def test_kernel_build_span_on_a_miss_only(monkeypatch):
    """`kernels.build` opens on a `load` that has to build or open a
    library, and not on a launcher already loaded."""
    key = ("solve_mega", (4, 1, 1, 1, 0, 0, 0, 0))
    monkeypatch.setitem(_build._LIBS, key, "loaded")

    def no_compiler(*a):
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(_build, "_start", no_compiler)
    with obs.collect(obs.PhaseTimers()) as tm:
        assert _build.load(*key) == "loaded"
        assert _counts(tm) == {}
        with pytest.raises(RuntimeError, match="nvcc"):
            _build.load("solve_mega", (4, 1, 1, 1, 0, 0, 0, 1))
    assert _counts(tm) == {"kernels.build": 1}
