#!/usr/bin/env python3
"""The single-robot cycle's time in different process contexts on the card.

    python3 tools/cycle_context_probe.py [--cycles 40] [--eager]

Times `--cycles` cycles of `chip_smoke.py`'s phase-24 planner (float32,
N=20, the infinity course, after 5 warm cycles) in four fresh processes,
one per context, and prints one JSON line with the card's name and power
limit and, per context, the ms per cycle (p50, p99, max) and the garbage
collector's pause per cycle, with what the context does to the
interpreter (`interpreter`: the cost of a Python call and of a small
torch op, the trace, profile and monitoring hooks, threads, warning
filters, the environment, the loaded pytest plugins) and the operators
that take the most host time per cycle:

- "direct": a plain Python process;
- "threads1": the same after `torch.set_num_threads(1)` (the CPU tests'
  `testing.torch_threads(1)`);
- "gc_heavy": the same with two million live Python objects (a process
  that has run many tests holds more objects, and each full collection
  walks them all);
- "pytest": the same loop as a test of this file run by pytest
  (`--noconftest`, as the card's tests run).

`--eager` sets the tracker's private `_graphed` False (the eager
`tracking._cycle`). Needs a CUDA device; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

CONTEXTS = ("direct", "threads1", "gc_heavy", "pytest")


def time_cycles(cycles: int, eager: bool) -> dict:
    """`cycles` timed cycles of phase 24's planner on the card, after 5
    warm ones: ms per cycle and the collector's pause per cycle."""
    import numpy as np
    import torch

    from mpc_ros_tpu_torch.config import MPCParams, PlannerConfig, SolverConfig
    from mpc_ros_tpu_torch.planner import MPCPlanner
    from mpc_ros_tpu_torch.sim import get_shape, make_plant

    planner = MPCPlanner(
        MPCParams(dt=0.1, ref_vel=0.5, max_angvel=1.5, w_cte=300.0,
                  w_angvel_d=10.0, w_accel_d=10.0),
        SolverConfig(n_steps=20), PlannerConfig(local_plan_length=2.5),
        device=torch.device("cuda", 0))
    plan = get_shape("infinity")
    plant = make_plant("diff_drive", plan[0].copy(), 0.1, planner.params)
    planner.initialize()
    planner.tracker._graphed = not eager
    planner.set_plan(plan, plant.pose)
    pauses = []
    started = {}

    def on_gc(phase, info):
        if phase == "start":
            started["t"] = time.perf_counter()
        elif "t" in started:
            pauses.append(time.perf_counter() - started.pop("t"))

    ms = []

    def cycle():
        ok, cmd, info = planner.compute_velocity_commands(
            plant.pose, plant.feedback_vel)
        plant.step(*cmd)

    for i in range(cycles + 5):
        if i == 5:
            gc.callbacks.append(on_gc)
        t0 = time.perf_counter()
        cycle()
        if i >= 5:
            ms.append((time.perf_counter() - t0) * 1e3)
    gc.callbacks.remove(on_gc)
    a = np.asarray(ms)
    return dict(p50=float(np.percentile(a, 50)),
                p99=float(np.percentile(a, 99)), max=float(a.max()),
                gc_ms_per_cycle=sum(pauses) * 1e3 / cycles,
                gc_collections=len(pauses),
                torch_threads=torch.get_num_threads(), **interpreter(),
                top_host_ops_ms_per_cycle=top_ops(cycle, 3))


def top_ops(cycle, n: int) -> dict:
    """The eight operators with the most host time per cycle over `n`
    cycles traced by `torch.profiler` (CPU activity)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(n):
            cycle()
    ev = sorted(prof.key_averages(), key=lambda e: e.self_cpu_time_total,
                reverse=True)[:8]
    return {e.key: e.self_cpu_time_total / n / 1e3 for e in ev}


def interpreter() -> dict:
    """What the context does to the interpreter: the cost of a Python call
    and of a small torch op on the CPU and on the card (each a mean over
    many), the trace and profile hooks, the `sys.monitoring` tools in use,
    live threads, the warning filters' first entries."""
    import threading
    import warnings

    import torch

    def f(x):
        return x

    n = 200_000
    t0 = time.perf_counter()
    for i in range(n):
        f(i)
    py_us = (time.perf_counter() - t0) / n * 1e6
    out = dict(python_call_us=py_us)
    for dev in ("cpu", "cuda"):
        a = torch.zeros(1, device=dev)
        for _ in range(100):
            a = a + 1.0
        t0 = time.perf_counter()
        for _ in range(5_000):
            a = a + 1.0
        if dev == "cuda":
            torch.cuda.synchronize()
        out[f"torch_op_us_{dev}"] = (time.perf_counter() - t0) / 5_000 * 1e6
    mon = getattr(sys, "monitoring", None)
    out.update(
        deterministic=torch.are_deterministic_algorithms_enabled(),
        env={k: v for k, v in os.environ.items()
             if k.startswith(("CUDA", "CUBLAS", "PYTORCH", "TORCH", "OMP",
                              "PYTHON"))},
        pytest_plugins=sorted(m for m in sys.modules
                              if m.startswith("pytest_")),
        modules=len(sys.modules), switch_interval=sys.getswitchinterval())
    out.update(
        settrace=repr(sys.gettrace()), setprofile=repr(sys.getprofile()),
        monitoring_tools=[] if mon is None else [
            mon.get_tool(i) for i in range(6) if mon.get_tool(i)],
        threads=threading.active_count(),
        warning_filters=[str(w[:3]) for w in warnings.filters[:4]],
        torch_function_modes=torch._C._len_torch_function_stack())
    return out


def test_cycle_context():
    """The "pytest" context: the loop as a test (driven by `main`)."""
    out = os.environ.get("CYCLE_PROBE_OUT")
    if out is None:
        import pytest

        pytest.skip("driven by tools/cycle_context_probe.py")
    rec = time_cycles(int(os.environ["CYCLE_PROBE_CYCLES"]),
                      os.environ["CYCLE_PROBE_EAGER"] == "1")
    Path(out).write_text(json.dumps(rec))


def child(context: str, cycles: int, eager: bool, out: str) -> None:
    if context == "threads1":
        import torch

        torch.set_num_threads(1)
    hold = None
    if context == "gc_heavy":
        hold = [[i] for i in range(2_000_000)]
    rec = time_cycles(cycles, eager)
    del hold
    Path(out).write_text(json.dumps(rec))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--cycles", type=int, default=40)
    ap.add_argument("--eager", action="store_true")
    ap.add_argument("--child", choices=CONTEXTS[:3])
    ap.add_argument("--out")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("cycle_context_probe.py needs a CUDA device")
    if args.child:
        child(args.child, args.cycles, args.eager, args.out)
        return
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        for ctx in CONTEXTS:
            out = str(Path(tmp) / f"{ctx}.json")
            if ctx == "pytest":
                env = dict(os.environ, CYCLE_PROBE_OUT=out,
                           CYCLE_PROBE_CYCLES=str(args.cycles),
                           CYCLE_PROBE_EAGER="1" if args.eager else "0")
                cmd = [sys.executable, "-m", "pytest", "--noconftest", "-q",
                       "-p", "no:cacheprovider",
                       f"{__file__}::test_cycle_context"]
            else:
                env = None
                cmd = [sys.executable, __file__, "--child", ctx,
                       "--cycles", str(args.cycles), "--out", out] + (
                    ["--eager"] if args.eager else [])
            rc = subprocess.run(cmd, env=env, cwd=ROOT).returncode
            res[ctx] = (json.loads(Path(out).read_text())
                        if rc == 0 and Path(out).exists() else {"rc": rc})
    print(json.dumps({"card": card, "path": "eager" if args.eager
                      else "graphed", "cycles": args.cycles,
                      "contexts": res}), flush=True)


if __name__ == "__main__":
    main()
