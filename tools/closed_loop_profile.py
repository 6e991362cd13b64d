#!/usr/bin/env python3
"""Where a single-robot closed-loop cycle spends its time on the card.

    python3 tools/closed_loop_profile.py [--warm 30] [--cycles 20]
                                         [--eager] [--sync-debug]
                                         [--spans N]

Builds the planner of `chip_smoke.py`'s phase 24 (float32, N=20, the
planner configuration of tests/test_closed_loop.py) on the card, runs the
infinity course for `--warm` cycles, then traces `--cycles` more with
`torch.profiler` (CPU and CUDA activities) and prints one JSON line: the
card's name and power limit, the wall time per cycle, the device time per
cycle (the sum of the CUDA kernels' and copies' own time), the device's
busy share of the wall time, kernel launches, graph launches,
host-to-device and device-to-host copies and synchronizations (stream,
device and event) per cycle, SQP iterations and host reads per cycle, the
graph captures made, the ten operators that take the most host time,
and the host ms per cycle of each of the program's spans (`obs.span`:
`planner.cycle`, `planner.plan`, `planner.track`, the captured solve's
`graphed.prologue`, `graphed.body`, `graphed.epilogue`, its reads
`sync.graphed_flag` and `sync.graphed_fetch`), timed by a collector
(`obs.collect`) over the traced cycles. A trace with no device time
prints `"device_ms_per_cycle": null` (not measured).

`--spans N` times N tracking cycles after the warm cycles with the
collector alone, no profiler (which would record each of an iteration's
graph nodes and stretch the cycle), restarting the course at its goal,
and prints instead: per SQP iteration count, the cycles and each span's
median and mean host ms per cycle, and for the most common count each
span's median over each block of 100 such cycles (a change of speed
within the process shows there, in the span that holds it).

The cycle runs through the captured solve (`solver/graphed.py`) unless
`--eager` is given, which sets the tracker's private `_graphed` False (the
eager `tracking._cycle`). `--sync-debug` runs `--cycles` further cycles
under `torch.cuda.set_sync_debug_mode("warn")` and counts the warnings
per cycle (each a synchronizing call: a pageable copy, a `.item()`, a
`bool()` of a device tensor). Needs a CUDA device; exits non-zero without
one.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
import warnings
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402

LAUNCH_KEYS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC",
               "cuLaunchKernelEx")
SYNC_KEYS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
             "cudaEventSynchronize")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--warm", type=int, default=30)
    ap.add_argument("--cycles", type=int, default=20)
    ap.add_argument("--eager", action="store_true")
    ap.add_argument("--sync-debug", action="store_true")
    ap.add_argument("--spans", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("closed_loop_profile.py needs a CUDA device")
    from torch.profiler import ProfilerActivity, profile

    from mpc_ros_tpu_torch import obs
    from mpc_ros_tpu_torch.config import MPCParams, PlannerConfig, SolverConfig
    from mpc_ros_tpu_torch.planner import MPCPlanner
    from mpc_ros_tpu_torch.sim import get_shape, make_plant
    from mpc_ros_tpu_torch.solver import ilqr

    try:
        from mpc_ros_tpu_torch.solver import graphed
    except ImportError:     # a tree without the captured solve
        graphed = None
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    planner = MPCPlanner(
        MPCParams(dt=0.1, ref_vel=0.5, max_angvel=1.5, w_cte=300.0,
                  w_angvel_d=10.0, w_accel_d=10.0),
        SolverConfig(n_steps=20), PlannerConfig(local_plan_length=2.5),
        device=dev)
    plan = get_shape("infinity")
    planner.initialize()
    planner.tracker._graphed = not args.eager
    course = {}
    iters = []

    def start():
        course["plant"] = make_plant("diff_drive", plan[0].copy(), 0.1,
                                     planner.params)
        planner.set_plan(plan, course["plant"].pose)

    def cycle(restart_at_goal=False):
        """One planner cycle; its SQP iterations. With `restart_at_goal`,
        a cycle that does not track (the course's end) restarts the
        course and returns None."""
        plant = course["plant"]
        ok, cmd, info = planner.compute_velocity_commands(
            plant.pose, plant.feedback_vel)
        if restart_at_goal and not (ok and info.tracking is not None):
            start()
            return None
        assert ok and info.tracking is not None, info
        iters.append(info.tracking.solve.n_iters)
        plant.step(*cmd)
        return iters[-1]

    start()
    for _ in range(args.warm):
        cycle()
    iters.clear()
    if args.spans:
        out = span_report(card, args, cycle, obs)
        print(json.dumps(out), flush=True)
        return
    reads = ilqr.host_reads
    torch.cuda.synchronize()
    with obs.collect(obs.PhaseTimers()) as timers, profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.cycles):
            cycle()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    n = args.cycles
    reads = ilqr.host_reads - reads
    events = prof.key_averages()
    device_us = sum(e.self_device_time_total for e in events
                    if e.device_type == torch.autograd.DeviceType.CUDA)

    def count(pred):
        return sum(e.count for e in events if pred(e.key)) / n

    top = sorted((e for e in events
                  if e.device_type == torch.autograd.DeviceType.CPU
                  and e.key.startswith("aten::")),
                 key=lambda e: e.self_cpu_time_total, reverse=True)[:10]
    out = {
        "card": card, "path": "eager" if args.eager else "graphed",
        "cycles": n, "warm_cycles": args.warm,
        "wall_ms_per_cycle": wall / n * 1e3,
        "device_ms_per_cycle": device_us / n / 1e3 if device_us else None,
        "device_busy_share": (device_us / 1e6 / wall) if device_us else None,
        "kernel_launches_per_cycle": count(lambda k: k in LAUNCH_KEYS),
        "graph_launches_per_cycle": count(lambda k: k == "cudaGraphLaunch"),
        # the copies as the device ran them (a copy inside a graph is no
        # API call of its own)
        "h2d_copies_per_cycle": count(lambda k: "HtoD" in k),
        "d2h_copies_per_cycle": count(lambda k: "DtoH" in k),
        "syncs_per_cycle": count(lambda k: k in SYNC_KEYS),
        "syncs_by_kind_per_cycle": {k: count(lambda x, k=k: x == k)
                                    for k in SYNC_KEYS},
        "sqp_iters_per_cycle": float(np.mean(iters)),
        "host_reads_per_cycle": reads / n,
        "captures": None if graphed is None else graphed.captures,
        "top_host_ops_ms_per_cycle": {
            e.key: e.self_cpu_time_total / n / 1e3 for e in top},
        "spans_ms_per_cycle": {k: v["total_s"] / n * 1e3
                               for k, v in timers.summary().items()},
    }
    if args.sync_debug:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                for _ in range(n):
                    cycle()
            finally:
                torch.cuda.set_sync_debug_mode("default")
        # by the Python line that made the synchronizing call
        kinds: dict = {}
        for w in caught:
            where = f"{Path(w.filename).name}:{w.lineno}"
            kinds[where] = kinds.get(where, 0) + 1
        out["sync_debug_warnings_per_cycle"] = len(caught) / n
        out["sync_debug_kinds"] = kinds
    print(json.dumps(out), flush=True)


def span_report(card, args, cycle, obs) -> dict:
    """`--spans`: per tracking cycle, each span's host ms (the
    collector's totals before and after the cycle), grouped by the
    cycle's SQP iterations."""
    rows = []
    timers = obs.PhaseTimers()
    with obs.collect(timers):
        while len(rows) < args.spans:
            before = dict(timers.totals)
            n = cycle(restart_at_goal=True)
            if n is not None:
                rows.append((int(n), {
                    k: (v - before.get(k, 0.0)) * 1e3
                    for k, v in timers.totals.items()}))
    names = sorted({k for _, r in rows for k in r})
    by_iters = {}
    for n in sorted({n for n, _ in rows}):
        sel = [r for m, r in rows if m == n]
        by_iters[n] = {"cycles": len(sel), "spans": {
            k: {"median_ms": float(np.median([r.get(k, 0.0) for r in sel])),
                "mean_ms": float(np.mean([r.get(k, 0.0) for r in sel]))}
            for k in names}}
    common = max(by_iters, key=lambda n: by_iters[n]["cycles"])
    sel = [r for m, r in rows if m == common]
    blocks = [{k: float(np.median([r.get(k, 0.0) for r in sel[i:i + 100]]))
               for k in names} for i in range(0, len(sel), 100)]
    return {"card": card, "path": "eager" if args.eager else "graphed",
            "cycles": len(rows), "warm_cycles": args.warm,
            "by_iters": by_iters, "common_iters": common,
            "blocks_of_100": blocks}


if __name__ == "__main__":
    main()
