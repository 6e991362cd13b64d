#!/usr/bin/env python3
"""Where a single-robot closed-loop cycle spends its time on the card.

    python3 tools/closed_loop_profile.py [--warm 30] [--cycles 20]

Builds the planner of `chip_smoke.py`'s phase 24 (float32, N=20, the
planner configuration of tests/test_closed_loop.py) on the card, runs the
infinity course for `--warm` cycles, then traces `--cycles` more with
`torch.profiler` (CPU and CUDA activities) and prints one JSON line: the
card's name and power limit, the wall time per cycle, the device time per
cycle (the sum of the CUDA kernels' and copies' own time), the device's
busy share of the wall time, kernel launches, host-to-device and
device-to-host copies and synchronizations per cycle, SQP iterations per
cycle, and the ten operators that take the most host time. A trace with no
device time prints `"device_ms_per_cycle": null` (not measured). Needs a
CUDA device; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--warm", type=int, default=30)
    ap.add_argument("--cycles", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("closed_loop_profile.py needs a CUDA device")
    from torch.profiler import ProfilerActivity, profile

    from mpc_ros_tpu_torch.config import MPCParams, PlannerConfig, SolverConfig
    from mpc_ros_tpu_torch.planner import MPCPlanner
    from mpc_ros_tpu_torch.sim import get_shape, make_plant
    from mpc_ros_tpu_torch.solver import ilqr

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
    plant = make_plant("diff_drive", plan[0].copy(), 0.1, planner.params)
    planner.initialize()
    planner.set_plan(plan, plant.pose)
    iters = []

    def cycle():
        ok, cmd, info = planner.compute_velocity_commands(
            plant.pose, plant.feedback_vel)
        assert ok and info.tracking is not None, info
        iters.append(info.tracking.solve.n_iters)
        plant.step(*cmd)

    for _ in range(args.warm):
        cycle()
    iters.clear()
    reads = ilqr.host_reads
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.cycles):
            cycle()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    n = args.cycles
    events = prof.key_averages()
    device_us = sum(e.self_device_time_total for e in events
                    if e.device_type == torch.autograd.DeviceType.CUDA)
    launches = sum(e.count for e in events if e.key in (
        "cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC"))
    h2d = sum(e.count for e in events if "HtoD" in e.key)
    d2h = sum(e.count for e in events if "DtoH" in e.key)
    syncs = sum(e.count for e in events if e.key in (
        "cudaStreamSynchronize", "cudaDeviceSynchronize"))
    top = sorted((e for e in events
                  if e.device_type == torch.autograd.DeviceType.CPU
                  and e.key.startswith("aten::")),
                 key=lambda e: e.self_cpu_time_total, reverse=True)[:10]
    print(json.dumps({
        "card": card, "cycles": n, "warm_cycles": args.warm,
        "wall_ms_per_cycle": wall / n * 1e3,
        "device_ms_per_cycle": device_us / n / 1e3 if device_us else None,
        "device_busy_share": (device_us / 1e6 / wall) if device_us else None,
        "kernel_launches_per_cycle": launches / n,
        "h2d_copies_per_cycle": h2d / n, "d2h_copies_per_cycle": d2h / n,
        "syncs_per_cycle": syncs / n,
        "sqp_iters_per_cycle": float(np.mean(iters)),
        "host_reads_per_cycle": (ilqr.host_reads - reads) / n,
        "top_host_ops_ms_per_cycle": {
            e.key: e.self_cpu_time_total / n / 1e3 for e in top},
    }), flush=True)


if __name__ == "__main__":
    main()
