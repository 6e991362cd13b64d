#!/usr/bin/env python3
"""What the program's spans cost on the card, and how far the profiler
stretches the serving loop.

    python3 tools/serving_spans.py [--batch 131072] [--cycles 10]
                                   [--seconds 5] [--trace-seconds 3]
                                   [--rounds 2] [--out FILE]

Runs `receding_horizon_rollout` of `--batch` robots x `--cycles` cycles
per call (N=30, float32, `MPCParams.reference_defaults()`, the SQP cap 12,
DDP on: the reference planner's live weights), each call's applied
controls fetched into pinned memory before the next, back to back for a
window, in three modes in turn: `off` (no profiler, no collector: every
span a no-op), `collect` (the spans timed by an installed `PhaseTimers`,
no profiler) and `traced` (a `torch.profiler` window, CPU and CUDA: every
span a profiler range, and every operator recorded). Each round runs
off, collect, traced, then the same in reverse.

Per mode and round it prints, as one JSON line (also written to `--out`):
robot-cycles/s over the window, the host's ms per call from the call to
its return (the enqueue; nothing in the loop syncs), that over the
cycles, the device's ms per call between two events recorded before the
call and after its return (the device's work and its idle inside the
call), and, where spans are timed, each span's mean ms and count per
call; traced, also the device's idle inside the cycles, ms per call, by
the innermost span the host was in and by the cycle of the call. With
the card's name and power limit. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402


def window(mode, seconds, call, fetched, cycles, batch):
    """One window of back-to-back calls in `mode`; its figures."""
    from torch.profiler import ProfilerActivity, profile

    from mpc_ros_tpu_torch import obs

    timers = obs.PhaseTimers()
    prof = None
    host, pairs = [], []
    torch.cuda.synchronize()
    with contextlib.ExitStack() as stack:
        if mode == "collect":
            stack.enter_context(obs.collect(timers))
        if mode == "traced":
            prof = stack.enter_context(profile(activities=[
                ProfilerActivity.CPU, ProfilerActivity.CUDA]))
        t0 = time.perf_counter()
        n = 0
        while True:
            e0, e1 = (torch.cuda.Event(enable_timing=True)
                      for _ in range(2))
            e0.record()
            a = time.perf_counter()
            out = call(n)
            host.append(time.perf_counter() - a)
            e1.record()
            fetched.copy_(out.us)
            pairs.append((e0, e1))
            n += 1
            if time.perf_counter() - t0 >= seconds:
                break
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev_ms = [e0.elapsed_time(e1) for e0, e1 in pairs]
    res = {
        "mode": mode, "calls": n, "window_s": wall,
        "robot_cycles_per_s": n * batch * cycles / wall,
        "host_ms_per_call": 1e3 * sum(host) / n,
        "host_ms_per_cycle": 1e3 * sum(host) / n / cycles,
        "device_ms_per_call": sum(dev_ms) / n,
    }
    if mode == "collect":
        res["spans"] = {k: {"mean_ms": v["mean_ms"],
                            "per_call": v["count"] / n}
                        for k, v in timers.summary().items()}
    if prof is not None:
        res.update(traced_spans(prof, n, cycles))
    return res


def traced_spans(prof, calls, cycles):
    """From a profiler's trace: each program span's mean ms and count per
    call (its `user_annotation` ranges), and the device's idle time
    inside the calls, ms per call, by the innermost span open at each
    gap's middle and by the cycle of its call the gap fell in."""
    import bisect
    import os
    import tempfile

    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)
    finally:
        os.unlink(path)
    if isinstance(events, dict):
        events = events.get("traceEvents", [])
    spans, busy = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        a, d = float(e["ts"]) * 1e-3, float(e["dur"]) * 1e-3
        if e.get("cat") == "user_annotation":
            spans.append((a, a + d, e["name"]))
        elif e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"):
            busy.append((a, a + d))
    tot: dict = {}
    for a, b, name in spans:
        t = tot.setdefault(name, [0.0, 0])
        t[0] += b - a
        t[1] += 1
    out = {"spans": {k: {"mean_ms": s / c, "per_call": c / calls}
                     for k, (s, c) in tot.items()}}
    merged = []
    for a, b in sorted(busy):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    gaps = [(merged[i][1], merged[i + 1][0]) for i in range(len(merged) - 1)]
    cyc = sorted((a, b) for a, b, n in spans if n == "serve.cycle")
    starts = [a for a, _ in cyc]
    # innermost span at a time: the latest-starting span that holds it
    spans.sort()
    by_span, by_index = {}, [0.0] * cycles
    for g0, g1 in gaps:
        mid = 0.5 * (g0 + g1)
        i = bisect.bisect_right(starts, mid) - 1
        if i < 0 or mid > cyc[i][1]:
            continue
        j = bisect.bisect_right(spans, (mid, float("inf"), "")) - 1
        while j >= 0 and spans[j][1] < mid:
            j -= 1
        by_span[spans[j][2]] = by_span.get(spans[j][2], 0.0) + g1 - g0
        by_index[i % cycles] += g1 - g0
    out["idle_ms_per_call_by_span"] = {k: v / calls
                                       for k, v in by_span.items()}
    out["idle_ms_per_call_by_cycle"] = [v / calls for v in by_index]
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=131072)
    ap.add_argument("--cycles", type=int, default=10)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--trace-seconds", type=float, default=3.0)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("serving_spans.py needs a CUDA device")
    from mpc_ros_tpu_torch.config import MPCParams, SolverConfig
    from mpc_ros_tpu_torch.engine import (make_random_scenarios,
                                          receding_horizon_rollout)

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    p = MPCParams.reference_defaults().astype(torch.float32, dev)
    cfg = SolverConfig(n_steps=30, max_sqp_iters=12, ls_iters=4, ddp=True,
                       tol_grad=1e-4)
    pool = [make_random_scenarios(
        torch.Generator(device=dev).manual_seed(1000 + j), args.batch)
        for j in range(8)]
    fetched = torch.empty((args.cycles, args.batch, 2), pin_memory=True)

    def call(n):
        return receding_horizon_rollout(*pool[n % len(pool)], p, cfg,
                                        n_cycles=args.cycles)

    for n in range(2):
        fetched.copy_(call(n).us)
    order = ["off", "collect", "traced"]
    rows = []
    for r in range(args.rounds):
        for mode in order + order[::-1]:
            secs = args.trace_seconds if mode == "traced" else args.seconds
            row = window(mode, secs, call, fetched, args.cycles, args.batch)
            row["round"] = r
            rows.append(row)
            print(json.dumps({k: v for k, v in row.items()
                              if k != "spans"}), file=sys.stderr,
                  flush=True)
    out = {"card": card, "batch": args.batch, "cycles": args.cycles,
           "rows": rows}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
