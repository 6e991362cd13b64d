#!/usr/bin/env python3
"""K1 on its persistent grid against one thread per lane, on the card.

    python3 tools/k1_refill_probe.py [--lanes-per-slot 1,2,3,4,6,8,16]
                                     [--batch 131072,524288] [--reps 5]
                                     [--out FILE]

Solves seeded cold batches (`make_random_scenarios`, N=30, float32,
`MPCParams.reference_defaults()`, SQP cap 12, DDP on, tol_grad 1e-4, mu
floor 1e-6, DDP gate 2.5, 4 line-search candidates: the benchmark's
configuration) of each size, given as multiples of the card's resident
threads (`--lanes-per-slot`) and as lane counts (`--batch`), and for each
size also a warm batch (the cold solve's controls shifted by one knot, as
the serving loop warm-starts). Each batch runs one thread per lane and on
the persistent grid at full residency (`testing.k1_grid`), in turns (per
lane, grid, grid, per lane) for `--reps` rounds; each launch is timed
alone with CUDA events. Prints one JSON line per batch: the median ms per
launch of each mode, mean iterations, the grid's `refilled_lanes` and
`retiled_tiles`, and whether the two modes' outputs are equal bit for
bit; with the card's name and power limit, the variant's registers and
resident blocks. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

from mpc_ros_tpu_torch.config import MPCParams, SolverConfig  # noqa: E402
from mpc_ros_tpu_torch.engine import make_random_scenarios  # noqa: E402
from mpc_ros_tpu_torch.kernels import solve_mega  # noqa: E402
from mpc_ros_tpu_torch.solver.batch_lane import lane_inputs  # noqa: E402
from mpc_ros_tpu_torch.testing import k1_grid  # noqa: E402

CFG = SolverConfig(n_steps=30, max_sqp_iters=12, ls_iters=4, ddp=True,
                   tol_grad=1e-4, mu_init=1e-6, ddp_gate=2.5)


def card() -> dict:
    q = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True).stdout.strip()
    return {"card": q or torch.cuda.get_device_name(0)}


def bits_equal(x, y) -> bool:
    return all(torch.equal(a.view(torch.int32), b.view(torch.int32))
               for a, b in zip(x, y))


def timed(ins, slots):
    start, end = torch.cuda.Event(True), torch.cuda.Event(True)
    start.record()
    with k1_grid(slots):
        out = solve_mega.solve_mega_cuda(*ins, CFG)
    end.record()
    end.synchronize()
    return start.elapsed_time(end), out


def probe(ins, grid, reps):
    times = {"lane": [], "grid": []}
    outs = {}
    timed(ins, 0)
    timed(ins, grid)
    for _ in range(reps):
        for mode in ("lane", "grid", "grid", "lane"):
            ms, outs[mode] = timed(ins, 0 if mode == "lane" else grid)
            times[mode].append(ms)
    timed(ins, grid)
    return {
        "lane_ms": statistics.median(times["lane"]),
        "grid_ms": statistics.median(times["grid"]),
        "iters": float(outs["lane"][4].mean()),
        "refilled_lanes": int(solve_mega.refilled_lanes),
        "retiled_tiles": int(solve_mega.retiled_tiles),
        "bit_equal": bits_equal(outs["lane"], outs["grid"]),
    }, outs["lane"]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--lanes-per-slot", default="1,2,3,4,6,8,16")
    ap.add_argument("--batch", default="131072,524288")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    p = MPCParams.reference_defaults().astype(torch.float32, dev)
    variant = solve_mega.resolve_knobs(CFG, torch.float32).variant
    occ = solve_mega.occupancy(variant)
    blocks, n_sm = solve_mega._residency(variant, dev)
    grid = blocks * n_sm * solve_mega.TILE
    head = {**card(), "occupancy": occ, "slots": grid}
    print(json.dumps(head), flush=True)
    lines = [head]
    sizes = [int(float(k) * grid) // solve_mega.TILE * solve_mega.TILE
             for k in args.lanes_per_slot.split(",") if k]
    sizes += [int(b) for b in args.batch.split(",") if b]
    for i, B in enumerate(sizes):
        g = torch.Generator(device=dev).manual_seed(1000 + i)
        z0s, coeffs = make_random_scenarios(g, B)
        cold = lane_inputs(z0s, coeffs, p, CFG)
        rec, out = probe(cold, grid, args.reps)
        rec = {"B": B, "lanes_per_slot": B / grid, "start": "cold", **rec}
        print(json.dumps(rec), flush=True)
        lines.append(rec)
        us = out[1]
        warm = cold[:5] + (torch.cat([us[1:], us[-1:]]).contiguous(),)
        rec, _ = probe(warm, grid, args.reps)
        rec = {"B": B, "lanes_per_slot": B / grid, "start": "warm", **rec}
        print(json.dumps(rec), flush=True)
        lines.append(rec)
        del cold, warm, out
        torch.cuda.empty_cache()
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("".join(json.dumps(r) + "\n"
                                          for r in lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
