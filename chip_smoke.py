#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`mpc_ros_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Needs one CUDA device and the CUDA toolkit's nvcc; exits non-zero without
them and never falls back to the CPU. Phases, one output line each:

 1. the card: `nvidia-smi --query-gpu=name,power.limit`;
 2. the kernel build (seconds, ptxas registers and spills per variant);
 3. the solve kernel against its plain PyTorch version on the same card,
    B=8192, N=30, the same inputs on both sides, held to the solver parity
    gates (`mpc_ros_tpu_torch.verify.parity_gates`, limits printed) in
    four variants: (a) production (ddp, 4 line-search candidates, fast
    trig), (b) exact trig, (c) Gauss-Newton with 8 candidates, (d)
    per-lane weights scaled x{0.5, 1, 4} under the adaptive weight scale;
 4. the main path: `batch_solve_lane` at the production configuration,
    B=524,288 — solves/s of the kernel path and of the plain version at
    the same shape, converged fraction, mean iterations, kernel launches,
    and the kernel against its plain version at that shape;
 5. serving: `receding_horizon_rollout`, 131,072 robots x 10 cycles —
    control cycles/s, mean warm iterations, converged fraction, kernel
    launches, and the kernel against its plain version on a warm-started
    cycle.

Then a JSON line describing each kernel (launches on the main path, error
against the plain version, times) and, last, the device JSON line. Every
phase raises on failure; nothing is caught.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import time

import torch

from mpc_ros_tpu_torch.config import MPCParams, SolverConfig
from mpc_ros_tpu_torch.engine import (make_random_scenarios,
                                      receding_horizon_rollout)
from mpc_ros_tpu_torch.kernels import _build, solve_mega
from mpc_ros_tpu_torch.solver.batch_lane import batch_solve_lane, lane_inputs
from mpc_ros_tpu_torch.testing import scaled_weights
from mpc_ros_tpu_torch.verify import parity_gates

N_STEPS = 30
B_VERIFY = 8192
B_MAIN = 524288
B_SERVE = 131072
N_CYCLES = 10
# the production N=30 configuration of bench.py
PROD = SolverConfig(n_steps=N_STEPS, max_sqp_iters=12, ls_iters=4, ddp=True,
                    tol_grad=1e-4, trig="fast", scale_adaptive=True,
                    schedule="auto")
# the card's name and power limit as nvidia-smi gives them, read in main()
CARD = ""


def emit(phase: str, **fields) -> None:
    """One JSON line per phase; every time and rate stands beside the
    card's name and power limit."""
    print(json.dumps({"phase": phase, "card": CARD, **fields}),
          flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def variants():
    """(name, config, per-lane weight scaling) of the four checks."""
    return [
        ("a_production", PROD, False),
        ("b_trig_exact", dataclasses.replace(PROD, trig="exact"), False),
        ("c_gn_ls8", dataclasses.replace(PROD, ddp=False, ls_iters=8), False),
        ("d_lane_weights", PROD, True),
    ]


def params(B: int, dev, lane_weights: bool) -> MPCParams:
    leaves = (scaled_weights(dataclasses.asdict(MPCParams()), B)
              if lane_weights else {})
    return MPCParams.from_numpy(leaves).astype(torch.float32, dev)


def scenarios(seed: int, B: int, dev):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return make_random_scenarios(gen, B, torch.float32)


def held_against_plain(ins, cfg, what: str):
    """The kernel and its plain version on the same inputs on the card,
    held to the parity gates; raises on a broken gate. Returns (gates,
    kernel seconds, plain seconds), each side timed alone to a sync."""
    t0 = time.perf_counter()
    out_k = solve_mega.solve_mega_cuda(*ins, cfg)
    torch.cuda.synchronize()
    t_k = time.perf_counter() - t0
    t0 = time.perf_counter()
    out_p = solve_mega.solve_mega_plain(*ins, cfg)
    torch.cuda.synchronize()
    t_p = time.perf_counter() - t0
    g = parity_gates(
        out_k[1].permute(2, 0, 1).cpu().numpy(), out_k[2].cpu().numpy(),
        out_k[3].cpu().numpy(), out_k[4].cpu().numpy(),
        out_p[1].permute(2, 0, 1).cpu().numpy(), out_p[2].cpu().numpy(),
        out_p[3].cpu().numpy(), out_p[4].cpu().numpy(), cfg.n_steps)
    if not g["ok"]:
        raise SystemExit(f"kernel disagrees with its plain version ({what}): "
                         f"{g}")
    return g, t_k, t_p


def kernel_vs_plain(dev) -> float:
    """Phase 3; returns the largest gated |du| over the variants."""
    worst = 0.0
    z0s, coeffs = scenarios(0, B_VERIFY, dev)
    for name, cfg, lane_w in variants():
        p = params(B_VERIFY, dev, lane_w)
        g, t_k, t_p = held_against_plain(lane_inputs(z0s, coeffs, p, cfg),
                                         cfg, f"variant {name}")
        emit("kernel_vs_plain", variant=name, kernel_s=t_k, plain_s=t_p,
             **g)
        worst = max(worst, g["max_du"])
    return worst


def check_result(res, B: int) -> None:
    T = N_STEPS - 1
    if tuple(res.us.shape) != (B, T, 2) or tuple(res.zs.shape) != (
            B, N_STEPS, 6):
        raise SystemExit(f"unexpected shapes {res.us.shape} {res.zs.shape}")
    for name in ("us", "zs", "cost"):
        if not bool(torch.isfinite(getattr(res, name)).all()):
            raise SystemExit(f"non-finite {name} on the main path")


def main_path(dev) -> dict:
    """Phase 4: the main path through the kernel, then the kernel and the
    plain version timed alone at the same shape."""
    z0s, coeffs = scenarios(1, B_MAIN, dev)
    p = params(B_MAIN, dev, False)
    batch_solve_lane(z0s, coeffs, p, PROD)          # warm-up
    torch.cuda.synchronize()
    reps = 3
    solve_mega.launches = 0
    t0 = time.perf_counter()
    for _ in range(reps):
        res = batch_solve_lane(z0s, coeffs, p, PROD)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / reps
    launches = solve_mega.launches
    if launches == 0:
        raise SystemExit("the main path did not launch the solve kernel")
    check_result(res, B_MAIN)
    conv = float(res.converged.float().mean())
    iters = float(res.n_iters.float().mean())
    if conv < 0.99:
        raise SystemExit(f"main-path converged fraction {conv} < 0.99")

    ins = lane_inputs(z0s, coeffs, p, PROD)
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        solve_mega.solve_mega_cuda(*ins, PROD)
    stop.record()
    torch.cuda.synchronize()
    kernel_ms = start.elapsed_time(stop) / reps
    # the kernel against its plain version at the main path's shape
    vs_plain, _, plain_s = held_against_plain(ins, PROD, "main path")
    plain_ms = plain_s * 1e3
    out = dict(batch=B_MAIN, solves_per_s=B_MAIN / wall,
               kernel_ms=kernel_ms, plain_ms=plain_ms,
               plain_solves_per_s=B_MAIN / (plain_ms / 1e3),
               converged_frac=conv, mean_iters=iters,
               max_iters=int(res.n_iters.max()), launches=launches,
               vs_plain=vs_plain)
    emit("main_path", **out)
    return out


def serving(dev) -> dict:
    """Phase 5: warm-started receding-horizon serving."""
    z0s, coeffs = scenarios(2, B_SERVE, dev)
    p = params(B_SERVE, dev, False)
    # set-up (allocator growth at this shape) is paid once, outside the
    # timed run, and reported on its own
    t0 = time.perf_counter()
    receding_horizon_rollout(z0s, coeffs, p, PROD, n_cycles=2)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    solve_mega.launches = 0
    t0 = time.perf_counter()
    tr = receding_horizon_rollout(z0s, coeffs, p, PROD, n_cycles=N_CYCLES)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = solve_mega.launches
    if launches == 0:
        raise SystemExit("serving did not launch the solve kernel")
    if not bool(torch.isfinite(tr.us).all()):
        raise SystemExit("non-finite controls in serving")
    # the kernel against its plain version on cycle 1's warm-started solve:
    # the plant state after cycle 0 and cycle 0's solution shifted by one
    us0 = batch_solve_lane(z0s, coeffs, p, PROD).us
    warm = torch.cat([us0[:, 1:], us0[:, -1:]], dim=1)
    vs_plain, _, _ = held_against_plain(
        lane_inputs(tr.zs[1], coeffs, p, PROD, u_init=warm), PROD,
        "serving, warm start")
    out = dict(robots=B_SERVE, cycles=N_CYCLES,
               control_cycles_per_s=B_SERVE * N_CYCLES / wall,
               ms_per_cycle=wall / N_CYCLES * 1e3,
               setup_run_2_cycles_s=setup_s,
               mean_warm_iters=float(tr.iters[1:].float().mean()),
               cold_iters=float(tr.iters[0].float().mean()),
               converged_frac=float(tr.converged.float().mean()),
               launches=launches, vs_plain=vs_plain)
    emit("serving", **out)
    return out


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device; none found")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    global CARD
    CARD = card_line()
    print(CARD, flush=True)

    t0 = time.perf_counter()
    builds = _build.build_many(sorted({
        solve_mega.resolve_knobs(cfg, torch.float32).variant
        for _, cfg, _ in variants()}))
    emit("build", seconds=time.perf_counter() - t0,
         variants={str(v): {"seconds": s, "ptxas": lines}
                   for v, (s, lines) in builds.items()})

    max_err = kernel_vs_plain(dev)
    mp = main_path(dev)
    sv = serving(dev)
    max_err = max(max_err, mp["vs_plain"]["max_du"], sv["vs_plain"]["max_du"])

    print(json.dumps({"kernels": [{
        "name": "solve_mega",
        "route": "cuda",
        "source": "mpc_ros_tpu_torch/kernels/csrc/solve_mega.cu",
        "replaces": "mpc_ros_tpu/kernels/solve_pallas.py:53",
        "launches": mp["launches"],
        "max_abs_err": max_err,
        "ms": mp["kernel_ms"],
        "plain_ms": mp["plain_ms"],
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
