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
    cycle;
 6. the two-kernel route's kernels — the fused backward (K4) and the fused
    line search (K5) — against their plain versions on the inputs of a
    real SQP iteration (iteration 1, and the state after 3 iterations,
    where mu and act vary across lanes) at B=8192 and B=524,288, K5's
    second pass per lane against the design's rule on the plain version's
    candidates (`forward.second_pass_plain`), then the route end to end
    against the route with the plain versions; then (6b) lanes planted
    with NaN, inf or an overflowing coefficient through K4, K5 (B=1,024)
    and K1 (N=30, B=8,192, production and bicycle variants) against the
    plain versions, every output held to one rule; and K1 on the lane of
    `testing.next_backward_witness` (done on a finite trajectory whose next
    backward overflows; one block, N=12, per lane and under the per-block
    exit), every output bit for bit;
 7. the two-kernel main path: `batch_solve_lane(backward="pallas")` at
    B=524,288 — solves/s, K4 time per launch, K5 time on the inputs of
    each of a solve's iterations (act share, second-pass lanes and
    sectors, design bytes and rate, bound) and summed per solve, launches
    per solve (= iterations run), converged fraction, the plain route's
    time, and the route against the whole-solve kernel in its matching
    variant;
 8. serving through the route: 131,072 robots x 3 cycles;
 9. the solve kernel's resume state and per-block exit against its plain
    version at the long horizon (N=48, cap 22, the long-horizon pair), at
    B=8192 and B=131,072: done_frac = 0.97 cold, and done_frac = 1 resumed
    from a pass-1 result with some done lanes re-armed. Both are held lane
    by lane at the single-pass gates, the numerics over the lanes
    converged on both sides (a lane still running when its tile or its cap
    stopped it, or stalled, holds an iterate away from a stationary point;
    the fraction gates count it); as many tiles exit early on both sides,
    and each side's tiles stop where the per-tile exit puts them;
10. the long-horizon main path: `batch_solve_lane` at N=48, B=131,072 —
    the compact schedule observed engaged (two passes, the tail's lanes),
    the lanes beyond the tail, converged fraction, iterations, ms per
    solve and solves/s, each pass's kernel time and bound, the single pass
    and the lockstep per-block loop timed at the same shape, and the
    result against the plain compact schedule. The schedules (this phase
    and the next four) are held against the same schedule run on the
    plain version (`solve_mega_scheduled(plain=True)`), the compact ones at
    `kernel_verify`'s compact rule (`parity_gates(compact=True)`: numerics
    over iteration-matched lanes, since a lane whose tile stopped one
    iteration apart on the two sides walks a different path), the sorted
    one at the single-pass rule;
11. N=100 at cap 45, B=16,384, through the same path, against the plain
    compact schedule;
12. the sorted schedule at N=30, B=131,072, against the single pass and
    against the plain sorted schedule;
13. the tuning sweep, 8 candidates x 16,384 scenarios, with and without
    the difficulty presort;
14. long-horizon serving: 131,072 robots x 3 cycles at N=48, and cycle 1's
    warm-started compact solve against the plain compact schedule;
15. K1 stages (e)-(g), the blobs, setpoint and bicycle variants, against
    the plain version at B=8192 at the single-pass gates: blobs (K=4, in
    `bench.py`'s layout) under Gauss-Newton and under gated DDP, the
    bicycle with exact trig and with fast trig and a per-lane wheelbase, a
    per-lane setpoint profile, and blobs with a profile;
16. the obstacle main path, as `bench.py --obstacles`: N=30, B=524,288,
    K=4 blobs, its knobs (cap 30, the compact schedule) — solves/s,
    converged fraction, each pass's kernel time and bound, and the result
    against the plain compact schedule at full width;
17. obstacle serving, as `bench.py --serving --obstacles`: 131,072 robots,
    one blob each, 10 warm cycles, and one warm cycle against the plain
    schedule;
18. the bicycle main path (N=30, B=524,288, the default wheelbase and
    steering bound) against the plain version at full width, then bicycle
    serving, 131,072 robots x 3 cycles;
19. the setpoint-profile main path (N=30, B=524,288, per-lane ramp
    profiles) against the plain version at full width;
20. the compact (N=48, cap 22) and sorted (N=30) schedules at B=16,384
    with per-lane blobs and profiles, each against the same schedule on
    the plain version, compaction observed engaged;
21. the registry-generic engine, `engine.batch_solve` (the batch-first
    single-scenario solver, `solver/ilqr.py`, plain PyTorch on the card),
    at N=30, B=16,384, the production knobs: solves/s, ms per call
    (median of WINDOW), mean iterations, converged fraction, host reads
    per call, held against the XLA lane path and the whole-solve kernel
    on the same inputs at the parity gates, for the diff drive and the
    bicycle; then a `model_from_step` family (the tricycle of
    tests/test_ddp.py), gated DDP against Gauss-Newton;
22. per-lane profiles and one blob per lane through `batch_solve_lane` at
    B=1,000 (off the kernel rule, so on the generic engine), its first 896
    lanes against the kernel on the same lanes; the tricycle's tuning
    sweep, 8 candidates x 2,000 scenarios, on `batch_solve_swept`;
23. one scenario through `ilqr.solve` at N=30 and N=100, cold and warm,
    the median wall time and the iterations, each against the same solve
    in float64 on the CPU (relative cost <= 1e-3);
24. the single-robot closed loop: `MPCPlanner` + `run_closed_loop` over
    the whole infinity course on the card (float32, N=20, the planner of
    tests/test_closed_loop.py) — the goal reached within the JAX envelope
    (mean geometric error < 0.08 m, max < 0.25 m), every record finite,
    the warm carry and parameters on the card; cycles, course time, ms
    per cycle (p50 / p99 / max), iterations and host reads per cycle;
25. its first 20 cycles in float64 on the card against the port on the
    CPU: commands within 1e-6 and the same FSM state every cycle;
26. `TrajectoryTracker` on the infinity course at 0.4 m/s, the first 150
    cycles on the card: every record finite, dist_to_ref < 0.55 m; ms per
    cycle. No kernel runs on phases 21-26.
27. fleet serving through the host pipeline (`FleetPlanner`), 1,024
    robots on offset infinity courses (`bench.py --fleet`'s shape, N=20),
    30 cycles on their own pose stream: the first 2 cycles apart (cold),
    then ms per cycle (p50 / p99) and robot-cycles/s (robots x cycles
    over the window's whole time) over the other 28, K1 launches per
    cycle (one: the whole fleet's solve),
    the tracking robots' convergence and iterations, and launches, copies
    and synchronizations per cycle from a `torch.profiler` trace (and of
    `begin_cycle` alone: no device-to-host copy, no sync); one warm
    cycle's solve (its arguments recorded by wrapping the planner
    module's `batch_solve_lane`) held against the plain version at the
    single-pass gates and timed by its own device time (the profiler's
    CUDA time of the kernel); then 5 cycles each of the bicycle fleet
    (stage (g)) and of a fleet with one world blob per robot (stage (e)),
    the same check on each;
28. the device pipeline (`DeviceFleetPlanner`), f32 and 16-bit wires,
    obs_every 1 and 0, 20 cycles at 1,024 and 8,192 robots, on the pose
    stream of a host fleet on the card and held to the JAX package's
    bars against it every cycle (states and cursors, commands, cte,
    etheta, ref_vel); ms per cycle, robot-cycles/s, K1 launches and syncs
    per cycle; one device cycle's solve against the plain version;
29. `FleetTrajectoryTracker`, device and host pipelines, 30 cycles at
    1,024 robots: ms per cycle, K1 (stage (f)) launches per cycle, the
    device pipeline against the host's within 2e-3 on the commands and
    1e-3 on the lags, and one cycle's setpoint solve against the plain
    version;
30. `bench_cuda.kernel_verify` on the card: K1 against the XLA lane path
    (not its plain version) at `bench.py --verify`'s gates, plain, blobs
    and bicycle at N=30, B=1,024, and the compact N=48 schedule at
    B=4,096 with compaction read engaged from the schedule's counters;
31. the baseline controllers of `sim.compare` (Pure Pursuit, DWA) over the
    whole infinity course on the card, at tests/test_baselines.py's
    envelope, ms per cycle. No kernel runs on phase 31.
32. grid costmaps (`ObstacleMap`) through `batch_solve_lane(omaps=...)`
    at `bench.py --obstacles-grid`'s shape (N=30, cap 30, one Gaussian
    costmap per scenario): spline_coeff at B=4,096, bilinear and the
    9-tap spline at B=1,024, on the XLA lane path (grid maps take no
    kernel, as in the JAX package) — solves/s, ms per solve, converged
    fraction (>= 0.99; bilinear >= 0.93, the JAX package's own bar for
    its cell-boundary kinks), iterations; the first 256 lanes of each held
    against the port on the CPU in float32 at the single-pass gates
    (bilinear's lanes converged on one side only, at a kink, held to 1e-3
    on their cost instead);
33. the costmap routes: `FleetPlanner.set_costmaps` every cycle for
    1,024 robots (64x64 world maps, one pinned upload and the greedy fit
    on the card, then K1's blob variant once a cycle), ms per cycle p50 /
    p99 after 2 cold cycles, the fit's own ms, K1 launches per cycle
    (exactly 1) and one cycle's K1 solve against the plain version; the
    device fit at B=8,192 against the host greedy fit (the bar of
    tests/test_obstacle_fit.py:161 on that test's maps and on every map's
    first peel; each map's fitted field as faithful to its grid as the
    host fit's, within 1e-2); `MPCPlanner` past an obstacle
    on a straight course through `set_costmap` and through
    `tracker.obstacle_map` (a robot-frame map each cycle): the goal
    reached with the clearance of tests/test_obstacle_planner.py:60;
34. `SafetyMonitor` and `RecoverySupervisor` around the card's
    `MPCPlanner` on tests/test_recovery.py:189's lost-plan case: the
    ladder replans, the planner recovers, every command finite;
35. `parallel.sharded_batch_solve` at N=30, B=524,288 on a mesh of two
    entries of this card (one GPU: NCCL between cards is not exercised):
    two K1 launches of 262,144 lanes per solve on two streams, bit for bit
    the unsharded solve; ms per sharded and unsharded solve; one shard's
    launch timed and held against the plain version;
36. the compact N=48 solve (B=131,072) split the same way, held to the
    unsharded one at the single-pass fraction gates;
37. `FleetPlanner(mesh=)`, 1,024 robots x 10 cycles, two K1 launches per
    cycle, commands equal to the unsharded fleet's every cycle; ms per
    cycle of both; one shard's solve against the plain version;
38. `ilqr.solve(horizon_parallel=True)` at N=100, B=16,384 in float32:
    ms per solve, sweeps per iteration, host reads, its gates against the
    sequential solve printed (the JAX package's pair fails them alike);
    256 lanes in float64 against the CPU (equal iterations, 1e-6 on us)
    and tests/test_riccati.py:105's float64 problem (1e-6 on us);
39. `entry.entry()` (one K1 launch) and `entry.dryrun_multichip(4)` on
    [cuda:0] * 4 (data 2 x time 2) within the JAX dryrun's bounds;
40. the supervised `PlannerNode` at dt = 0.05 on tests/test_realtime_
    20hz.py's course: the rate executor's cycles, overruns and worst
    lateness, the course's completion and the errors, printed; gated on
    finite commands and a clean stop;
41. the examples `fleet_serving`, `fleet_planner --fleet 64 --cycles 20`
    and `custom_model` run to their end on the card;
42. K1's persistent grid forced at full residency on the batch cell's
    shape (B=524,288 cold, the benchmark's solver and weights): bit for
    bit one thread per lane, lane by lane against the plain version, its
    counts from a call of its own and each kernel's launches and device
    ms from a profiler trace of that call, both modes timed; then a
    fixture of planted NaN/inf lanes resumed done over 64 tiles on a
    32-block grid: bit for bit one thread per lane, tiles re-solved, the
    planted lanes held to the plain version. Late in a long process the
    profiler's trace can come back without device events (as
    `kernel_own_ms`'s fallback to events shows); the kernels are then
    reported as not traced rather than checked. It runs last: placed
    after phase 5, the phases after it ran slower on the card.

Every timed window of the whole-solve kernel (phases 4, 5, 10-12, 16,
18, 19) reports the median, min and max of WINDOW launches, the SM clock
and power draw sampled before and after, and the bytes the kernel's design
moves in that call (`solve_mega.scratch_bytes`, the re-roll charged to the
accepted steps alone, which `accepted_steps` counts) with the rate achieved;
the build phase reports each variant's registers, spills, shared memory
and resident blocks per SM. Then a JSON line describing each kernel
(launches on the main path, error against the plain version, times, the
bound on this card) and, last, the device JSON line. Every phase raises on
failure; nothing is caught.

    python3 chip_smoke.py --survey 16,26,36,46

runs phase 9 alone at B=131,072 on the seeds given and records each
comparison without stopping at a broken gate; for a broken one it traces
the lanes the gate points at (where the two sides part, both sides' line
searches at that iteration from the kernel's diagnostic output, and how
far each lies from a float64 solve). Then, per seed, the obstacle main
path (phase 16's shape) on both sides: its acceptance ties counted, each
tied lane's two answers costed in float64, the first traced through pass
1. It exits 1 if any gate broke, and prints no device line.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from mpc_ros_tpu_torch.config import MPCParams, PlannerConfig, SolverConfig
from mpc_ros_tpu_torch.engine import (make_random_scenarios,
                                      receding_horizon_rollout,
                                      sample_weight_candidates, tuning_sweep)
from mpc_ros_tpu_torch.kernels import _build, backward_fused, forward
from mpc_ros_tpu_torch.kernels import solve_mega
from mpc_ros_tpu_torch.models.obstacles import GaussianObstacles
from mpc_ros_tpu_torch.solver.batch_lane import (LaneSQP, batch_solve_lane,
                                                 lane_inputs,
                                                 solve_two_kernel,
                                                 two_kernel_stages)
from mpc_ros_tpu_torch.testing import numpy_blobs, numpy_refs, scaled_weights
from mpc_ros_tpu_torch.verify import parity_gates

N_STEPS = 30
B_VERIFY = 8192
B_MAIN = 524288
B_SERVE = 131072
N_CYCLES = 10
ROUTE_CYCLES = 3
# the production N=30 configuration of bench.py
PROD = SolverConfig(n_steps=N_STEPS, max_sqp_iters=12, ls_iters=4, ddp=True,
                    tol_grad=1e-4, trig="fast", scale_adaptive=True,
                    schedule="auto")
# the same under the per-block exit (phase 6b's lanes done before others)
PROD_TILE = dataclasses.replace(PROD, done_frac=0.97)
# the legacy two-kernel route: Gauss-Newton, 8 candidates, no adaptive
# weight scale (the knobs `backward="pallas"` resolves)
ROUTE = SolverConfig(n_steps=N_STEPS, max_sqp_iters=12, tol_grad=1e-4,
                     backward="pallas")
# the whole-solve kernel in the route's matching variant
ROUTE_MEGA = SolverConfig(n_steps=N_STEPS, max_sqp_iters=12, tol_grad=1e-4,
                          ddp=False, ls_iters=8, trig="exact",
                          scale_adaptive=False, backward="mega")
N_ALPHA = ROUTE.ls_for(torch.float32)
# the long horizon: N=48 at the cap round(0.45 N) = 22, auto knobs (the
# long-horizon pair: gate 1.5, mu floor 1e-2), "auto" -> compact at N > 36
LONG = SolverConfig(n_steps=48, max_sqp_iters=22, tol_grad=1e-4)
B_LONG = 131072
# the reference planner's longest horizon, N=100 at cap 45
LONGEST = SolverConfig(n_steps=100, max_sqp_iters=45, tol_grad=1e-4)
B_LONGEST = 16384
# the tuning sweep's shape: 8 candidates x 16,384 scenarios
N_CANDIDATES = 8
B_SWEEP = 16384
LONG_CYCLES = 3
# `bench.py --obstacles`' knobs: the obstacle ensemble's long tail gets cap
# 30 and the compact schedule (at cap 12 the ensemble converges 0.950,
# BENCH_NOTES.md); K=4 blobs per lane on the main path, one per robot in
# serving
OBST = dataclasses.replace(PROD, max_sqp_iters=30, schedule="compact")
K_MAIN = 4
K_SERVE = 1
BICYCLE = dataclasses.replace(PROD, model="bicycle")
BIKE_CYCLES = 3
# the schedules with per-lane blobs and profiles
B_SCHED = 16384

# The card's peaks for the bounds (NVIDIA's H100 SXM data sheet): HBM3 at
# 3.35 TB/s, f32 outside the tensor cores at 67 TFLOP/s.
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
# Arithmetic per scenario, counted from the kernel sources (an add, a
# multiply, a division, a sin or a cos each one operation; the box QP's
# nine-combo enumeration ~180): the fused backward ~1,210 per stage; the
# line search ~100 per candidate and stage plus ~125 per stage of the
# winner's re-roll, on the lanes that run it; the whole-solve kernel per
# SQP iteration and stage ~1,020 in the backward (row 4 skipped, no
# trig) and ~110 per line-search candidate (rotation-composition trig),
# and per stage of an accepted step's re-roll ~60: a replayed rollout
# step, the dynamics 22, the rotation composition 32, se and ce 6 (no
# feedback, clamp or blend).
FLOP_BWD_STAGE = 1210
FLOP_FWD_CAND_STAGE = 100
FLOP_FWD_REROLL_STAGE = 125
FLOP_MEGA_STAGE = (1020, 110, 60)
# K1 stages (e) and (g), counted the same way: per blob, ~10 operations
# for its penalty (one per line-search candidate and knot) and ~27 for its
# gradient and curvature in the backward (+6 for the gated concave part
# under DDP), +5 to fold them into the expansion; the bicycle adds ~47
# per backward stage (the a23/b20 terms, the DDP cross term) and 10 per
# rollout step, a candidate's or the re-roll's (v / lf in the heading
# increment and in the trig step's angle, 4; the half angle and the
# double-angle step, 6).
FLOP_BLOB_VAL = 10
FLOP_BLOB_TERMS = 27
FLOP_BLOB_GATE = 6
FLOP_BICYCLE_STAGE = (47, 10, 10)
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


def acceptance_ties(out_k, out_p, du_limit: float):
    """(B,) bool: the lanes past the du limit that are acceptance ties —
    converged on both sides in the same number of iterations, at final
    costs within TIE_REL (1 + |J|) of each other."""
    du = (out_k[1] - out_p[1]).abs().amax(dim=(0, 1))
    close = ((out_k[2] - out_p[2]).abs()
             <= TIE_REL * (1.0 + out_p[2].abs()))
    return ((out_k[3] > 0.5) & (out_p[3] > 0.5) & (out_k[4] == out_p[4])
            & close & (du > du_limit))


def outputs_gates(out_k, out_p, n_steps: int, compact: bool = False,
                  lanes=None, ties: bool = False) -> dict:
    """The parity gates between two (ss, us, cost, conv, iters, ...)
    kernel-layout outputs. With `compact`, `kernel_verify`'s compact rule
    (numerics over iteration-matched lanes), and the single-pass rule's
    reading beside it for the record. `lanes`: the lanes the numerics
    cover (the fraction gates count every lane). With `ties` (the blob
    ensembles, see TIE_FRAC) the acceptance ties leave the numerics, are
    listed, and may be at most TIE_FRAC of the batch."""
    if ties:
        g = outputs_gates(out_k, out_p, n_steps, compact, lanes)
        tie = acceptance_ties(out_k, out_p, g["limits"]["max_du"])
        keep = ~tie if lanes is None else lanes & ~tie
        g = outputs_gates(out_k, out_p, n_steps, compact, keep)
        g["acceptance_ties"] = [
            lane_record(out_k, out_p, i)
            for i in torch.nonzero(tie).flatten().tolist()[:WITNESSES]]
        g["tie_frac"] = float(tie.float().mean())
        g["ok"] = g["ok"] and g["tie_frac"] <= TIE_FRAC
        return g
    args = [out_k[1].permute(2, 0, 1).cpu().numpy(), out_k[2].cpu().numpy(),
            out_k[3].cpu().numpy(), out_k[4].cpu().numpy(),
            out_p[1].permute(2, 0, 1).cpu().numpy(), out_p[2].cpu().numpy(),
            out_p[3].cpu().numpy(), out_p[4].cpu().numpy(), n_steps]
    if lanes is not None:
        lanes = lanes.cpu().numpy()
    g = parity_gates(*args, compact=compact, lanes=lanes)
    if compact:
        single = parity_gates(*args, lanes=lanes)
        g["single_pass_rule"] = {k: single[k] for k in (
            "max_du", "max_rel_dcost", "compared_frac", "ok")}
    return g


def lane_record(out_k, out_p, i: int) -> dict:
    """Lane i's |du| and relative d-cost between two kernel-layout
    outputs, and its state on both sides."""
    def side(o):
        return {"done": float(o[7][i]), "conv": float(o[3][i]),
                "iters": float(o[4][i]), "cost": float(o[2][i]),
                "gnorm": float(o[5][i]), "mu": float(o[6][i])}

    du = (out_k[1][..., i] - out_p[1][..., i]).abs().max()
    dc = (out_k[2][i] - out_p[2][i]).abs() / (1.0 + out_p[2][i].abs())
    return {"lane": i, "du": float(du), "rel_dcost": float(dc),
            "kernel": side(out_k), "plain": side(out_p)}


def worst_lane(out_k, out_p, by: str = "du", lanes=None) -> dict:
    """The lane (among `lanes`, default all) with the largest |du|, or with
    `by="cost"` the largest |d-cost| / (1 + |cost|), between two
    kernel-layout outputs (`lane_record`)."""
    du = (out_k[1] - out_p[1]).abs().amax(dim=(0, 1))
    dc = (out_k[2] - out_p[2]).abs() / (1.0 + out_p[2].abs())
    key = du if by == "du" else dc
    if lanes is not None:
        key = torch.where(lanes, key, torch.zeros_like(key))
    return lane_record(out_k, out_p, int(key.argmax()))


def both_sides(ins, cfg, resume=None, blobs=None, refs=None):
    """The kernel and its plain version on the same inputs on the card,
    each timed alone to a sync: (kernel outputs, seconds, plain outputs,
    seconds)."""
    out_k, t_k = host_s(lambda: solve_mega.solve_mega_cuda(
        *ins, cfg, resume=resume, blobs=blobs, refs=refs))
    out_p, t_p = host_s(lambda: solve_mega.solve_mega_plain(
        *ins, cfg, resume=resume, blobs=blobs, refs=refs))
    return out_k, t_k, out_p, t_p


def held_against_plain(ins, cfg, what: str, resume=None, blobs=None,
                       refs=None):
    """The kernel and its plain version (`both_sides`) held to the
    single-pass parity gates. Raises on a broken gate. Returns (gates,
    kernel seconds, plain seconds, kernel outputs, plain outputs)."""
    out_k, t_k, out_p, t_p = both_sides(ins, cfg, resume, blobs, refs)
    g = outputs_gates(out_k, out_p, cfg.n_steps)
    if not g["ok"]:
        raise SystemExit(
            f"kernel disagrees with its plain version ({what}): {g}; worst "
            f"lane {worst_lane(out_k, out_p)}")
    return g, t_k, t_p, out_k, out_p


def kernel_vs_plain(dev) -> float:
    """Phase 3; returns the largest gated |du| over the variants."""
    worst = 0.0
    z0s, coeffs = scenarios(0, B_VERIFY, dev)
    for name, cfg, lane_w in variants():
        p = params(B_VERIFY, dev, lane_w)
        g, t_k, t_p, _, _ = held_against_plain(
            lane_inputs(z0s, coeffs, p, cfg), cfg, f"variant {name}")
        emit("kernel_vs_plain", variant=name, kernel_s=t_k, plain_s=t_p,
             **g)
        worst = max(worst, g["max_du"])
    return worst


def reset_launches() -> None:
    """Every kernel's launch count, and the schedules' pass and tail
    counts, to 0, just before a path is driven."""
    solve_mega.launches = backward_fused.launches = forward.launches = 0
    solve_mega.passes = solve_mega.tail_lanes = 0


def check_result(res, B: int, n_steps: int = N_STEPS) -> None:
    T = n_steps - 1
    if tuple(res.us.shape) != (B, T, 2) or tuple(res.zs.shape) != (
            B, n_steps, 6):
        raise SystemExit(f"unexpected shapes {res.us.shape} {res.zs.shape}")
    for name in ("us", "zs", "cost"):
        if not bool(torch.isfinite(getattr(res, name)).all()):
            raise SystemExit(f"non-finite {name} on the main path")


def blob_field(seed: int, B: int, K: int, dev) -> GaussianObstacles:
    """`bench.py`'s obstacle field on the card: one live blob per lane
    with its centre uniform in [0.3, 1.2]^2, K - 1 inert ones at (50, 50),
    sigma 0.3, weight 100 (`testing.numpy_blobs`)."""
    return GaussianObstacles.from_sigmas(*(
        torch.tensor(a, dtype=torch.float32, device=dev)
        for a in numpy_blobs(seed, B, K)))


def ramp_refs(seed: int, B: int, n_steps: int, dev) -> torch.Tensor:
    """Per-lane (B, N, 3) setpoint profiles on the card: a speed ramp with
    a sinusoidal cte setpoint plus per-knot noise (`testing.numpy_refs`)."""
    return torch.tensor(numpy_refs(seed, B, n_steps), dtype=torch.float32,
                        device=dev)


def lane_major(refs: torch.Tensor) -> torch.Tensor:
    """(B, N, 3) profiles as the kernel reads them, (N, 3, B)."""
    return refs.permute(1, 2, 0).contiguous()


def main_path(dev, phase: str = "main_path", cfg=PROD, seed: int = 1,
              with_refs: bool = False) -> dict:
    """Phase 4 (and 18, 19): a single-pass main path through the kernel,
    then the kernel and the plain version timed alone at the same shape
    and held against each other."""
    z0s, coeffs = scenarios(seed, B_MAIN, dev)
    p = params(B_MAIN, dev, False)
    refs = ramp_refs(seed, B_MAIN, cfg.n_steps, dev) if with_refs else None
    batch_solve_lane(z0s, coeffs, p, cfg, refs=refs)          # warm-up
    torch.cuda.synchronize()
    reps = 3
    reset_launches()
    t0 = time.perf_counter()
    for _ in range(reps):
        res = batch_solve_lane(z0s, coeffs, p, cfg, refs=refs)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / reps
    launches = solve_mega.launches
    if launches != reps:
        raise SystemExit(f"{phase}: {launches} kernel launches over {reps} "
                         f"solves")
    check_result(res, B_MAIN)
    conv = float(res.converged.float().mean())
    iters = float(res.n_iters.float().mean())
    if conv < 0.99:
        raise SystemExit(f"{phase}: converged fraction {conv} < 0.99")

    ins = lane_inputs(z0s, coeffs, p, cfg)
    refs_l = None if refs is None else lane_major(refs)
    _, win, bound, _ = timed_launch(ins, cfg, refs=refs_l)
    kernel_ms = win["median_ms"]
    # the kernel against its plain version at the main path's shape
    vs_plain, _, plain_s, _, _ = held_against_plain(ins, cfg, phase,
                                                    refs=refs_l)
    plain_ms = plain_s * 1e3
    out = dict(batch=B_MAIN, solves_per_s=B_MAIN / wall,
               kernel_ms=kernel_ms, plain_ms=plain_ms,
               plain_solves_per_s=B_MAIN / (plain_ms / 1e3),
               bound_ms=bound[0], bound_by=bound[1],
               converged_frac=conv, mean_iters=iters,
               max_iters=int(res.n_iters.max()),
               mean_warp_max_iters=warp_max_iters(res.n_iters),
               launches=launches, window=win, vs_plain=vs_plain)
    emit(phase, **out)
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
    reset_launches()
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
    ins = lane_inputs(tr.zs[1], coeffs, p, PROD, u_init=warm)
    vs_plain = held_against_plain(ins, PROD, "serving, warm start")[0]
    # the kernel's window on that warm-started cycle
    _, win, bound, _ = timed_launch(ins, PROD)
    out = dict(robots=B_SERVE, cycles=N_CYCLES,
               control_cycles_per_s=B_SERVE * N_CYCLES / wall,
               ms_per_cycle=wall / N_CYCLES * 1e3,
               setup_run_2_cycles_s=setup_s,
               mean_warm_iters=float(tr.iters[1:].float().mean()),
               cold_iters=float(tr.iters[0].float().mean()),
               converged_frac=float(tr.converged.float().mean()),
               launches=launches, warm_cycle_kernel=dict(
                   window=win, bound_ms=bound[0], bound_by=bound[1]),
               vs_plain=vs_plain)
    emit("serving", **out)
    return out


def bound_ms(tensors, flops: float):
    """The least time this card could take for a function: the larger of
    its bytes (each input read once, each output written once) over the
    HBM rate and its operations over the f32 rate. Returns (ms, which)."""
    nbytes = sum(t.numel() * t.element_size() for t in tensors
                 if torch.is_tensor(t))
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def mega_flops(cfg, lane_iters: float, accepted: float,
               n_blobs: int = 0) -> float:
    """Counted operations of a call whose lanes ran `lane_iters` SQP
    iterations, `accepted` of them with an accepted step: per
    lane-iteration T stages of the backward and of the n_ls candidates,
    with the blob terms at every knot and the bicycle's heading rows; per
    accepted step T stages of the re-roll, which a rejected step skips."""
    T = cfg.n_controls
    n_ls = cfg.ls_for(torch.float32)
    bwd, cand, reroll = FLOP_MEGA_STAGE
    if cfg.model == "bicycle":
        bwd, cand, reroll = (a + b for a, b in zip(
            (bwd, cand, reroll), FLOP_BICYCLE_STAGE))
    ops = T * (bwd + n_ls * cand)
    if n_blobs:
        terms = FLOP_BLOB_TERMS + (FLOP_BLOB_GATE
                                   if cfg.ddp_for(torch.float32) else 0)
        ops += (T + 1) * (n_blobs * (terms + n_ls * FLOP_BLOB_VAL) + 5)
    return float(ops * lane_iters + T * reroll * accepted)


def accepted_steps(ins, cfg, iters, resume=None, blobs=None,
                   refs=None) -> int:
    """The lane-iterations of one call whose step the line search
    accepted (those the re-roll runs on): the call relaunched with its cap
    cut to m = 1, 2, ... (a lane's first m iterations do not depend on the
    cap, nor does a tile's exit), each launch's line-search diagnostic
    read on the lanes that ran iteration m. These launches are made after
    a phase's counts are read and count on no main path."""
    n_ls = cfg.ls_for(torch.float32)
    diag = torch.zeros(n_ls + 2, ins[0].shape[-1], device=ins[0].device)
    n = torch.zeros((), dtype=torch.int64, device=ins[0].device)
    for m in range(1, int(iters.max()) + 1):
        out = solve_mega.solve_mega_cuda(
            *ins, dataclasses.replace(cfg, max_sqp_iters=m), resume=resume,
            blobs=blobs, refs=refs, diag=diag)
        n += ((out[4] == m) & (diag[n_ls + 1] > 0)).sum()
    return int(n)


def mega_bound(ins, outs, cfg, accepted: float, resume=None, blobs=None,
               refs=None) -> tuple:
    """The whole-solve kernel's bound on one call: its inputs (the resume
    state's 16 bytes per lane, the blobs and the setpoint profile
    included) and outputs, and the operations of the SQP iterations these
    lanes ran (`mega_flops`)."""
    n_blobs = 0 if blobs is None else blobs[0].shape[0]
    extra = list(resume or ()) + list(blobs or ()) + (
        [] if refs is None else [refs])
    return bound_ms(list(ins) + extra + list(outs),
                    mega_flops(cfg, float(outs[4].double().sum()), accepted,
                               n_blobs))


def timed_launch(ins, cfg, resume=None, blobs=None, refs=None):
    """The kernel's wrapper `solve_mega_cuda` on one set of inputs, timed
    over a window of launches (`device_window`), with the traffic its
    design moves at that time (`k1_traffic`): (outputs, window, bound (ms,
    which), mean per-warp maximum of iterations)."""
    def call():
        return solve_mega.solve_mega_cuda(*ins, cfg, resume=resume,
                                          blobs=blobs, refs=refs)

    outs = call()
    win = device_window(call)
    acc = accepted_steps(ins, cfg, outs[4], resume, blobs, refs)
    n_blobs = 0 if blobs is None else blobs[0].shape[0]
    win.update(k1_traffic(cfg, outs[4], acc, win["median_ms"], n_blobs,
                          refs is not None))
    return (outs, win,
            mega_bound(ins, outs, cfg, acc, resume, blobs, refs),
            warp_max_iters(outs[4]))


def k1_traffic(cfg, iters, accepted: int, ms: float, n_blobs: int = 0,
               setp: bool = False) -> dict:
    """The bytes the whole-solve kernel's design moves through device
    memory on a call whose lanes ran `iters` SQP iterations, `accepted` of
    them with an accepted step (`solve_mega.scratch_bytes`, the re-roll on
    those only), for this design and the double-buffered one it replaced
    (which re-rolled every lane-iteration), and the rate achieved at
    `ms`."""
    T, n_ls = cfg.n_controls, cfg.ls_for(torch.float32)
    lane_iters = float(iters.double().sum())
    out = {"lane_iterations": lane_iters, "accepted_steps": accepted}
    for layout in solve_mega.LAYOUTS:
        rej, acc = (solve_mega.scratch_bytes(T, n_ls, layout, n_blobs, setp,
                                             a) for a in (False, True))
        nbytes = rej * (lane_iters - accepted) + acc * accepted
        out[f"{layout}_bytes_per_lane_iteration"] = nbytes / max(lane_iters,
                                                                 1.0)
        out[f"{layout}_gb"] = nbytes / 1e9
    out["achieved_tb_per_s"] = out["replay_gb"] / ms
    out["hbm_share"] = out["achieved_tb_per_s"] * 1e12 / HBM_BYTES_PER_S
    return out


# launches per timed window of the whole-solve kernel
WINDOW = 5


def gpu_sample() -> dict:
    """The card's SM clock (MHz) and power draw (W) now."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60)
    sm, pw = out.stdout.strip().splitlines()[0].split(",")
    return {"sm_mhz": float(sm), "power_w": float(pw)}


def device_window(fn, reps: int = WINDOW) -> dict:
    """Device time of `fn` per call: one untimed call, then `reps` calls,
    each between two CUDA events; the median, min and max in ms, and the SM
    clock and power draw sampled just before and just after the window."""
    fn()
    torch.cuda.synchronize()
    before = gpu_sample()
    evs = [(torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for a, b in evs:
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    after = gpu_sample()
    ms = sorted(a.elapsed_time(b) for a, b in evs)
    return {"median_ms": statistics.median(ms), "min_ms": ms[0],
            "max_ms": ms[-1], "launches": reps,
            "sm_mhz": [before["sm_mhz"], after["sm_mhz"]],
            "power_w": [before["power_w"], after["power_w"]]}


def compact_passes(ins, cfg, blobs=None, refs=None) -> list:
    """The compact schedule's two passes launched one by one through the
    schedule's own functions (`compact_pass1_cfg`, `compact_tail`), each
    timed by `timed_launch`: [{lanes, kernel_ms, bound_ms, bound_by,
    mean_warp_max_iters}] for pass 1 and the tail."""
    out1, w1, b1, wm1 = timed_launch(ins, solve_mega.compact_pass1_cfg(cfg),
                                     blobs=blobs, refs=refs)
    tail = solve_mega.compact_tail(ins, out1, cfg, blobs, refs)
    _, w2, b2, wm2 = timed_launch(tail.ins, tail.cfg, tail.resume,
                                  tail.blobs, tail.refs)
    return [{"lanes": int(a[0].shape[-1]), "kernel_ms": w["median_ms"],
             "bound_ms": b[0], "bound_by": b[1], "mean_warp_max_iters": wm,
             "window": w}
            for a, w, b, wm in ((ins, w1, b1, wm1),
                                (tail.ins, w2, b2, wm2))]


def warp_max_iters(iters) -> float:
    """The mean over 32-lane warps of the warp's largest iteration count:
    the iterations a warp pays under the per-thread exit."""
    return float(iters.reshape(-1, 32).max(dim=1).values.float().mean())


def host_s(fn):
    """(result, seconds) of one call timed on the host clock to a sync."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def errors(k, p) -> dict:
    """Max absolute error, and max error relative to the output's largest
    magnitude."""
    d = float((k - p).abs().max())
    return {"max_abs": d, "max_rel": d / max(float(p.abs().max()), 1e-30)}


def lanes_within(pairs, tol: float):
    """(B,) bool: every element of every (kernel, plain) pair of a lane
    lies within tol * (1 + |plain|)."""
    ok = None
    for k, p in pairs:
        bad = ((k - p).abs() > tol * (1.0 + p.abs())).reshape(-1, k.shape[-1])
        lane_ok = ~bad.any(dim=0)
        ok = lane_ok if ok is None else ok & lane_ok
    return ok


# Tolerances of phase 6, on identical inputs. The kernels compute in f32
# with FMA contraction, the plain versions with separate multiplies and
# adds: rounding-level differences that the 29-stage recursions carry.
# The box QP's active set and the line search's acceptance are
# discontinuous in their inputs, so such a difference can flip a stage's
# clamp or a lane's accepted alpha; those lanes are bounded by a fraction
# (0.999, the parity gates' conv-match bar) and their effect by the
# end-to-end parity gates. Within a lane, 1e-3 relative to 1 + |value|
# holds 2-3 orders above the f32 rounding measured against a CPU
# emulation of the kernels (2.4e-7 in the gains, 4.7e-5 in the
# trajectories).
LANE_TOL = 1e-3
LANE_FRAC = 0.999
# The line search's acceptance on identical inputs: at iteration 1 every
# lane is active and far from its optimum, so the flags must agree on
# >= LANE_FRAC of all lanes. Later, converged lanes compare candidate
# costs that differ from the current one at rounding level, and FMA
# contraction decides them; a flag on a done lane (act = 0) reaches
# nothing, since every update of the loop is masked by act. So from
# iteration 2 on the gate is over active lanes, and a flip counts as a
# tie when the accepting side's improvement is below TIE_REL * (1 + |J|),
# under ten times the solver's own small-step tolerance (10 eps_f32 =
# 1.19e-6 relative). The raw agreement over all lanes is printed.
TIE_REL = 1e-5
# Blob ensembles have flat directions along an obstacle's ridge: there a
# lane can converge on both sides in the same number of iterations at
# costs one f32 ulp apart while its controls differ by more than the du
# limit — one side accepted a last step worth an ulp of cost that the
# other rejected (a lane of 524,288 on the obstacle main path: du 0.045,
# costs 644.13977 / 644.13971). On the obstacle paths such acceptance
# ties (TIE_REL, as above) leave the numerics and may be at most TIE_FRAC
# of the batch.
TIE_FRAC = 1e-4


def acceptance(fk, fp, cost_prev, act) -> dict:
    """Agreement of the kernel's and the plain version's `accepted`."""
    agree = fk[3] == fp[3]
    gain = torch.maximum(cost_prev - fk[2], cost_prev - fp[2])
    tie = ~agree & (gain <= TIE_REL * (1.0 + cost_prev.abs()))
    on = act > 0.5
    return {"all_lanes": float(agree.float().mean()),
            "active_lanes": float(agree[on].float().mean()),
            "active_agree_or_tie": float((agree | tie)[on].float().mean()),
            "agree": agree}


def second_pass_check(sec, fi, fk, fp) -> dict:
    """The line search's `second` output (the second pass each lane took,
    plus 4 * its winning candidate) against what the design computes from
    the plain version's candidates (`forward.second_pass_plain`): equal on
    every lane where both sides pick the same candidate, and the pass
    equal on every inactive lane (it does not depend on the candidate
    there); on active lanes the candidates agree, or differ at a tie
    (TIE_REL, as `acceptance`), on >= LANE_FRAC of them. Both sides'
    counts of lanes and 32-byte sectors per pass are reported."""
    want = forward.second_pass_plain(*fi, n_alpha=N_ALPHA)
    cost_prev, on = fi[9], fi[10] > 0.5
    same = (sec // 4) == (want // 4)
    gain = torch.maximum(cost_prev - fk[2], cost_prev - fp[2])
    tie = ~same & (gain <= TIE_REL * (1.0 + cost_prev.abs()))
    rec = {"kernel": forward.second_pass_counts(sec),
           "plain": forward.second_pass_counts(want),
           "same_candidate_active": float(same[on].float().mean()),
           "same_or_tie_active": float((same | tie)[on].float().mean()),
           "codes_equal_where_same": bool(torch.equal(sec[same],
                                                      want[same])),
           "pass_equal_inactive": bool(torch.equal(sec[~on] % 4,
                                                   want[~on] % 4))}
    rec["counts_equal"] = rec["kernel"] == rec["plain"]
    rec["ok"] = (rec["codes_equal_where_same"] and rec["pass_equal_inactive"]
                 and rec["same_or_tie_active"] >= LANE_FRAC)
    return rec


def stage_kernels_vs_plain(dev) -> dict:
    """Phase 6: K4 and K5 against their plain versions on the inputs of
    SQP iterations 1 and 4 of the route, then the route against the route
    with the plain versions, at B=8192 and B=524,288."""
    out = {"bwd_err": 0.0, "fwd_err": 0.0}
    for B in (B_VERIFY, B_MAIN):
        z0s, coeffs = scenarios(3, B, dev)
        p = params(B, dev, False)
        sqp = LaneSQP(z0s, coeffs, p, ROUTE, two_kernel=two_kernel_stages())
        for it in range(4):
            if it in (0, 3):
                bi = sqp.backward_inputs()
                bk = backward_fused.backward_fused_cuda(*bi)
                bp, bp_s = host_s(lambda: backward_fused.backward_fused_plain(
                    *bi))
                names = ("ks", "Ks", "dV1", "dV2", "pg")
                b_errs = {n: errors(k, q) for n, k, q in zip(names, bk, bp)}
                b_ok = float(lanes_within(zip(bk, bp), LANE_TOL)
                             .float().mean())
                fi = sqp.forward_inputs(bp[0], bp[1])
                sec = torch.empty(B, dtype=torch.int8, device=dev)
                fk = forward.forward_cuda(*fi, n_alpha=N_ALPHA, second=sec)
                fp, fp_s = host_s(lambda: forward.forward_plain(
                    *fi, n_alpha=N_ALPHA))
                act = fi[-1]
                acc = acceptance(fk, fp, fi[9], act)
                sp = second_pass_check(sec, fi, fk, fp)
                agree = acc.pop("agree")
                f_errs = {n: errors(k[..., agree], q[..., agree])
                          for n, k, q in zip(("ss", "us", "cost"), fk[:3],
                                             fp[:3])}
                # trajectories over the lanes whose acceptance agrees
                f_ok = float(lanes_within(
                    [(k[..., agree], q[..., agree]) for k, q in
                     zip(fk[:3], fp[:3])], LANE_TOL).float().mean())
                acc_gate = (acc["all_lanes"] if it == 0
                            else acc["active_agree_or_tie"])
                emit("stage_kernels_vs_plain", batch=B, iteration=it + 1,
                     mu_distinct=int(torch.unique(bi[-1]).numel()),
                     act_frac=float(act.mean()),
                     backward=b_errs, backward_lanes_within=b_ok,
                     forward=f_errs, forward_lanes_within=f_ok,
                     accepted_agreement=acc,
                     accepted_frac=float(fp[3].mean()), second_pass=sp,
                     tol={"lane": LANE_TOL, "lane_frac": LANE_FRAC,
                          "tie_rel": TIE_REL})
                if min(b_ok, f_ok, acc_gate) < LANE_FRAC or not sp["ok"]:
                    raise SystemExit(
                        f"K4/K5 disagree with their plain versions (B={B}, "
                        f"iteration {it + 1}): lanes within tolerance "
                        f"{b_ok} / {f_ok}, accepted agreement {acc}, "
                        f"second pass {sp}")
                out["bwd_err"] = max(out["bwd_err"],
                                     b_errs["ks"]["max_abs"],
                                     b_errs["Ks"]["max_abs"])
                out["fwd_err"] = max(out["fwd_err"], f_errs["us"]["max_abs"])
                if B == B_MAIN and it == 0:
                    out["bwd_plain_ms"] = bp_s * 1e3
                    out["fwd_plain_ms"] = fp_s * 1e3
            sqp.step()
        # the route end to end, kernels against plain versions
        rk, rk_s = host_s(lambda: solve_two_kernel(z0s, coeffs, p, ROUTE))
        rp, rp_s = host_s(lambda: solve_two_kernel(z0s, coeffs, p, ROUTE,
                                                   plain=True))
        g = parity_gates(
            rk.us.cpu().numpy(), rk.cost.cpu().numpy(),
            rk.converged.cpu().numpy(), rk.n_iters.cpu().numpy(),
            rp.us.cpu().numpy(), rp.cost.cpu().numpy(),
            rp.converged.cpu().numpy(), rp.n_iters.cpu().numpy(), N_STEPS)
        emit("route_vs_plain_route", kernel_route_s=rk_s,
             plain_route_s=rp_s, **g)
        if not g["ok"]:
            raise SystemExit(f"the route disagrees with its plain version "
                             f"(B={B}): {g}")
        if B == B_MAIN:
            out["plain_route_s"] = rp_s
            out["route_max_du"] = g["max_du"]
    return out


# lanes planted with NaN, inf or an overflowing coefficient
# (`plant_nonfinite`): ten of B_NONFINITE for K4/K5, of B_VERIFY for K1
B_NONFINITE = 1024


def nonfinite_lanes(dev) -> dict:
    """Phase 6b: lanes with NaN or inf in ss, ks, Ks and the coefficients
    (or 1e30 in the leading coefficient) against the plain versions, which
    propagate NaN through clip and max as jnp.clip does: K4 and K5 on
    iteration 1's route inputs (B=1,024), K1 in its production and
    bicycle variants (N=30, B=8,192; NaN in the initial state instead of
    ss), and K1 on one block (B=128) with the planted lanes resumed done
    while the others run, per lane and under the per-block exit. On the
    planted lanes NaN and inf where the plain version has them and the
    finite values within LANE_TOL; every other lane bit for bit as on the
    clean inputs (`nonfinite_agreement`), K1's trajectories included: a
    lane whose backward rows are not all finite takes the blended re-roll
    (`solve_mega.replay_check`), as its plain version does."""
    # imported here: tools/compare_k1_builds.py loads this file over older
    # trees' packages, which lack these helpers
    from mpc_ros_tpu_torch.testing import (WITNESS_LANE, nonfinite_agreement,
                                           next_backward_witness,
                                           plant_nonfinite)

    lanes = [3 + (B_NONFINITE // 10) * i for i in range(10)]
    z0s, coeffs = scenarios(3, B_NONFINITE, dev)
    sqp = LaneSQP(z0s, coeffs, params(B_NONFINITE, dev, False), ROUTE,
                  two_kernel=two_kernel_stages(plain=True))
    bi = sqp.backward_inputs()
    fi = sqp.forward_inputs(*backward_fused.backward_fused_plain(*bi)[:2])
    out = {}
    for name, clean, names, run_k, run_p in (
            ("forward", fi, ("ss", "us", "ks", "Ks", "coeffs"),
             lambda a: forward.forward_cuda(*a, n_alpha=N_ALPHA),
             lambda a: forward.forward_plain(*a, n_alpha=N_ALPHA)),
            ("backward_fused", bi, ("ss", "us", "coeffs"),
             lambda a: backward_fused.backward_fused_cuda(*a),
             lambda a: backward_fused.backward_fused_plain(*a))):
        planted = plant_nonfinite(
            {n: a for n, a in zip(names, clean) if n != "us"}, lanes)
        ins = tuple(planted.get(n, a) for n, a in zip(names, clean)) + tuple(
            clean[len(names):])
        out[name] = nonfinite_agreement(run_k(ins), run_p(ins),
                                        run_k(clean), lanes, LANE_TOL)
    k1_lanes = [4 + (B_VERIFY // 10) * i for i in range(10)]
    z0s, coeffs = scenarios(11, B_VERIFY, dev)
    for name, cfg in (("solve_mega", PROD), ("solve_mega[bicycle]", BICYCLE)):
        ins = lane_inputs(z0s, coeffs, params(B_VERIFY, dev, False), cfg)
        planted = plant_nonfinite({"z": ins[0], "coeffs": ins[1]}, k1_lanes)
        bad = (planted["z"], planted["coeffs"]) + tuple(ins[2:])
        k = solve_mega.solve_mega_cuda(*bad, cfg)
        p = solve_mega.solve_mega_plain(*bad, cfg)
        clean = solve_mega.solve_mega_cuda(*ins, cfg)
        out[name] = nonfinite_agreement(k, p, clean, k1_lanes, LANE_TOL)
    # one block (B = TILE, the plain version's batch and the kernel's block
    # the same lanes): planted lanes resumed done beside running ones, which
    # the plain version blends with act = 0 while the others run
    Bt = solve_mega.TILE
    z0s, coeffs = scenarios(12, Bt, dev)
    done_lanes = [5, 40, 77, 100]
    done = torch.zeros(Bt, device=dev)
    done[done_lanes + [9, 60]] = 1.0
    resume = (done, torch.zeros_like(done), torch.full_like(done, 1e-6),
              torch.full_like(done, float("inf")))
    for name, cfg in (("solve_mega[done,per_lane]", PROD),
                      ("solve_mega[done,tile]", PROD_TILE)):
        ins = lane_inputs(z0s, coeffs, params(Bt, dev, False), cfg)
        planted = plant_nonfinite({"z": ins[0], "coeffs": ins[1]},
                                  done_lanes)
        bad = (planted["z"], planted["coeffs"]) + tuple(ins[2:])
        k = solve_mega.solve_mega_cuda(*bad, cfg, resume=resume)
        p = solve_mega.solve_mega_plain(*bad, cfg, resume=resume)
        clean = solve_mega.solve_mega_cuda(*ins, cfg, resume=resume)
        out[name] = nonfinite_agreement(k, p, clean, done_lanes, LANE_TOL)
    # a lane done on a finite trajectory whose next backward overflows
    # (`testing.next_backward_witness`): the plain version blends it into
    # NaN while its block runs, and so must K1, through its probe of that
    # backward; every output held bit for bit
    for name, done_frac in (("solve_mega[witness,per_lane]", 1.0),
                            ("solve_mega[witness,tile]", 0.97)):
        ins, cfg = next_backward_witness(torch.float32, dev, done_frac)
        out[name] = bitwise_agreement(solve_mega.solve_mega_cuda(*ins, cfg),
                                      solve_mega.solve_mega_plain(*ins, cfg),
                                      WITNESS_LANE)
    emit("nonfinite_lanes", lanes=lanes, k1_lanes=k1_lanes,
         done_lanes=done_lanes, witness_lane=WITNESS_LANE, **out)
    for name, rec in out.items():
        if not rec["ok"] or not rec["planted_lanes_with_nan"]:
            raise SystemExit(f"{name} on non-finite lanes disagrees with "
                             f"its plain version: {rec}")
    return out


def bitwise_agreement(kernel, plain, lane: int) -> dict:
    """Every output of a kernel equal to its plain version's bit for bit
    (NaN where the other has NaN, a zero's sign aside), and whether the
    plain version turned `lane` to NaN; `ok` holds the first."""
    same = all(torch.equal(k.isnan(), p.isnan())
               and torch.equal(torch.nan_to_num(k), torch.nan_to_num(p))
               for k, p in zip(kernel, plain))
    nan = bool(plain[0][..., lane].isnan().any())
    return {"ok": same, "bit_for_bit": same,
            "planted_lanes_with_nan": int(nan),
            "kernel_lane_nan": bool(kernel[0][..., lane].isnan().any())}


def forward_per_iteration(sqp, its: int) -> list:
    """K5 on the inputs of each of a route solve's `its` iterations (made
    by the route's own kernels, `sqp` advanced one iteration after each):
    the median of a window (`device_window`), the act share, the lanes and
    32-byte sectors that took each second pass (the kernel's `second`
    output), the bytes the design moves (`forward.design_bytes`) and the
    rate achieved, and the bound with the re-roll's operations counted on
    the lanes that run it."""
    T = ROUTE.n_controls
    rows = []
    for it in range(its):
        bk = backward_fused.backward_fused_cuda(*sqp.backward_inputs())
        fi = sqp.forward_inputs(bk[0], bk[1])
        B, P = fi[0].shape[-1], fi[4].shape[0]
        win = device_window(
            lambda: forward.forward_cuda(*fi, n_alpha=N_ALPHA))
        sec = torch.empty(B, dtype=torch.int8, device=fi[0].device)
        fk = forward.forward_cuda(*fi, n_alpha=N_ALPHA, second=sec)
        sp = forward.second_pass_counts(sec)
        nbytes = B * forward.design_bytes(T, P, sp["reroll_sector_share"],
                                          sp["rewrite_sector_share"])
        bound = bound_ms(list(fi) + list(fk), T * (
            N_ALPHA * FLOP_FWD_CAND_STAGE * B
            + FLOP_FWD_REROLL_STAGE * sp["reroll_lanes"]))
        rows.append({"iteration": it + 1, "median_ms": win["median_ms"],
                     "act_frac": float(fi[10].mean()),
                     "accepted_frac": float(fk[3].mean()), **sp,
                     "design_gb": nbytes / 1e9,
                     "achieved_tb_per_s": nbytes / win["median_ms"] / 1e9,
                     "bound_ms": bound[0], "bound_by": bound[1],
                     "window": win})
        del bk, fi, fk
        sqp.step()
    return rows


def route_main_path(dev, plain_route_s: float) -> dict:
    """Phase 7: `batch_solve_lane(backward="pallas")` at B=524,288, cold
    starts; then K4 and K5 timed per launch on iteration 1's inputs."""
    z0s, coeffs = scenarios(4, B_MAIN, dev)
    p = params(B_MAIN, dev, False)
    batch_solve_lane(z0s, coeffs, p, ROUTE)          # warm-up
    torch.cuda.synchronize()
    reps = 3
    reset_launches()
    t0 = time.perf_counter()
    for _ in range(reps):
        res = batch_solve_lane(z0s, coeffs, p, ROUTE)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / reps
    launches = {"solve_mega": solve_mega.launches,
                "backward_fused": backward_fused.launches,
                "forward": forward.launches}
    check_result(res, B_MAIN)
    its = int(res.n_iters.max())
    if min(launches["backward_fused"], launches["forward"]) == 0:
        raise SystemExit(f"the route did not launch its kernels: {launches}")
    if (launches["backward_fused"] != reps * its
            or launches["forward"] != reps * its
            or launches["solve_mega"] != 0):
        raise SystemExit(f"launches {launches} over {reps} solves are not "
                         f"one per kernel and iteration ({its} iterations)")
    conv = float(res.converged.float().mean())
    if conv < 0.99:
        raise SystemExit(f"route converged fraction {conv} < 0.99")

    # the host read of the exit condition: the same solve with its `its`
    # iterations enqueued back to back (a done lane never updates, so the
    # result is the same bit for bit)
    def no_read():
        sqp = LaneSQP(z0s, coeffs, p, ROUTE, two_kernel=two_kernel_stages())
        for _ in range(its):
            sqp.step()
        return sqp.result()

    no_read()
    free, free_s = host_s(no_read)
    same = all(torch.equal(getattr(free, f), getattr(res, f))
               for f in ("us", "zs", "cost", "converged", "n_iters"))
    if not same:
        raise SystemExit("the solve without the exit read differs")

    sqp = LaneSQP(z0s, coeffs, p, ROUTE, two_kernel=two_kernel_stages())
    bi = sqp.backward_inputs()
    bwd_ms = device_window(
        lambda: backward_fused.backward_fused_cuda(*bi))["median_ms"]
    bk = backward_fused.backward_fused_cuda(*bi)
    T = ROUTE.n_controls
    bwd_bound = bound_ms(list(bi) + list(bk), FLOP_BWD_STAGE * T * B_MAIN)
    del bi, bk
    fwd_its = forward_per_iteration(sqp, its)
    fwd_ms = fwd_its[0]["median_ms"]
    fwd_bound = (fwd_its[0]["bound_ms"], fwd_its[0]["bound_by"])

    # the whole-solve kernel in the route's matching variant, no gate
    mega = batch_solve_lane(z0s, coeffs, p, ROUTE_MEGA)
    vs_mega = parity_gates(
        res.us.cpu().numpy(), res.cost.cpu().numpy(),
        res.converged.cpu().numpy(), res.n_iters.cpu().numpy(),
        mega.us.cpu().numpy(), mega.cost.cpu().numpy(),
        mega.converged.cpu().numpy(), mega.n_iters.cpu().numpy(), N_STEPS)
    out = dict(batch=B_MAIN, solves_per_s=B_MAIN / wall,
               ms_per_solve=wall * 1e3,
               iterations_run=its, launches_per_solve={
                   k: v / reps for k, v in launches.items()},
               converged_frac=conv, mean_iters=float(res.n_iters.float()
                                                     .mean()),
               max_iters=its, ms_per_solve_no_exit_read=free_s * 1e3,
               exit_read_ms_per_iter=(wall - free_s) * 1e3 / its,
               bwd_ms=bwd_ms, fwd_ms=fwd_ms,
               bwd_bound_ms=bwd_bound[0], bwd_bound_by=bwd_bound[1],
               fwd_bound_ms=fwd_bound[0], fwd_bound_by=fwd_bound[1],
               fwd_ms_per_route_solve=sum(r["median_ms"] for r in fwd_its),
               fwd_iterations=fwd_its,
               plain_route_s=plain_route_s,
               plain_route_solves_per_s=B_MAIN / plain_route_s,
               vs_mega_matching_variant=vs_mega, launches=launches)
    emit("route_main_path", **out)
    return out


def route_serving(dev) -> dict:
    """Phase 8: warm-started serving through the two-kernel route."""
    z0s, coeffs = scenarios(5, B_SERVE, dev)
    p = params(B_SERVE, dev, False)
    receding_horizon_rollout(z0s, coeffs, p, ROUTE, n_cycles=1)   # set-up
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    tr = receding_horizon_rollout(z0s, coeffs, p, ROUTE,
                                  n_cycles=ROUTE_CYCLES)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"solve_mega": solve_mega.launches,
                "backward_fused": backward_fused.launches,
                "forward": forward.launches}
    its = int(tr.iters.max(dim=1).values.sum())
    if launches != {"solve_mega": 0, "backward_fused": its, "forward": its}:
        raise SystemExit(f"serving launches {launches} are not one per "
                         f"kernel and iteration ({its} iterations)")
    if not bool(torch.isfinite(tr.us).all()):
        raise SystemExit("non-finite controls in route serving")
    out = dict(robots=B_SERVE, cycles=ROUTE_CYCLES,
               control_cycles_per_s=B_SERVE * ROUTE_CYCLES / wall,
               ms_per_cycle=wall / ROUTE_CYCLES * 1e3,
               mean_warm_iters=float(tr.iters[1:].float().mean()),
               cold_iters=float(tr.iters[0].float().mean()),
               converged_frac=float(tr.converged.float().mean()),
               launches=launches)
    emit("route_serving", **out)
    return out


def early_exits(out, cap: int):
    """(tiles,) bool: the tiles that stopped before every lane was done and
    before the cap."""
    tile = solve_mega.TILE
    undone = (out[7] < 0.5).reshape(-1, tile).any(dim=1)
    its = out[4].reshape(-1, tile).max(dim=1).values
    return undone & (its < cap)


def tile_stop_faults(out, n_needed: int, cap: int) -> int:
    """Tiles that did not stop where the per-tile exit puts them (a tile
    runs another iteration while fewer than n_needed of its lanes are done
    and the cap is not reached), read from the outputs alone: a tile's
    last iteration s is its largest iteration count, a lane undone at the
    end ran all s, fewer than n_needed lanes were done before iteration s
    (a lane done at iteration j reports j), and after s the count reached
    n_needed or s is the cap."""
    tile = solve_mega.TILE
    its = out[4].reshape(-1, tile)
    done = out[7].reshape(-1, tile) > 0.5
    s = its.max(dim=1, keepdim=True).values
    ran_short = (~done & (its != s)).any(dim=1)
    late = (s[:, 0] > 0) & ((done & (its < s)).sum(dim=1) >= n_needed)
    early = (done.sum(dim=1) < n_needed) & (s[:, 0] < cap)
    return int((ran_short | late | early).sum())


def rearmed_resume(out, every: int = 7):
    """A pass-1 result as resume state with every `every`-th done lane
    re-armed as the compact rescue re-arms a stalled lane: done cleared,
    mu at the floor (1e-2 under the pair; weights x1 here), gnorm +inf."""
    done, conv, mu, gnorm = out[7].clone(), out[3], out[6].clone(), \
        out[5].clone()
    pick = torch.zeros_like(done, dtype=torch.bool)
    pick[::every] = True
    pick &= done > 0.5
    done[pick] = 0.0
    mu[pick] = 1e-2
    gnorm[pick] = float("inf")
    return (done, conv, mu, gnorm), int(pick.sum())


def lane_by_lane(ins, cfg, what: str, resume=None, gate: bool = True):
    """Phase 9's comparison of the kernel and its plain version on the same
    inputs and the same 128-lane tiles: the single-pass gates, their
    numerics over the lanes converged on both sides (a lane stopped by its
    tile or its cap, or stalled, holds an iterate away from a stationary
    point; the fraction gates count it); the done flags equal on >= 0.999
    of all lanes; as many tiles exited early on both sides (at least one
    under done_frac < 1); and each side's tiles stopped exactly where the
    per-tile exit puts them (`tile_stop_faults`). Raises on a broken gate
    unless `gate` is False. Returns (record, kernel outputs, plain
    outputs); the record's `ok` is the verdict."""
    out_k, t_k, out_p, t_p = both_sides(ins, cfg, resume)
    both = (out_k[3] > 0.5) & (out_p[3] > 0.5)
    g = outputs_gates(out_k, out_p, cfg.n_steps, lanes=both)
    du = (out_k[1] - out_p[1]).abs().amax(dim=(0, 1))
    done_k, done_p = out_k[7] > 0.5, out_p[7] > 0.5
    cap = cfg.max_sqp_iters
    n_needed = solve_mega.resolve_knobs(cfg, torch.float32).n_done_needed
    open_ = ~both
    early = [int(early_exits(o, cap).sum()) for o in (out_k, out_p)]
    rec = dict(
        kernel_s=t_k, plain_s=t_p,
        unconverged_lanes=int(open_.sum()),
        unconverged_stalled_both=int((open_ & done_k & done_p).sum()),
        unconverged_max_du=float(du[open_].max()) if open_.any() else 0.0,
        done_flags_agree=float((done_k == done_p).float().mean()),
        undone_lanes=[int((~done_k).sum()), int((~done_p).sum())],
        early_exit_tiles=early,
        tile_stop_faults=[tile_stop_faults(o, n_needed, cap)
                          for o in (out_k, out_p)],
        worst_lane=worst_lane(out_k, out_p),
        worst_compared_cost=worst_lane(out_k, out_p, "cost", both), **g)
    rec["ok"] = bool(
        g["ok"] and rec["done_flags_agree"] >= 0.999
        and rec["tile_stop_faults"] == [0, 0] and early[0] == early[1]
        and (n_needed == solve_mega.TILE or early[0] > 0))
    if gate and not rec["ok"]:
        raise SystemExit(f"kernel disagrees with its plain version ({what}): "
                         f"{rec}")
    return rec, out_k, out_p


# the seed of phase 9, at both batches
LONG_SEED = 6


def long_variants(dev, B: int, seed: int, gate: bool = True):
    """Phase 9's two comparisons on one batch (`lane_by_lane`): done_frac =
    0.97 cold, then done_frac = 1 resumed from the kernel's pass-1 result
    with every 7th done lane re-armed. Yields (variant, record, (inputs,
    config, resume, kernel outputs, plain outputs))."""
    pass1 = dataclasses.replace(LONG, done_frac=LONG.compact_frac)
    z0s, coeffs = scenarios(seed, B, dev)
    ins = lane_inputs(z0s, coeffs, params(B, dev, False), LONG)
    rec, out_k, out_p = lane_by_lane(
        ins, pass1, f"N=48, done_frac=0.97, B={B}, seed {seed}", gate=gate)
    rec.update(n_done_needed=solve_mega.resolve_knobs(
        pass1, torch.float32).n_done_needed, tiles=B // solve_mega.TILE)
    yield "done_frac_0.97_cold", rec, (ins, pass1, None, out_k, out_p)
    resume, n_rearmed = rearmed_resume(out_k)
    ins = ins[:5] + (out_k[1],)
    rec, out_k, out_p = lane_by_lane(
        ins, LONG, f"N=48, resume, B={B}, seed {seed}", resume=resume,
        gate=gate)
    was_done = resume[0] > 0.5
    if not bool((out_k[4][was_done] == 0).all()):
        raise SystemExit("a lane resumed done was iterated")
    rec.update(resumed_done=int(was_done.sum()),
               resumed_stalled=int((was_done & (resume[1] < 0.5)).sum()),
               rearmed=n_rearmed)
    yield "resume_done_frac_1", rec, (ins, LONG, resume, out_k, out_p)


def long_kernel_vs_plain(dev) -> float:
    """Phase 9: resume state and the per-block exit, kernel against plain
    version at B=8192 and B=131,072 (`long_variants`). Returns the largest
    gated |du|."""
    worst = 0.0
    for B in (B_VERIFY, B_LONG):
        for variant, rec, _ in long_variants(dev, B, LONG_SEED):
            emit("long_kernel_vs_plain", variant=variant, seed=LONG_SEED,
                 **rec)
            worst = max(worst, rec["max_du"])
    return worst


# the lanes a survey record witnesses at most, and the |du| at which a
# lane counts as parted between the two sides
WITNESSES = 5
PARTED_DU = 1e-4


def suspects(rec, out_k, out_p, cap: int) -> list:
    """The lanes a broken phase-9 gate points at, in this order: lanes
    converged on both sides beyond a numeric limit; then, in tiles that
    stopped apart (at different iterations, or early on one side only),
    the lanes whose done flags differ, the lanes done on both sides at
    different iterations (those decide a tile's stop), and the others
    whose iteration counts differ."""
    lim = rec["limits"]
    both = (out_k[3] > 0.5) & (out_p[3] > 0.5)
    du = (out_k[1] - out_p[1]).abs().amax(dim=(0, 1))
    dc = (out_k[2] - out_p[2]).abs() / (1.0 + out_p[2].abs())
    over = both & (dc <= 1e-3) & ((du > lim["max_du"])
                                  | (dc > lim["max_rel_dcost"]))
    tile = solve_mega.TILE
    stop_k, stop_p = (o[4].reshape(-1, tile).max(dim=1).values
                      for o in (out_k, out_p))
    apart = ((stop_k != stop_p) | (early_exits(out_k, cap)
                                   != early_exits(out_p, cap)))
    apart = apart.repeat_interleave(tile)
    done_k, done_p = out_k[7] > 0.5, out_p[7] > 0.5
    flag = apart & (done_k != done_p)
    its = apart & ~flag & (out_k[4] != out_p[4])
    lanes = []
    for m in (over, flag, its & done_k, its & ~done_k):
        lanes += torch.nonzero(m).flatten().tolist()
    return lanes[:WITNESSES]


def line_search_record(diag, i: int, n_ls: int) -> dict:
    """Lane i's line search from a diagnostic output (`check_diag`): the
    cost before the step, the alpha chosen, and each candidate's margin
    (cost before - candidate cost) / (1 + |cost before|); a candidate
    lowers the cost where its margin is > 0."""
    d = diag[:, i].double().cpu()
    before = float(d[n_ls])
    return {"cost_before": before, "alpha": float(d[n_ls + 1]),
            "candidate_costs": d[:n_ls].tolist(),
            "margins": ((before - d[:n_ls]) / (1.0 + abs(before))).tolist()}


def parting_verdict(kd: dict, pd: dict) -> str:
    """What decided a parting, from both sides' line searches at the cap
    where the lane parts: "acceptance tie" when the sides chose different
    alphas and every candidate whose acceptance differs lies within TIE_REL
    of the cost before on both sides; "acceptance differs" when such a
    candidate lies further out (a kernel path that differs); "same alpha"
    when the line search agreed, so another rounding-level decision parted
    the lane (a box-QP clamp, the convergence or stall test)."""
    if kd["alpha"] == pd["alpha"]:
        return "same alpha"
    differ = [j for j, (a, b) in enumerate(zip(kd["margins"], pd["margins"]))
              if (a > 0) != (b > 0)]
    wide = [j for j in differ
            if max(abs(kd["margins"][j]), abs(pd["margins"][j])) > TIE_REL]
    return "acceptance differs" if wide else "acceptance tie"


def witness(ins, cfg, resume, out_k, out_p, lane: int, blobs=None) -> dict:
    """Where one lane parts between the kernel and its plain version, why,
    and how far each side's answer lies from float64. The lane's tile alone
    (its exit depends on no other lane) runs on both sides with the
    iteration cap at 1, 2, ... up to the lane's count: per cap the lane's
    |du| and each side's (cost, mu, conv, done), and the first cap after
    which |du| > PARTED_DU. At that cap both sides' line searches are read
    from the diagnostic output (`line_search_record`) and the parting is
    classified (`parting_verdict`). Then the plain version solves the tile
    in float64 with the knobs float32 resolves: each side's |du| and
    relative cost from that solve, and whether float64's cost lies between
    the sides or beside them."""
    tile = solve_mega.TILE
    t0 = lane // tile * tile
    i = lane - t0
    sub = [a[..., t0:t0 + tile] for a in ins]
    res = None if resume is None else [r[t0:t0 + tile] for r in resume]
    bl = None if blobs is None else [b[..., t0:t0 + tile] for b in blobs]
    n_it = int(max(out_k[4][lane], out_p[4][lane]))
    n_ls = cfg.ls_for(torch.float32)
    trace, parted, at_part = [], None, None

    def state(o):
        return [float(o[q][i]) for q in (2, 6, 3, 7)]

    for j in range(1, n_it + 1):
        cj = dataclasses.replace(cfg, max_sqp_iters=j)
        dk, dp = (torch.full((n_ls + 2, tile), float("nan"),
                             device=sub[0].device) for _ in range(2))
        k = solve_mega.solve_mega_cuda(*sub, cj, resume=res, blobs=bl,
                                       diag=dk)
        p = solve_mega.solve_mega_plain(*sub, cj, resume=res, blobs=bl,
                                        diag=dp)
        du = float((k[1][..., i] - p[1][..., i]).abs().max())
        trace.append({"cap": j, "du": du, "kernel": state(k),
                      "plain": state(p)})
        if parted is None and du > PARTED_DU:
            parted = j
            kd = line_search_record(dk, i, n_ls)
            pd = line_search_record(dp, i, n_ls)
            at_part = {"kernel": kd, "plain": pd,
                       "verdict": parting_verdict(kd, pd)}
    f32, f64 = torch.float32, torch.float64
    obs = bl is not None
    c64 = dataclasses.replace(
        cfg, ddp=cfg.ddp_for(f32), ddp_gate=cfg.gate_for(obs, f32),
        mu_init=cfg.mu_init_for(f32, obs), ls_iters=cfg.ls_for(f32),
        tol_cost=10.0 * float(torch.finfo(f32).eps))
    o64 = solve_mega.solve_mega_plain(
        *[a.to(f64) for a in sub], c64,
        resume=None if res is None else [r.to(f64) for r in res],
        blobs=None if bl is None else [b.to(f64) for b in bl])
    us64, cost64 = o64[1][..., i], float(o64[2][i])

    def from64(o):
        return [float((o[1][..., lane].double() - us64).abs().max()),
                abs(float(o[2][lane]) - cost64) / (1.0 + abs(cost64))]

    ck, cp = float(out_k[2][lane]), float(out_p[2][lane])
    return {"lane": lane, "tile": lane // tile,
            "iters": [float(out_k[4][lane]), float(out_p[4][lane])],
            "du": float((out_k[1][..., lane] - out_p[1][..., lane]).abs()
                        .max()),
            "parted_at_cap": parted, "line_search_at_part": at_part,
            "trace": trace,
            "f64": {"cost": cost64, "iters": float(o64[4][i]),
                    "conv": float(o64[3][i]),
                    "between_sides": min(ck, cp) <= cost64 <= max(ck, cp)},
            "kernel_du_rel_dcost_from_f64": from64(out_k),
            "plain_du_rel_dcost_from_f64": from64(out_p)}


# the tied lanes per seed that the obstacle survey traces through pass 1
OBSTACLE_WITNESSES = 2


def cost64_of(ins, cfg, us, lanes, blobs=None) -> list:
    """The float64 cost of the given lanes' controls `us` (T, 2, B): the
    plain version's initial rollout with no SQP iteration, in float64."""
    idx = torch.tensor(lanes, device=us.device)
    f64 = torch.float64

    def tk(a):
        return a.index_select(-1, idx).to(f64)

    c0 = dataclasses.replace(cfg, max_sqp_iters=0, schedule="single",
                             done_frac=1.0)
    out = solve_mega.solve_mega_plain(
        *[tk(a) for a in ins[:5]], tk(us), c0,
        blobs=None if blobs is None else tuple(tk(b) for b in blobs))
    return out[2].tolist()


def obstacle_ties(dev, seed: int) -> dict:
    """The obstacle main path (as phase 16: N=30, B=524,288, K=4, cap 30,
    compact) on the kernel and on the plain version: the acceptance ties
    (`acceptance_ties`) counted, and for each tied lane the float64 cost of
    both sides' controls (`cost64_of`) — equally good answers agree there
    to rounding."""
    blobs = blob_field(seed, B_MAIN, K_MAIN, dev).lane()
    z0s, coeffs = scenarios(seed, B_MAIN, dev)
    ins = lane_inputs(z0s, coeffs, params(B_MAIN, dev, False), OBST)
    out_k = solve_mega.solve_mega_scheduled(*ins, OBST, blobs=blobs)
    out_p = solve_mega.solve_mega_scheduled(*ins, OBST, plain=True,
                                            blobs=blobs)
    g = outputs_gates(out_k, out_p, OBST.n_steps, compact=True, ties=True)
    tie = acceptance_ties(out_k, out_p, g["limits"]["max_du"])
    lanes = torch.nonzero(tie).flatten().tolist()
    recs = []
    if lanes:
        ck = cost64_of(ins, OBST, out_k[1], lanes, blobs)
        cp = cost64_of(ins, OBST, out_p[1], lanes, blobs)
        pass1 = solve_mega.compact_pass1_cfg(OBST)
        out1 = [solve_mega.solve_mega_cuda(*ins, pass1, blobs=blobs),
                solve_mega.solve_mega_plain(*ins, pass1, blobs=blobs)]
        for n, (lane, a, b) in enumerate(zip(lanes, ck, cp)):
            rec = {**lane_record(out_k, out_p, lane), "cost64": [a, b],
                   "rel_dcost64": abs(a - b) / (1.0 + abs(b))}
            if n < OBSTACLE_WITNESSES:
                # the lane's tile through pass 1 (the per-block exit)
                rec["pass1_witness"] = witness(ins, pass1, None, *out1,
                                               lane, blobs)
            recs.append(rec)
    return {"seed": seed, "batch": B_MAIN, "ties": len(lanes),
            "tie_frac": len(lanes) / B_MAIN, "ok": g["ok"],
            "max_du": g["max_du"], "tied_lanes": recs}


def survey(dev, seeds) -> None:
    """`chip_smoke.py --survey SEED,...`: phase 9 on further seeds at
    B=131,072, recorded rather than stopped at a broken gate: each
    variant's record, and for a broken one a witness (`witness`) of each
    lane the gate points at (`suspects`). Exits 1 if any gate broke."""
    broke = []
    for seed in seeds:
        for variant, rec, (ins, cfg, res, out_k, out_p) in long_variants(
                dev, B_LONG, seed, gate=False):
            if not rec["ok"]:
                broke.append((seed, variant))
                rec["witnesses"] = [
                    witness(ins, cfg, res, out_k, out_p, lane)
                    for lane in suspects(rec, out_k, out_p,
                                         cfg.max_sqp_iters)]
            emit("survey", variant=variant, seed=seed, **rec)
    for seed in seeds:
        rec = obstacle_ties(dev, seed)
        emit("survey_obstacle_ties", **rec)
        if not rec["ok"]:
            broke.append((seed, "obstacles"))
    emit("survey_verdict", seeds=list(seeds), broken=broke)
    if broke:
        raise SystemExit(1)


def schedule_against_plain(ins, cfg, what: str, compact: bool, blobs=None,
                           refs=None) -> tuple:
    """A schedule with its passes on the kernel against the same schedule
    on the plain version, on the same inputs (`compact`: the compact
    rule); raises on a broken gate. Returns (gates, plain seconds)."""
    kernel = solve_mega.solve_mega_scheduled(*ins, cfg, blobs=blobs,
                                             refs=refs)
    plain, plain_s = host_s(lambda: solve_mega.solve_mega_scheduled(
        *ins, cfg, plain=True, blobs=blobs, refs=refs))
    g = outputs_gates(kernel, plain, cfg.n_steps, compact,
                      ties=blobs is not None)
    g["worst_lane"] = worst_lane(kernel, plain)
    if not g["ok"]:
        raise SystemExit(f"the schedule disagrees with its plain version "
                         f"({what}): {g}")
    return g, plain_s


def compact_run(dev, cfg, B: int, seed: int, reps: int, blobs=None) -> dict:
    """`batch_solve_lane` under the compact schedule ("auto" at N > 36):
    warm-up, then `reps` solves timed on the host clock with every count
    read just after. Raises unless compaction was observed engaged on
    every solve: two passes, the second on a tail of whole tiles smaller
    than the batch, as the schedule's own counters show."""
    z0s, coeffs = scenarios(seed, B, dev)
    p = params(B, dev, False)
    batch_solve_lane(z0s, coeffs, p, cfg, blobs=blobs)            # warm-up
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    for _ in range(reps):
        res = batch_solve_lane(z0s, coeffs, p, cfg, blobs=blobs)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / reps
    counts = {"launches": solve_mega.launches, "passes": solve_mega.passes,
              "tail_lanes": solve_mega.tail_lanes}
    n_tail = counts["tail_lanes"] // reps
    tile = solve_mega.TILE
    if (counts["launches"], counts["passes"]) != (2 * reps, 2 * reps) or not (
            counts["tail_lanes"] == reps * n_tail and 0 < n_tail < B
            and n_tail % tile == 0):
        raise SystemExit(f"compaction not engaged over {reps} solves: "
                         f"{counts}")
    check_result(res, B, cfg.n_steps)
    need = int(solve_mega.last_need)
    conv = float(res.converged.float().mean())
    if conv < 0.99:
        raise SystemExit(f"N={cfg.n_steps} converged fraction {conv} < 0.99")
    return dict(z0s=z0s, coeffs=coeffs, p=p, res=res, wall=wall,
                out=dict(batch=B, n_steps=cfg.n_steps,
                         cap=cfg.max_sqp_iters, ms_per_solve=wall * 1e3,
                         solves_per_s=B / wall, n_tail=n_tail,
                         need_rescue=need,
                         rescue_overflow=max(0, need - n_tail),
                         converged_frac=conv,
                         mean_iters=float(res.n_iters.float().mean()),
                         max_iters=int(res.n_iters.max()),
                         counts_over_reps=counts, reps=reps))


def passes_total(passes, lanes) -> tuple:
    """(kernel ms, bound (ms, which)) of a compact schedule's passes, after
    checking that they ran on the lanes the schedule's counters
    reported."""
    if [c["lanes"] for c in passes] != lanes:
        raise SystemExit(f"the compact passes ran on "
                         f"{[c['lanes'] for c in passes]} lanes, not {lanes}")
    worst = max(passes, key=lambda c: c["bound_ms"])
    return (sum(c["kernel_ms"] for c in passes),
            (sum(c["bound_ms"] for c in passes), worst["bound_by"]))


def lockstep_window(ins):
    """The per-block (lockstep) variant at n_done_needed = TILE, which
    computes what the per-thread variant does: its device window
    (`device_window`), and whether its outputs equal the per-thread
    variant's."""
    single = dataclasses.replace(LONG, schedule="single")
    win = device_window(lambda: solve_mega.solve_mega_cuda(
        *ins, single, lockstep=True))
    lock = solve_mega.solve_mega_cuda(*ins, single, lockstep=True)
    thread = solve_mega.solve_mega_cuda(*ins, single)
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(lock, thread))
    return win, same


def long_main_path(dev) -> dict:
    """Phase 10: the long-horizon main path, N=48, B=131,072."""
    reps = 3
    run = compact_run(dev, LONG, B_LONG, 7, reps)
    out = run["out"]
    ins = lane_inputs(run["z0s"], run["coeffs"], run["p"], LONG)
    out["device_per_solve"] = device_window(
        lambda: solve_mega.solve_mega_scheduled(*ins, LONG))
    passes = out["passes"] = compact_passes(ins, LONG)
    kernel_ms, bound = passes_total(passes, [B_LONG, out["n_tail"]])
    # the single pass at the same shape
    single = dataclasses.replace(LONG, schedule="single")
    out_s, win, sb, wm = timed_launch(ins, single)
    single_ms = win["median_ms"]
    out["single_pass"] = dict(
        kernel_ms=single_ms, solves_per_s=B_LONG / (single_ms / 1e3),
        bound_ms=sb[0], bound_by=sb[1],
        converged_frac=float((out_s[3] > 0.5).float().mean()),
        mean_iters=float(out_s[4].mean()), max_iters=int(out_s[4].max()),
        mean_warp_max_iters=wm, window=win)
    out["lockstep_per_block"], same = lockstep_window(ins)
    out["lockstep_equals_per_thread"] = same
    if not same:
        raise SystemExit("the per-block loop at n_done_needed = 128 differs "
                         "from the per-thread loop")
    g, plain_s = schedule_against_plain(ins, LONG, "N=48", compact=True)
    out.update(kernel_ms=kernel_ms, bound_ms=bound[0], bound_by=bound[1],
               plain_ms=plain_s * 1e3, vs_plain=g)
    emit("long_main_path", **out)
    return out


def longest_path(dev) -> dict:
    """Phase 11: N=100 at cap 45, B=16,384, through the same path, and
    against the plain compact schedule on the same inputs."""
    run = compact_run(dev, LONGEST, B_LONGEST, 10, 2)
    out = run["out"]
    ins = lane_inputs(run["z0s"], run["coeffs"], run["p"], LONGEST)
    passes = out["passes"] = compact_passes(ins, LONGEST)
    kernel_ms, bound = passes_total(passes, [B_LONGEST, out["n_tail"]])
    g, plain_s = schedule_against_plain(ins, LONGEST, "N=100", compact=True)
    out.update(kernel_ms=kernel_ms, bound_ms=bound[0], bound_by=bound[1],
               plain_s=plain_s, vs_plain=g)
    emit("longest_path", **out)
    return out


def sorted_schedule(dev) -> dict:
    """Phase 12: the sorted two passes against the single pass, N=30,
    B=131,072 (the checks of the JAX package's sorted-schedule test), and
    against the plain sorted schedule on the same inputs at the
    single-pass gates (at done_frac = 1 a lane's result does not depend on
    the tile the sort puts it in)."""
    B = B_LONG
    z0s, coeffs = scenarios(11, B, dev)
    p = params(B, dev, False)
    single = dataclasses.replace(PROD, schedule="single")
    srt = dataclasses.replace(PROD, schedule="sorted", presolve_iters=3)
    ins = lane_inputs(z0s, coeffs, p, PROD)
    res1 = batch_solve_lane(z0s, coeffs, p, single)
    reset_launches()
    res2 = batch_solve_lane(z0s, coeffs, p, srt)
    torch.cuda.synchronize()
    counts = (solve_mega.launches, solve_mega.passes)
    if counts != (2, 2):
        raise SystemExit(f"sorted ran {counts} launches/passes, not 2")
    w1 = device_window(lambda: solve_mega.solve_mega_scheduled(*ins, single))
    w2 = device_window(lambda: solve_mega.solve_mega_scheduled(*ins, srt))
    ms1, ms2 = w1["median_ms"], w2["median_ms"]
    f1 = float(res1.converged.float().mean())
    f2 = float(res2.converged.float().mean())
    both = res1.converged & res2.converged
    du = float((res1.us - res2.us).abs().amax(dim=(1, 2))[both].max())
    dc = float(((res1.cost - res2.cost).abs()
                / res1.cost.abs().clamp(min=1.0))[both].max())
    out = dict(batch=B, single_ms=ms1, sorted_ms=ms2, single_window=w1,
               sorted_window=w2,
               single_solves_per_s=B / (ms1 / 1e3),
               sorted_solves_per_s=B / (ms2 / 1e3), conv_single=f1,
               conv_sorted=f2, both_converged=float(both.float().mean()),
               max_du_both=du, max_rel_dcost_both=dc,
               max_iters_sorted=int(res2.n_iters.max()),
               limits={"conv_drop": 0.05, "du": 2e-3, "rel_dcost": 1e-2,
                       "iters": PROD.max_sqp_iters})
    if not (f2 >= f1 - 0.05 and du < 2e-3 and dc < 1e-2
            and out["max_iters_sorted"] <= PROD.max_sqp_iters
            and bool(torch.isfinite(res2.us).all())):
        raise SystemExit(f"sorted schedule off the single pass: {out}")
    g, plain_s = schedule_against_plain(ins, srt, "sorted", compact=False)
    out.update(plain_s=plain_s, vs_plain=g)
    emit("sorted_schedule", **out)
    return out


def sweep_phase(dev) -> dict:
    """Phase 13: the tuning sweep with and without the presort, on the
    same candidates and scenarios."""
    cands = sample_weight_candidates(
        torch.Generator(device=dev).manual_seed(12), N_CANDIDATES,
        MPCParams())
    out = {"candidates": N_CANDIDATES, "scenarios": B_SWEEP}
    runs = {}
    for presort in (False, True):
        def sweep():
            return tuning_sweep(torch.Generator(device=dev).manual_seed(13),
                                cands, B_SWEEP, PROD, presort=presort)
        sweep()                                      # warm-up
        reset_launches()
        sw, secs = host_s(sweep)
        runs[presort] = sw
        out["presorted" if presort else "unsorted"] = dict(
            seconds=secs, best_index=sw.best_index,
            launches=solve_mega.launches,
            converged_frac=sw.converged_frac.tolist(),
            mean_iters=sw.mean_iters.tolist(),
            mean_cost=sw.mean_cost.tolist())
    a, b = runs[False], runs[True]
    rel = float(((a.mean_cost - b.mean_cost).abs() / a.mean_cost.abs())
                .max())
    out["max_rel_mean_cost"] = rel
    emit("sweep", **out)
    if a.best_index != b.best_index or rel > 1e-4:
        raise SystemExit(f"presort changed the sweep: best "
                         f"{a.best_index} vs {b.best_index}, rel {rel}")
    return out


def long_serving(dev) -> dict:
    """Phase 14: warm-started serving at N=48."""
    tr, wall, counts, z0s, coeffs, p = timed_serving(dev, LONG, B_LONG, 14,
                                                     LONG_CYCLES)
    if counts["launches"] != 2 * LONG_CYCLES:
        raise SystemExit(f"long-horizon serving: {counts}")
    # cycle 1's warm-started solve (the plant state after cycle 0 and cycle
    # 0's solution shifted by one) against the plain compact schedule
    us0 = batch_solve_lane(z0s, coeffs, p, LONG).us
    warm = torch.cat([us0[:, 1:], us0[:, -1:]], dim=1)
    g, plain_s = schedule_against_plain(
        lane_inputs(tr.zs[1], coeffs, p, LONG, u_init=warm), LONG,
        "N=48 serving, warm start", compact=True)
    out = serving_record(tr, wall, B_LONG, LONG_CYCLES, counts)
    out.update(warm_plain_s=plain_s, vs_plain=g)
    emit("long_serving", **out)
    return out


def timed_serving(dev, cfg, B: int, seed: int, cycles: int, blobs=None):
    """Warm-started serving: a 1-cycle set-up run, then `cycles` cycles
    timed on the host clock to a sync with every count read just after.
    Returns (trace, wall seconds, counts, z0s, coeffs, params)."""
    z0s, coeffs = scenarios(seed, B, dev)
    p = params(B, dev, False)
    receding_horizon_rollout(z0s, coeffs, p, cfg, n_cycles=1, blobs=blobs)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    tr = receding_horizon_rollout(z0s, coeffs, p, cfg, n_cycles=cycles,
                                  blobs=blobs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {"launches": solve_mega.launches, "passes": solve_mega.passes,
              "tail_lanes": solve_mega.tail_lanes}
    if not bool(torch.isfinite(tr.us).all()):
        raise SystemExit("non-finite controls in serving")
    return tr, wall, counts, z0s, coeffs, p


def serving_record(tr, wall: float, B: int, cycles: int, counts) -> dict:
    """The serving metrics of a timed run."""
    return dict(robots=B, cycles=cycles,
                control_cycles_per_s=B * cycles / wall,
                ms_per_cycle=wall / cycles * 1e3,
                mean_warm_iters=float(tr.iters[1:].float().mean()),
                cold_iters=float(tr.iters[0].float().mean()),
                converged_frac=float(tr.converged.float().mean()), **counts)


# Phase 15's variants: (name, config, blobs, setpoint profile, per-lane
# wheelbase)
EFG_VARIANTS = [
    ("blobs_gn", dataclasses.replace(PROD, ddp=False, ls_iters=8), True,
     False, False),
    ("blobs_ddp", PROD, True, False, False),
    ("bicycle_exact", dataclasses.replace(BICYCLE, trig="exact"), False,
     False, False),
    ("bicycle_fast_lane_lf", BICYCLE, False, False, True),
    ("refs", PROD, False, True, False),
    ("blobs_refs", PROD, True, True, False),
]


def stage_efg_vs_plain(dev) -> dict:
    """Phase 15: K1's blobs, setpoint and bicycle variants against the
    plain version at B=8192, the single-pass gates. Returns the largest
    gated |du| per option."""
    worst = {"blobs": 0.0, "bicycle": 0.0, "refs": 0.0}
    z0s, coeffs = scenarios(15, B_VERIFY, dev)
    for name, cfg, bl, rf, lane_lf in EFG_VARIANTS:
        leaves = {"lf": np.linspace(0.3, 0.8, B_VERIFY)} if lane_lf else {}
        p = MPCParams.from_numpy(leaves).astype(torch.float32, dev)
        blobs = blob_field(15, B_VERIFY, K_MAIN, dev).lane() if bl else None
        refs = (lane_major(ramp_refs(15, B_VERIFY, cfg.n_steps, dev))
                if rf else None)
        g, t_k, t_p, _, _ = held_against_plain(
            lane_inputs(z0s, coeffs, p, cfg), cfg, f"variant {name}",
            blobs=blobs, refs=refs)
        emit("stage_efg_vs_plain", variant=name, kernel_s=t_k, plain_s=t_p,
             **g)
        for option in worst:
            if option in name:
                worst[option] = max(worst[option], g["max_du"])
    return worst


def obstacle_main_path(dev) -> dict:
    """Phase 16: `bench.py --obstacles` — N=30, B=524,288, K=4 blobs per
    lane, cap 30 under the compact schedule — then each pass's kernel time
    and bound, and the schedule against the plain schedule at full
    width."""
    reps = 3
    blobs = blob_field(16, B_MAIN, K_MAIN, dev)
    run = compact_run(dev, OBST, B_MAIN, 16, reps, blobs=blobs)
    out = run["out"]
    ins = lane_inputs(run["z0s"], run["coeffs"], run["p"], OBST)
    bl = blobs.lane()
    out["device_per_solve"] = device_window(
        lambda: solve_mega.solve_mega_scheduled(*ins, OBST, blobs=bl))
    passes = out["passes"] = compact_passes(ins, OBST, blobs=bl)
    kernel_ms, bound = passes_total(passes, [B_MAIN, out["n_tail"]])
    g, plain_s = schedule_against_plain(ins, OBST, "obstacles, N=30",
                                        compact=True, blobs=bl)
    out.update(blobs_per_lane=K_MAIN, kernel_ms=kernel_ms,
               bound_ms=bound[0], bound_by=bound[1], plain_ms=plain_s * 1e3,
               vs_plain=g)
    emit("obstacle_main_path", **out)
    return out


def obstacle_serving(dev) -> dict:
    """Phase 17: `bench.py --serving --obstacles` — 131,072 robots, one
    blob each, 10 warm cycles under the obstacle knobs (two compact passes
    per cycle) — and cycle 1's warm-started solve against the plain
    compact schedule."""
    blobs = blob_field(17, B_SERVE, K_SERVE, dev)
    tr, wall, counts, z0s, coeffs, p = timed_serving(
        dev, OBST, B_SERVE, 17, N_CYCLES, blobs)
    if counts["launches"] != 2 * N_CYCLES:
        raise SystemExit(f"obstacle serving: {counts} over {N_CYCLES} "
                         "cycles, not two compact passes each")
    us0 = batch_solve_lane(z0s, coeffs, p, OBST, blobs=blobs).us
    warm = torch.cat([us0[:, 1:], us0[:, -1:]], dim=1)
    g, plain_s = schedule_against_plain(
        lane_inputs(tr.zs[1], coeffs, p, OBST, u_init=warm), OBST,
        "obstacle serving, warm start", compact=True, blobs=blobs.lane())
    out = serving_record(tr, wall, B_SERVE, N_CYCLES, counts)
    out.update(blobs_per_robot=K_SERVE, warm_plain_s=plain_s, vs_plain=g)
    emit("obstacle_serving", **out)
    return out


def bicycle_paths(dev) -> dict:
    """Phase 18: the bicycle main path (N=30, B=524,288) against the plain
    version at full width, then bicycle serving, 131,072 x 3 cycles (one
    launch per cycle)."""
    out = main_path(dev, "bicycle_main_path", BICYCLE, 18)
    tr, wall, counts, _, _, _ = timed_serving(dev, BICYCLE, B_SERVE, 19,
                                              BIKE_CYCLES)
    if counts["launches"] != BIKE_CYCLES:
        raise SystemExit(f"bicycle serving: {counts} over {BIKE_CYCLES} "
                         "cycles")
    emit("bicycle_serving", **serving_record(tr, wall, B_SERVE, BIKE_CYCLES,
                                             counts))
    return out


def schedules_blobs_refs(dev) -> float:
    """Phase 20: the compact (N=48, cap 22) and sorted (N=30) schedules at
    B=16,384 with per-lane blobs (K=4) and profiles, each against the same
    schedule on the plain version (the compact rule for compact), with the
    schedule's own counts: two passes, and under compact a tail of whole
    tiles smaller than the batch. Returns the largest gated |du|."""
    worst = 0.0
    srt = dataclasses.replace(PROD, schedule="sorted", presolve_iters=3)
    for name, cfg, compact in (("compact_n48", LONG, True),
                               ("sorted_n30", srt, False)):
        z0s, coeffs = scenarios(20, B_SCHED, dev)
        ins = lane_inputs(z0s, coeffs, params(B_SCHED, dev, False), cfg)
        blobs = blob_field(20, B_SCHED, K_MAIN, dev).lane()
        refs = lane_major(ramp_refs(20, B_SCHED, cfg.n_steps, dev))
        reset_launches()
        out_k = solve_mega.solve_mega_scheduled(*ins, cfg, blobs=blobs,
                                                refs=refs)
        torch.cuda.synchronize()
        counts = {"launches": solve_mega.launches,
                  "passes": solve_mega.passes,
                  "tail_lanes": solve_mega.tail_lanes}
        tail = counts["tail_lanes"]
        engaged = (0 < tail < B_SCHED and tail % solve_mega.TILE == 0
                   if compact else tail == 0)
        if (counts["launches"], counts["passes"]) != (2, 2) or not engaged:
            raise SystemExit(f"{name} with blobs and profiles: {counts}")
        out_p, plain_s = host_s(lambda: solve_mega.solve_mega_scheduled(
            *ins, cfg, plain=True, blobs=blobs, refs=refs))
        g = outputs_gates(out_k, out_p, cfg.n_steps, compact, ties=True)
        rec = dict(schedule=name, plain_s=plain_s,
                   converged_frac=float((out_k[3] > 0.5).float().mean()),
                   worst_lane=worst_lane(out_k, out_p), **counts, **g)
        if compact:
            rec["need_rescue"] = int(solve_mega.last_need)
        emit("schedule_blobs_refs", **rec)
        if not g["ok"]:
            raise SystemExit(f"{name} with blobs and profiles disagrees "
                             f"with its plain version: {rec}")
        worst = max(worst, g["max_du"])
    return worst


# The registry-generic engine (phases 21-23): `engine.batch_solve` over the
# batch-first single-scenario solver at full width, B=16,384 (a tuning or
# scenario-study batch: every SQP iteration is a few thousand small torch
# ops, so the width amortizes their dispatch); the profile fallback at
# B=1,000 (not whole tiles); the custom-family sweep, 8 x 2,000; one
# scenario at N=30 and N=100 (the planner's per-cycle solve)
B_ENGINE = 16384
B_FALLBACK = 1000
SWEEP_CUSTOM = (8, 2000)
SINGLE_REPS = {30: 20, 100: 5}
TRICYCLE = "tricycle_smoke"


def result_gates(a, b, n_steps: int) -> dict:
    """`verify.parity_gates` between two batch-major SolveResults."""
    def host(r):
        return (r.us.cpu().numpy(), r.cost.cpu().numpy(),
                r.converged.cpu().numpy(), r.n_iters.cpu().numpy())
    return parity_gates(*host(a), *host(b), n_steps)


def register_tricycle() -> None:
    """tests/test_ddp.py's custom family, built by `model_from_step` from a
    step function alone: steering mildly coupled to speed."""
    from mpc_ros_tpu_torch.models.base import model_from_step
    from mpc_ros_tpu_torch.ops.poly import polyeval

    def step(z, u, coeffs, dt, sign, p):
        x, y, th, v, cte, eth = (z[..., i] for i in range(6))
        w, a = u[..., 0], u[..., 1]
        dt = torch.as_tensor(dt, dtype=z.dtype, device=z.device)
        dth = w * (1.0 + 0.1 * v) * dt
        return torch.stack([x + v * torch.cos(th) * dt,
                            y + v * torch.sin(th) * dt, th + dth, v + a * dt,
                            (polyeval(coeffs, x) - y)
                            + sign * v * torch.sin(eth) * dt, eth + dth],
                           dim=-1)

    def bounds(p, dtype, device=None):
        one = torch.ones(2, dtype=dtype, device=device)
        return -one, one

    model_from_step(TRICYCLE, step, bounds, allow_override=True)


def engine_record(fn, B: int, reps: int = WINDOW):
    """(result, record): `fn` run once to warm up, then `reps` times on the
    host clock to a sync each; the median ms per solve call, solves/s, mean
    iterations, converged fraction and host reads per call (the solver's
    per-iteration read of "every lane done", `ilqr.host_reads`)."""
    from mpc_ros_tpu_torch.solver import ilqr

    res, _ = host_s(fn)
    times = []
    reads = ilqr.host_reads
    for _ in range(reps):
        res, sec = host_s(fn)
        times.append(sec)
    ms = statistics.median(times) * 1e3
    return res, dict(batch=B, ms_per_call=ms, ms_runs=times,
                     solves_per_s=B / (ms / 1e3),
                     mean_iters=float(res.n_iters.float().mean()),
                     max_iters=int(res.n_iters.max()),
                     converged_frac=float(res.converged.float().mean()),
                     host_reads_per_call=(ilqr.host_reads - reads) / reps)


def engine_batch(dev) -> dict:
    """Phase 21: `engine.batch_solve` (the batch-first `ilqr.solve`) at
    N=30, B=16,384, f32, the production knobs, on the card: diff drive and
    bicycle held against the XLA lane path (`backward="xla"`) and the
    whole-solve kernel (`backward="mega"`) on the same inputs at the
    parity gates; the `model_from_step` tricycle with the gated DDP
    against Gauss-Newton (converged >= 0.98, relative cost < 1e-4, as
    tests/test_ddp.py)."""
    from mpc_ros_tpu_torch.engine import batch_solve

    out = {}
    z0s, coeffs = scenarios(21, B_ENGINE, dev)
    p = params(B_ENGINE, dev, False)
    for name, cfg in (("diff_drive", PROD), ("bicycle", BICYCLE)):
        res, rec = engine_record(lambda: batch_solve(z0s, coeffs, p, cfg),
                                 B_ENGINE)
        check_result(res, B_ENGINE)
        for other in ("xla", "mega"):
            reset_launches()
            r_o, sec = host_s(lambda: batch_solve_lane(
                z0s, coeffs, p, dataclasses.replace(cfg, backward=other)))
            g = result_gates(res, r_o, N_STEPS)
            rec[f"vs_{other}"] = g
            rec[f"{other}_ms"] = sec * 1e3
            if other == "mega" and solve_mega.launches != 1:
                raise SystemExit(f"engine {name}: the kernel comparison "
                                 f"launched {solve_mega.launches} times")
            if not g["ok"]:
                raise SystemExit(f"engine.batch_solve ({name}) disagrees "
                                 f"with the {other} path: {g}")
        if rec["converged_frac"] < 0.99:
            raise SystemExit(f"engine.batch_solve ({name}): converged "
                             f"{rec['converged_frac']} < 0.99")
        out[name] = rec
    register_tricycle()
    kw = dict(n_steps=N_STEPS, max_sqp_iters=40, ls_iters=5, tol_grad=1e-4,
              model=TRICYCLE)
    gn, gn_rec = engine_record(lambda: batch_solve(
        z0s, coeffs, p, SolverConfig(**kw, ddp=False)), B_ENGINE, reps=1)
    dd, dd_rec = engine_record(lambda: batch_solve(
        z0s, coeffs, p, SolverConfig(**kw, ddp=True)), B_ENGINE, reps=1)
    rel = float(((dd.cost - gn.cost).abs() / (1.0 + gn.cost.abs())).max())
    out["tricycle"] = {"gn": gn_rec, "ddp": dd_rec, "max_rel_dcost": rel}
    emit("engine_batch", **out)
    if dd_rec["converged_frac"] < 0.98 or rel >= 1e-4:
        raise SystemExit(f"the tricycle's DDP solve misses its gates: "
                         f"{out['tricycle']}")
    return out


def profiles_off_kernel(dev) -> dict:
    """Phase 22: per-lane profiles and blobs through `batch_solve_lane` at
    B=1,000 (not whole tiles, so the dispatch takes the registry-generic
    fallback), N=30, cap 30, its first 896 lanes held against the
    whole-solve kernel on the same lanes at the single-pass gates; then a
    tuning
    sweep of the tricycle (a family the lane solver does not take), 8
    candidates x 2,000 scenarios, on `batch_solve_swept`."""
    from mpc_ros_tpu_torch.solver import ilqr

    B = B_FALLBACK
    # the obstacle ensemble's long tail takes cap 30 (OBST), single pass
    cfg = dataclasses.replace(PROD, max_sqp_iters=OBST.max_sqp_iters)
    z0s, coeffs = scenarios(22, B, dev)
    p = params(B, dev, False)
    refs = ramp_refs(22, B, N_STEPS, dev)
    blobs = blob_field(22, B, 1, dev)
    reads = ilqr.host_reads
    reset_launches()
    res, sec = host_s(lambda: batch_solve_lane(z0s, coeffs, p, cfg,
                                               refs=refs, blobs=blobs))
    if solve_mega.launches:
        raise SystemExit("the profile fallback launched the kernel")
    check_result(res, B)
    m = B - B % 128
    sub = GaussianObstacles(*(getattr(blobs, f)[:m]
                              for f in ("cx", "cy", "gamma", "w")))
    k1 = batch_solve_lane(z0s[:m], coeffs[:m], params(m, dev, False),
                          dataclasses.replace(cfg, backward="mega"),
                          refs=refs[:m], blobs=sub)
    if solve_mega.launches != 1:
        raise SystemExit("the kernel comparison did not launch the kernel")
    head = type(res)(**{f.name: getattr(res, f.name)[:m]
                        for f in dataclasses.fields(res)})
    g = result_gates(head, k1, N_STEPS)
    out = {"fallback": dict(batch=B, ms=sec * 1e3, solves_per_s=B / sec,
                            converged_frac=float(res.converged.float()
                                                 .mean()),
                            mean_iters=float(res.n_iters.float().mean()),
                            host_reads=ilqr.host_reads - reads,
                            compared_lanes=m, vs_kernel=g)}
    if not g["ok"]:
        raise SystemExit(f"the profile fallback disagrees with the kernel: "
                         f"{out['fallback']}")
    register_tricycle()
    n_cand, n_scen = SWEEP_CUSTOM
    cands = sample_weight_candidates(torch.Generator(device=dev)
                                     .manual_seed(23), n_cand, MPCParams())
    cfg = SolverConfig(n_steps=N_STEPS, max_sqp_iters=12, tol_grad=1e-4,
                       model=TRICYCLE)
    sw, sec = host_s(lambda: tuning_sweep(
        torch.Generator(device=dev).manual_seed(24), cands, n_scen, cfg))
    out["sweep"] = dict(candidates=n_cand, scenarios=n_scen, s=sec,
                        solves_per_s=n_cand * n_scen / sec,
                        best_index=sw.best_index,
                        converged_frac=sw.converged_frac.tolist(),
                        mean_iters=sw.mean_iters.tolist())
    emit("profiles_off_kernel", **out)
    if not bool(torch.isfinite(sw.mean_cost).all()):
        raise SystemExit(f"the custom-family sweep: {out['sweep']}")
    return out


def ilqr_stage_ms(z0, c, cfg) -> dict:
    """The host-clock ms of each stage of one `ilqr` iteration on one
    scenario's cold start (each to a sync): the linearization and cost
    expansion, the terminal expansion, the autodiff DDP Hessians, the
    backward pass and the multi-alpha forward pass; where a per-cycle
    solve spends its time."""
    from mpc_ros_tpu_torch.models.base import get_model
    from mpc_ros_tpu_torch.solver import ilqr

    p = MPCParams()
    mdl = get_model(cfg.model)
    z, cc = z0[None], c[None]
    T = cfg.n_controls
    dt = torch.as_tensor(p.dt, dtype=z.dtype, device=z.device)
    us = torch.zeros((1, T, 2), dtype=z.dtype, device=z.device)
    one = torch.ones((1, 2), dtype=z.dtype, device=z.device)
    ss = ilqr._rollout_aug(z, us, cc, dt, 1.0, mdl, p)
    out = {}
    lin, out["linearize"] = host_s(lambda: ilqr._linearize_and_expand(
        ss, us, cc, p, dt, 1.0, mdl))
    term, out["terminal"] = host_s(lambda: ilqr._terminal_expansion(
        ss[:, -1], p))
    H, out["hessians"] = host_s(lambda: ilqr.step_hessians(
        ss, us, cc, dt, 1.0, mdl, p))
    mu = torch.full((1,), 1e-6, dtype=z.dtype, device=z.device)
    gate = torch.ones((1,), dtype=z.dtype, device=z.device)
    bw, out["backward"] = host_s(lambda: ilqr.backward_pass(
        *lin, *term, us, -one, one, mu, H=H, ddp_gate_val=gate))
    alphas = 0.5 ** torch.arange(cfg.ls_for(z.dtype), dtype=z.dtype,
                                 device=z.device)
    _, out["forward"] = host_s(lambda: ilqr.forward_pass_multi_alpha(
        ss, us, bw[0], bw[1], alphas, z, cc, p, dt, -one, one, 1.0, mdl))
    return {k: v * 1e3 for k, v in out.items()}


def single_scenario(dev) -> dict:
    """Phase 23: one scenario through `ilqr.solve` (z0 (6,)) at N=30 and
    N=100, cold and warm-started (the next cycle: the predicted state one
    step on, the solution shifted by one), the per-cycle solve of the
    single-robot planner: the median wall time of SINGLE_REPS solves and
    the iterations, each held against the same solve in float64 on the
    CPU (relative cost <= 1e-3, the bar of tests/test_solver.py::
    test_f32_close_to_f64); and the ms of each stage of one iteration
    (`ilqr_stage_ms`)."""
    from mpc_ros_tpu_torch.solver import ilqr

    z0s, coeffs = scenarios(23, 1, dev)
    z0, c = z0s[0], coeffs[0]
    out = {}
    for n, reps in SINGLE_REPS.items():
        cfg = dataclasses.replace(PROD, n_steps=n,
                                  max_sqp_iters=12 if n == 30 else 45)
        cold, cold_rec = engine_record(
            lambda: ilqr.solve(z0, c, MPCParams(), cfg), 1, reps)
        z1 = cold.zs[1]
        warm_u = torch.cat([cold.us[1:], cold.us[-1:]])
        warm, warm_rec = engine_record(
            lambda: ilqr.solve(z1, c, MPCParams(), cfg, u_init=warm_u), 1,
            reps)
        for rec, res, z, u in ((cold_rec, cold, z0, None),
                               (warm_rec, warm, z1, warm_u)):
            ref = ilqr.solve(z.double().cpu(), c.double().cpu(),
                             MPCParams(), cfg,
                             u_init=None if u is None else u.double().cpu())
            rel = abs(float(res.cost) - float(ref.cost)) / (
                1.0 + abs(float(ref.cost)))
            rec.update(iters=int(res.n_iters), converged=bool(res.converged),
                       f64_iters=int(ref.n_iters), rel_dcost_f64=rel)
            if rel > 1e-3 or not bool(torch.isfinite(res.us).all()):
                raise SystemExit(f"single scenario N={n} against float64: "
                                 f"{rec}")
        out[f"N={n}"] = {"cold": cold_rec, "warm": warm_rec,
                         "stage_ms": ilqr_stage_ms(z0, c, cfg)}
    emit("single_scenario", **out)
    return out


# The single-robot closed loop (phases 24-26): no kernel on this path (the
# JAX loop solves through `ilqr.solve` under jit, never a `pallas_call`);
# its counterpart of jit is the captured solve (solver/graphed.py: CUDA
# graphs replayed each cycle). The planner's configuration is
# tests/test_closed_loop.py's, at its full horizon; the bars are the JAX
# package's envelopes, and the cycle's p50 must fit the reference's 20 Hz
# period (tests/test_realtime_20hz.py:30).
LOOP_PARAMS = dict(dt=0.1, ref_vel=0.5, max_angvel=1.5, w_cte=300.0,
                   w_angvel_d=10.0, w_accel_d=10.0)
LOOP_STEPS = 20
LOOP_PLANNER = PlannerConfig(local_plan_length=2.5)
LOOP_MEAN_GEO, LOOP_MAX_GEO = 0.08, 0.25
# phase 25: the first cycles on the card against the port on the CPU
PARITY_CYCLES = 20
PARITY_TOL = 1e-6
# phase 26: the trajectory tracker's first cycles, the bar of
# tests/test_trajectory_tracking.py:29
TRAJ_SPEED = 0.4
TRAJ_CYCLES = 150
TRAJ_MAX_DIST = 0.55
# phase 24: the cycle's p50 bar [ms], the cycles held against the eager
# cycle bit for bit (a reload and two costmaps of one shape among them),
# the cycles traced, and the cycles replayed under the sync debug mode
LOOP_P50_MS = 50.0
LOOP_EAGER_CYCLES = 20
LOOP_PROFILED = 20
LOOP_SYNC_ERROR_CYCLES = 5


def loop_planner(dev, dtype=torch.float32):
    from mpc_ros_tpu_torch.planner import MPCPlanner

    return MPCPlanner(MPCParams(**LOOP_PARAMS),
                      SolverConfig(n_steps=LOOP_STEPS), LOOP_PLANNER,
                      dtype=dtype, device=dev)


def cycle_ms(times_s) -> dict:
    ms = np.asarray(times_s) * 1e3
    return dict(p50=float(np.percentile(ms, 50)),
                p99=float(np.percentile(ms, 99)), max=float(ms.max()),
                first=float(ms[0]))


def captured_against_eager(dev) -> dict:
    """Phase 24's planner through the captured cycle and through the eager
    cycle (`_graphed = False`) in lockstep over the course's first
    LOOP_EAGER_CYCLES cycles, a parameter reload at cycle 8, a costmap at
    12 and one of the same shape at 16: equal bit for bit (commands, FSM
    states, host reads, the solves' us, zs, cost and iterations); the
    reload and the second costmap capture nothing."""
    from mpc_ros_tpu_torch.models.obstacles import gaussian_blob_map
    from mpc_ros_tpu_torch.sim import get_shape
    from mpc_ros_tpu_torch.solver import graphed
    from mpc_ros_tpu_torch.testing import lockstep_cycles, records_equal

    plan = get_shape("infinity")
    c = plan[25, :2]
    maps = [gaussian_blob_map((float(c[0]), float(c[1]) + d), sigma=0.3,
                              extent=8.0, weight=50.0) for d in (0.6, 0.5)]
    ours, eager = loop_planner(dev), loop_planner(dev)
    for pl in (ours, eager):
        pl.initialize()
    eager.tracker._graphed = False
    counts = {}

    def note(k):
        def f(pl):
            if pl is ours:
                counts[k] = graphed.captures
        return f

    reload = MPCParams(**dict(LOOP_PARAMS, w_cte=250.0, ref_vel=0.45))
    a, b = lockstep_cycles([ours, eager], LOOP_EAGER_CYCLES, plan=plan,
                           events={7: note(7),
                                   8: lambda pl: pl.reconfigure(reload),
                                   11: note(11),
                                   12: lambda pl: pl.set_costmap(maps[0]),
                                   15: note(15),
                                   16: lambda pl: pl.set_costmap(maps[1])})
    rec = records_equal(a, b)
    rec.update(captures_reload=counts[11] - counts[7],
               captures_costmap=counts[15] - counts[11],
               captures_same_shape_costmap=graphed.captures - counts[15],
               iters=[r["solve"]["iters"] for r in a if r["solve"]])
    if not (rec["equal"] and rec["captures_reload"] == 0
            and rec["captures_costmap"] == 1
            and rec["captures_same_shape_costmap"] == 0):
        raise SystemExit(f"closed loop, captured against eager: {rec}")
    return rec


def loop_cycle_counts(dev) -> dict:
    """Phase 24's cycle traced on the card (`profile_cycles`, after 5
    cycles: the capture and warm ones): kernel and graph launches, copies
    and syncs per cycle; then LOOP_SYNC_ERROR_CYCLES cycles under
    `torch.cuda.set_sync_debug_mode("error")`, which raises on a
    synchronizing call (a pageable copy, a `.item()`): the replays make
    none (the flag and the fetch go through pinned memory and events)."""
    from mpc_ros_tpu_torch.sim import get_shape, make_plant
    from mpc_ros_tpu_torch.solver import ilqr

    plan = get_shape("infinity")
    pl = loop_planner(dev)
    pl.initialize()
    plant = make_plant("diff_drive", plan[0].copy(), 0.1, pl.params)
    pl.set_plan(plan, plant.pose)
    iters = []

    def one():
        ok, cmd, info = pl.compute_velocity_commands(plant.pose,
                                                     plant.feedback_vel)
        iters.append(info.tracking.solve.n_iters)
        plant.step(*cmd)

    for _ in range(5):
        one()
    iters.clear()
    reads = ilqr.host_reads
    out = profile_cycles(one, LOOP_PROFILED)
    out.update(sqp_iters_per_cycle=float(np.mean(iters)),
               host_reads_per_cycle=(ilqr.host_reads - reads) / len(iters))
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(LOOP_SYNC_ERROR_CYCLES):
            one()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    out["sync_debug_error_cycles"] = LOOP_SYNC_ERROR_CYCLES
    return out


def closed_loop(dev) -> dict:
    """Phase 24: `MPCPlanner` + `run_closed_loop` over the whole infinity
    course on the card in float32: the goal reached, the geometric error
    within the JAX envelope, every record finite, the planner's warm carry
    and parameters on the card, the cycle's p50 under LOOP_P50_MS (p99
    printed); cycles, course time, ms per cycle (the planner's own clock
    around `compute_velocity_commands`, which ends in the cycle's one
    fetch), SQP iterations and host reads per cycle (the solver's
    per-iteration read of "all done", besides the cycle's one packed
    upload and one packed fetch), the captures (one: the course's first
    cycle), the ms of each stage of one eager iteration at N=20
    (`ilqr_stage_ms`), and no kernel launched. Then the captured cycle
    against the eager one (`captured_against_eager`) and the cycle's
    launches, copies and syncs (`loop_cycle_counts`)."""
    from mpc_ros_tpu_torch.obs import RunStats
    from mpc_ros_tpu_torch.sim import get_shape, run_closed_loop
    from mpc_ros_tpu_torch.solver import graphed, ilqr

    plan = get_shape("infinity")
    planner = loop_planner(dev)
    stats = RunStats()
    planner.on_cycle = stats.record_cycle
    reset_launches()
    reads = ilqr.host_reads
    captures = graphed.captures
    res = run_closed_loop(planner, plan, max_cycles=1200)
    reads = ilqr.host_reads - reads
    captures = graphed.captures - captures
    d = np.array([np.min(np.hypot(plan[:, 0] - q[0], plan[:, 1] - q[1]))
                  for q in res.poses])
    tr = planner.tracker
    out = dict(
        reached=res.reached, cycles=res.n_cycles,
        course_time_s=res.course_time_s, wall_s=res.wall_time_s,
        geo_err_mean_m=float(d.mean()), geo_err_max_m=float(d.max()),
        bars=dict(mean=LOOP_MEAN_GEO, max=LOOP_MAX_GEO),
        cycle_ms=cycle_ms(stats.cycle_times_s),
        solves=stats.n_solves, converged_frac=stats.summary()[
            "converged_frac"],
        mean_iters=float(np.mean(stats.solve_iters)),
        max_iters=int(np.max(stats.solve_iters)),
        host_reads_per_solve=reads / max(stats.n_solves, 1),
        uploads_per_solve=1, fetches_per_solve=1, captures=captures,
        p50_bar_ms=LOOP_P50_MS,
        carry_device=str(tr._warm_dev.device),
        params_device=str(tr.params.w_cte.device),
        kernel_launches=solve_mega.launches + backward_fused.launches
        + forward.launches,
        stage_ms=ilqr_stage_ms(*(a[0] for a in scenarios(23, 1, dev)),
                               SolverConfig(n_steps=LOOP_STEPS)),
        states={s: sum(x.value == s for x in res.states)
                for s in sorted({x.value for x in res.states})})
    out["captured_vs_eager"] = captured_against_eager(dev)
    out["per_cycle"] = loop_cycle_counts(dev)
    emit("closed_loop", **out)
    if not (res.reached and d.mean() < LOOP_MEAN_GEO
            and d.max() < LOOP_MAX_GEO
            and bool(np.all(np.isfinite(res.records)))
            and tr._warm_dev.is_cuda and tr.params.w_cte.is_cuda
            and out["cycle_ms"]["p50"] < LOOP_P50_MS and captures == 1):
        raise SystemExit(f"closed loop on the card: {out}")
    return out


def closed_loop_cpu_parity(dev) -> dict:
    """Phase 25: the course's first PARITY_CYCLES cycles in float64, the
    planner on the card against the port's planner on the CPU: the
    commands within PARITY_TOL and the same FSM state every cycle (not a
    kernel check: it catches host logic that depends on the device)."""
    from mpc_ros_tpu_torch.sim import get_shape, run_closed_loop

    plan = get_shape("infinity")
    runs = [run_closed_loop(loop_planner(d, torch.float64), plan,
                            max_cycles=PARITY_CYCLES)
            for d in (dev, torch.device("cpu"))]
    gpu, cpu = runs
    du = float(np.max(np.abs(gpu.records[:, 3:] - cpu.records[:, 3:])))
    same = [a.value for a in gpu.states] == [b.value for b in cpu.states]
    out = dict(cycles=gpu.n_cycles, max_abs_dcmd=du, tol=PARITY_TOL,
               same_states=same,
               max_abs_dpose=float(np.max(np.abs(gpu.poses - cpu.poses))))
    emit("closed_loop_cpu_parity", **out)
    if not (same and du <= PARITY_TOL and gpu.n_cycles == PARITY_CYCLES
            and cpu.n_cycles == PARITY_CYCLES):
        raise SystemExit(f"closed loop, card against CPU: {out}")
    return out


def trajectory_tracking(dev) -> dict:
    """Phase 26: `TrajectoryTracker` on the infinity course at TRAJ_SPEED,
    the first TRAJ_CYCLES cycles on the card in float32: every record
    finite, dist_to_ref below TRAJ_MAX_DIST; ms per cycle."""
    from mpc_ros_tpu_torch.planner import TimedTrajectory, TrajectoryTracker
    from mpc_ros_tpu_torch.sim import get_shape
    from mpc_ros_tpu_torch.sim.simulator import run_trajectory_tracking

    tracker = TrajectoryTracker(
        MPCParams(**{k: v for k, v in LOOP_PARAMS.items()
                     if k != "ref_vel"}),
        SolverConfig(n_steps=LOOP_STEPS), LOOP_PLANNER, device=dev)
    times = []
    compute = tracker.compute

    def timed(*a):
        t0 = time.perf_counter()
        out = compute(*a)
        times.append(time.perf_counter() - t0)
        return out

    tracker.compute = timed
    traj = TimedTrajectory.from_path(get_shape("infinity"), TRAJ_SPEED)
    res = run_trajectory_tracking(tracker, traj, max_cycles=TRAJ_CYCLES)
    d = res.dist_to_ref
    out = dict(cycles=res.n_cycles, wall_s=res.wall_time_s,
               dist_to_ref_mean_m=float(d.mean()),
               dist_to_ref_max_m=float(d.max()), bar=TRAJ_MAX_DIST,
               cycle_ms=cycle_ms(times),
               carry_device=str(tracker._warm_dev.device))
    emit("trajectory_tracking", **out)
    if not (res.n_cycles == TRAJ_CYCLES and d.max() < TRAJ_MAX_DIST
            and bool(np.all(np.isfinite(res.records)))
            and tracker._warm_dev.is_cuda):
        raise SystemExit(f"trajectory tracking on the card: {out}")
    return out


# Fleet serving (phases 27-29), at `bench.py --fleet`'s and
# `--fleet-trajectory`'s shapes: B robots on the infinity course moved by
# 10 m x (i mod 64), N=20 at the default cap 60 (one pass), the fleet
# weights of tests/test_fleet.py, a 2.5 m lookahead window. In float32 at
# B % 128 == 0 each cycle's batched solve is one K1 launch for the whole
# fleet: plain (phase 27), stage (g) for the bicycle, stage (e) with world
# blobs, stage (f) in the trajectory tracker (phase 29).
FLEET_B = 1024
# the device planner also at the JAX package's serving width (a TPU
# figure, not a target)
FLEET_BIG = 8192
FLEET_CYCLES = 30
FLEET_SHORT = 5
FLEET_DEVICE_CYCLES = 20
FLEET_PROFILED = 5
FLEET_LEAVES = dict(max_angvel=1.5, w_cte=300.0, w_angvel_d=10.0,
                    w_accel_d=10.0)
FLEET = SolverConfig(n_steps=LOOP_STEPS)
FLEET_BICYCLE = dataclasses.replace(FLEET, model="bicycle")
FLEET_LF = 0.25
# the cycle whose solve is held against the plain version (warm)
FLEET_CAPTURE = 3
# the first cycles of a run (cold: first allocations, library handles)
# are reported apart and left out of the timed window
FLEET_COLD = 2
# the JAX package's bars between the device and the host pipelines
# (tests/test_fleet_device.py:64-77, :280-296,
# tests/test_trajectory_tracking.py:234-236)
BAR_CMD, BAR_ERR, BAR_REFV = 2e-3, 1e-3, 1e-5
BAR_I16_SAME, BAR_I16_ALL, BAR_I16_KNOTS = 3e-3, 3e-2, 3
BAR_LAG = 1e-3


def fleet_params(model: str = "diff_drive") -> MPCParams:
    leaves = dict(FLEET_LEAVES)
    if model == "bicycle":
        leaves.update(lf=FLEET_LF, max_steer=0.6)
    return MPCParams(**leaves)


def fleet_plans(B: int) -> list:
    from mpc_ros_tpu_torch.testing import fleet_courses

    return fleet_courses(B, offset=10.0, period=64)


class SolveTap:
    """Records the arguments of the `batch_solve_lane` call a planner
    module makes on the cycle asked for (`want`), by wrapping the module's
    attribute for the `with` block; the package is left as it is."""

    def __init__(self, module):
        self.module = module
        self.orig = module.batch_solve_lane
        self.want = False
        self.calls = []

    def __enter__(self):
        self.module.batch_solve_lane = self
        return self

    def __exit__(self, *exc):
        self.module.batch_solve_lane = self.orig

    def __call__(self, *a, **kw):
        if self.want:
            self.calls.append((a, kw))
            self.want = False
        return self.orig(*a, **kw)


def kernel_own_ms(call, kernel: str = "solve_mega_kernel",
                  reps: int = WINDOW) -> dict:
    """The kernel's own device time per launch of `call` (one launch per
    call), after one untimed call: the CUDA time of `kernel` in a
    `torch.profiler` trace of `reps` calls, and CUDA events around each
    call with the stream held busy ahead of the window
    (`torch.cuda._sleep`), so that the host's work in the wrapper is
    enqueued while the card sleeps and falls outside each pair. Medians
    in ms; `kernel_ms` is the profiler's, or the events' where the trace
    holds no launch of `kernel`."""
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            call()
        torch.cuda.synchronize()
    traced = [e.time_range.elapsed_us() / 1e3 for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and kernel in e.name]
    evs = [(torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda._sleep(50_000_000)
    for a, b in evs:
        a.record()
        call()
        b.record()
    torch.cuda.synchronize()
    events = [a.elapsed_time(b) for a, b in evs]
    out = dict(profiler_ms=statistics.median(traced) if traced else None,
               profiler_launches=len(traced),
               events_ms=statistics.median(events), events_max_ms=max(events))
    out["kernel_ms"] = (out["profiler_ms"] if len(traced) == reps
                        else out["events_ms"])
    out["kernel_ms_from"] = ("profiler" if len(traced) == reps
                             else "events")
    return out


def fleet_k1_check(call, what: str) -> dict:
    """One fleet cycle's solve (the arguments a `SolveTap` recorded) run
    again through the kernel's wrapper and held against the plain version
    on the same inputs at the single-pass gates (raises on a broken
    gate). `kernel_ms` is the kernel's own device time
    (`kernel_own_ms`); `wrapper_window` times the whole wrapper call
    (`timed_launch`: the host's allocation and launch included)."""
    (z0s, coeffs, p, cfg), kw = call
    ins = lane_inputs(z0s, coeffs, p, cfg, kw.get("u_init"))
    blobs = kw.get("blobs")
    bl = None if blobs is None else tuple(blobs.lane())
    rf = None if kw.get("refs") is None else lane_major(kw["refs"])
    _, win, bound, wmax = timed_launch(ins, cfg, blobs=bl, refs=rf)
    own = kernel_own_ms(lambda: solve_mega.solve_mega_cuda(
        *ins, cfg, blobs=bl, refs=rf))
    g, t_k, t_p, _, _ = held_against_plain(ins, cfg, what, blobs=bl,
                                           refs=rf)
    return dict(kernel_ms=own["kernel_ms"], own=own, plain_ms=t_p * 1e3,
                bound_ms=bound[0], bound_by=bound[1],
                mean_warp_max_iters=wmax, wrapper_window=win, vs_plain=g)


def fleet_rate(times_s, B: int) -> dict:
    """A fleet run's host-clock times: the first FLEET_COLD cycles apart
    (`cold_ms`); over the rest, ms per cycle (p50, p99, max) and
    robot-cycles/s as B x cycles over the window's whole time."""
    warm = np.asarray(times_s[FLEET_COLD:])
    ms = warm * 1e3
    return dict(cold_ms=[float(t) * 1e3 for t in times_s[:FLEET_COLD]],
                cycle_ms=dict(p50=float(np.percentile(ms, 50)),
                              p99=float(np.percentile(ms, 99)),
                              max=float(ms.max()), cycles=int(ms.size)),
                robot_cycles_per_s=B * warm.size / float(warm.sum()))


def profile_cycles(fn, n: int) -> dict:
    """`n` calls of `fn` traced by `torch.profiler` (CPU and CUDA): per
    call the kernel launches, CUDA-graph launches, host-to-device and
    device-to-host copies (as the device ran them, inside a graph or
    not), stream and device synchronizations and event synchronizations
    (less those of an empty trace: the profiler's own), and the device
    time (the CUDA kernels' and copies' own time; None when the trace
    holds none)."""
    from torch.profiler import ProfilerActivity, profile

    def trace(k):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(k):
                fn()
            wall = time.perf_counter() - t0
        ev = prof.key_averages()

        def count(pred):
            return sum(e.count for e in ev if pred(e.key))

        return wall, ev, dict(
            kernel_launches=count(lambda k: k in (
                "cudaLaunchKernel", "cuLaunchKernel",
                "cudaLaunchKernelExC")),
            h2d_copies=count(lambda k: "HtoD" in k),
            d2h_copies=count(lambda k: "DtoH" in k),
            syncs=count(lambda k: k in ("cudaStreamSynchronize",
                                        "cudaDeviceSynchronize")),
            graph_launches=count(lambda k: k == "cudaGraphLaunch"),
            event_syncs=count(lambda k: k == "cudaEventSynchronize"))

    own = trace(0)[2]
    wall, ev, got = trace(n)
    dev_us = sum(e.self_device_time_total for e in ev
                 if e.device_type == torch.autograd.DeviceType.CUDA)
    out = {k: (v - own[k]) / n for k, v in got.items()}
    out.update(calls=n, profiler_own=own, wall_ms_per_call=wall / n * 1e3,
               device_ms_per_call=dev_us / n / 1e3 if dev_us else None,
               device_busy_share=dev_us / 1e6 / wall if dev_us else None)
    return out


def fleet_drive(fp, plans, cycles: int, tap=None, lf=None,
                trace: bool = False) -> dict:
    """A fleet planner on its own pose stream (the poses advanced by its
    commands): the host-clock ms of each `compute_velocity_commands` (it
    ends in the cycle's fetch), K1 launches, the tracking robots'
    convergence and iterations, every command finite; with `tap` the
    solve of cycle FLEET_CAPTURE recorded; with `trace` each cycle's
    (poses, feedback, commands, info, cursors) kept for a replay."""
    from mpc_ros_tpu_torch.testing import step_poses

    B = len(plans)
    poses = np.stack([pl[0] for pl in plans]).astype(float)
    fb = np.zeros((B, 2))
    if not fp.set_plans(plans, poses).all():
        raise SystemExit("fleet: a plan was refused")
    times, conv, iters, record = [], [], [], []
    reset_launches()
    for c in range(cycles):
        if tap is not None:
            tap.want = c == FLEET_CAPTURE
        seen, fb_seen = poses.copy(), fb.copy()
        t0 = time.perf_counter()
        _, cmds, info = fp.compute_velocity_commands(seen, fb_seen)
        times.append(time.perf_counter() - t0)
        if not np.isfinite(cmds).all():
            raise SystemExit(f"fleet: non-finite commands at cycle {c}")
        track = np.isfinite(info.cost)
        conv.append(info.converged[track])
        iters.append(info.n_iters[track])
        if trace:
            record.append((seen, fb_seen, cmds, info, fp._start.copy()))
        fb = step_poses(poses, cmds, 0.1, lf)
    launches = solve_mega.launches
    conv, iters = np.concatenate(conv), np.concatenate(iters)
    return dict(batch=B, cycles=cycles, **fleet_rate(times, B),
                k1_launches=launches, k1_launches_per_cycle=launches / cycles,
                tracking_robot_cycles=int(conv.size),
                converged_frac=float(conv.mean()),
                mean_iters=float(iters.mean()), max_iters=int(iters.max()),
                trace=record)


def fleet_host(dev) -> dict:
    """Phase 27: `FleetPlanner` on the card, FLEET_B robots, FLEET_CYCLES
    cycles: ms per cycle, robot-cycles/s, K1 launches per cycle (one: the
    whole fleet's solve), the tracking robots' convergence; a traced
    stretch of FLEET_PROFILED cycles (launches, copies and syncs per
    cycle; `begin_cycle` alone neither copies to the host nor syncs); one
    warm cycle's solve held against the plain version. Then
    FLEET_SHORT cycles each of the bicycle fleet (stage (g)) and of a
    fleet with one world blob per robot (stage (e)), the same check on
    each."""
    from mpc_ros_tpu_torch.planner import FleetPlanner, fleet

    def planner(model="diff_drive"):
        fp = FleetPlanner(fleet_params(model),
                          FLEET_BICYCLE if model == "bicycle" else FLEET,
                          LOOP_PLANNER, device=dev)
        fp.initialize(FLEET_B)
        return fp

    plans = fleet_plans(FLEET_B)
    out = {}
    with SolveTap(fleet) as tap:
        fp = planner()
        run = fleet_drive(fp, plans, FLEET_CYCLES, tap)
        run.pop("trace")
        if run["k1_launches"] != FLEET_CYCLES:
            raise SystemExit(f"fleet_host: {run['k1_launches']} K1 launches "
                             f"in {FLEET_CYCLES} cycles")
        last = np.stack([pl[0] for pl in plans]).astype(float)
        fb = np.zeros((FLEET_B, 2))
        run["profile"] = profile_cycles(
            lambda: fp.compute_velocity_commands(last, fb), FLEET_PROFILED)
        # begin_cycle alone (the pipelined loop's first half) reads
        # nothing back from the card
        pending = []
        run["begin_cycle_profile"] = profile_cycles(
            lambda: pending.append(fp.begin_cycle(last, fb)), FLEET_PROFILED)
        for h in pending:
            fp.finish_cycle(h)
        if (run["begin_cycle_profile"]["d2h_copies"]
                or run["begin_cycle_profile"]["syncs"]):
            raise SystemExit(f"fleet_host: begin_cycle read the device: "
                             f"{run['begin_cycle_profile']}")
        run["k1"] = fleet_k1_check(tap.calls.pop(), "fleet_host")
        out["plain"] = run
        # the bicycle (stage (g)), and one world blob per robot ahead on
        # its course (stage (e))
        for name in ("bicycle", "blobs"):
            fp = planner("bicycle" if name == "bicycle" else "diff_drive")
            if name == "blobs":
                ahead = np.stack([pl[40] for pl in plans])
                fp.set_obstacles(GaussianObstacles.from_sigmas(
                    *(torch.tensor(a, dtype=torch.float32, device=dev)
                      for a in (ahead[:, :1] + 0.2, ahead[:, 1:2],
                                np.full((FLEET_B, 1), 0.3),
                                np.full((FLEET_B, 1), 50.0)))))
            r = fleet_drive(fp, plans, FLEET_SHORT, tap,
                            lf=FLEET_LF if name == "bicycle" else None)
            r.pop("trace")
            if r["k1_launches"] != FLEET_SHORT:
                raise SystemExit(f"fleet_host {name}: {r['k1_launches']} "
                                 f"K1 launches in {FLEET_SHORT} cycles")
            r["k1"] = fleet_k1_check(tap.calls.pop(), f"fleet_host {name}")
            out[name] = r
    emit("fleet_host", **out)
    return out


def fleet_replay(dp, trace, profiled: bool) -> dict:
    """A device fleet planner fed a host fleet's recorded pose stream,
    held to the JAX bars against the host's outputs every cycle: the FSM
    states (on observed cycles), the cursors (equal; on the 16-bit wire
    within one knot on at most BAR_I16_KNOTS robots), the commands (the
    16-bit wire: BAR_I16_SAME on equal cursors, BAR_I16_ALL on all), cte,
    etheta and ref_vel of the tracking robots (observed cycles, f32
    wire). Raises on a broken bar. Returns the device planner's ms per
    cycle, robot-cycles/s, K1 launches and the largest deviations."""
    times, worst = [], dict(cmd=0.0, cte=0.0, etheta=0.0, ref_vel=0.0,
                            cursor_knots=0)
    reset_launches()
    for c, (poses, fb, cmds_h, info_h, start_h) in enumerate(trace):
        t0 = time.perf_counter()
        _, cmds, info = dp.compute_velocity_commands(poses, fb)
        times.append(time.perf_counter() - t0)
        dcur = np.abs(dp._carry["start"].cpu().numpy() - start_h)
        dcmd = np.abs(cmds - cmds_h).max(axis=1)
        worst["cursor_knots"] = max(worst["cursor_knots"], int(dcur.max()))
        worst["cmd"] = max(worst["cmd"], float(dcmd.max()))
        if dp.wire == "f32":
            ok = dcur.max() == 0 and dcmd.max() < BAR_CMD
        else:
            ok = (dcur.max() <= 1 and (dcur > 0).sum() <= BAR_I16_KNOTS
                  and dcmd[dcur == 0].max() < BAR_I16_SAME
                  and dcmd.max() < BAR_I16_ALL)
        if info.observed.all():
            ok &= bool(np.array_equal(info.states, info_h.states))
            tr = info_h.states == 0
            if dp.wire == "f32" and tr.any():
                for k, bar in (("cte", BAR_ERR), ("etheta", BAR_ERR),
                               ("ref_vel", BAR_REFV)):
                    d = float(np.nanmax(np.abs(getattr(info, k)
                                               - getattr(info_h, k))[tr]))
                    worst[k] = max(worst[k], d)
                    ok &= d < bar
        if not ok:
            raise SystemExit(f"fleet_device (wire {dp.wire}, obs_every "
                             f"{dp.obs_every}, B={len(fb)}) against the host "
                             f"fleet at cycle {c}: {worst}, cursors {dcur}")
    launches = solve_mega.launches
    if launches != len(trace):
        raise SystemExit(f"fleet_device: {launches} K1 launches in "
                         f"{len(trace)} cycles")
    out = dict(wire=dp.wire, obs_every=dp.obs_every,
               **fleet_rate(times, len(fb)),
               k1_launches_per_cycle=launches / len(trace), worst=worst)
    if profiled:
        poses, fb = trace[-1][:2]
        out["profile"] = profile_cycles(
            lambda: dp.compute_velocity_commands(poses, fb), FLEET_PROFILED)
    return out


def fleet_device(dev) -> dict:
    """Phase 28: `DeviceFleetPlanner` with the f32 and the 16-bit wire,
    obs_every 1 and 0, FLEET_DEVICE_CYCLES cycles at FLEET_B and
    FLEET_BIG robots, on the pose stream of a host `FleetPlanner` on the
    card and held to the JAX bars against it (`fleet_replay`); ms per
    cycle, robot-cycles/s, K1 launches per cycle, and a traced stretch
    (launches, copies, syncs per cycle) of each wire at obs_every 1; one
    device cycle's solve held against the plain version."""
    from mpc_ros_tpu_torch.planner import (DeviceFleetPlanner, FleetPlanner,
                                           fleet_device as fleet_dev_mod)

    out = {}
    for B in (FLEET_B, FLEET_BIG):
        plans = fleet_plans(B)
        host = FleetPlanner(fleet_params(), FLEET, LOOP_PLANNER, device=dev)
        host.initialize(B)
        ref = fleet_drive(host, plans, FLEET_DEVICE_CYCLES, trace=True)
        trace = ref.pop("trace")
        rows = {"host": ref}
        for wire in ("f32", "i16"):
            for obs_every in (1, 0):
                dp = DeviceFleetPlanner(fleet_params(), FLEET, LOOP_PLANNER,
                                        device=dev, wire=wire,
                                        obs_every=obs_every)
                dp.initialize(B)
                poses0 = np.stack([pl[0] for pl in plans]).astype(float)
                if not dp.set_plans(plans, poses0).all():
                    raise SystemExit("fleet_device: a plan was refused")
                rows[f"{wire},obs_every={obs_every}"] = fleet_replay(
                    dp, trace, profiled=obs_every == 1)
        out[f"B={B}"] = rows
    # one warm device cycle's solve against the plain version
    with SolveTap(fleet_dev_mod) as tap:
        dp = DeviceFleetPlanner(fleet_params(), FLEET, LOOP_PLANNER,
                                device=dev)
        dp.initialize(FLEET_B)
        fleet_drive(dp, fleet_plans(FLEET_B), FLEET_CAPTURE + 1, tap)
        out["k1"] = fleet_k1_check(tap.calls.pop(), "fleet_device")
    emit("fleet_device", **out)
    return out


def fleet_trajectory(dev) -> dict:
    """Phase 29: `FleetTrajectoryTracker`, device and host pipelines,
    FLEET_CYCLES cycles at FLEET_B robots (`bench.py --fleet-trajectory`'s
    trajectories: speed 0.3 + 0.002 (i mod 64)): ms per cycle, K1 (stage
    (f)) launches per cycle, the device pipeline against the host
    pipeline's pose stream within BAR_CMD on the commands and BAR_LAG on
    the lags every cycle, and one device cycle's solve against the plain
    version."""
    from mpc_ros_tpu_torch.planner import (FleetTrajectoryTracker,
                                           TimedTrajectory, trajectory)
    from mpc_ros_tpu_torch.testing import step_poses

    B = FLEET_B
    trajs = [TimedTrajectory.from_path(pl, 0.3 + 0.002 * (i % 64))
             for i, pl in enumerate(fleet_plans(B))]
    params_ = MPCParams(dt=0.1, **FLEET_LEAVES)

    def tracker(pipeline):
        tr = FleetTrajectoryTracker(params_, FLEET, LOOP_PLANNER,
                                    pipeline=pipeline, device=dev)
        tr.set_trajectories(trajs)
        return tr

    host, devp = tracker("host"), tracker("device")
    poses = np.stack([np.r_[t.xy[0], t.yaw[0]] for t in trajs])
    vs = np.zeros(B)
    times = {"host": [], "device": []}
    launches = {"host": 0, "device": 0}
    worst = dict(cmd=0.0, lag=0.0)
    with SolveTap(trajectory) as tap:
        for c in range(FLEET_CYCLES):
            outs = {}
            for name, tr in (("host", host), ("device", devp)):
                tap.want = name == "device" and c == FLEET_CAPTURE
                reset_launches()
                t0 = time.perf_counter()
                outs[name] = tr.compute(c * 0.1, poses.copy(), vs.copy())
                times[name].append(time.perf_counter() - t0)
                launches[name] += solve_mega.launches
            (c_h, l_h), (c_d, l_d) = outs["host"], outs["device"]
            dc = float(np.abs(c_h - c_d).max())
            dl = float(np.abs(l_h - l_d).max())
            worst["cmd"], worst["lag"] = (max(worst["cmd"], dc),
                                          max(worst["lag"], dl))
            if not (dc < BAR_CMD and dl < BAR_LAG
                    and np.isfinite(c_d).all()):
                raise SystemExit(f"fleet_trajectory: device against host at "
                                 f"cycle {c}: {worst}")
            vs = step_poses(poses, c_h, 0.1)[:, 0]
        k1 = fleet_k1_check(tap.calls.pop(), "fleet_trajectory")
    if launches != {"host": FLEET_CYCLES, "device": FLEET_CYCLES}:
        raise SystemExit(f"fleet_trajectory: K1 launches {launches} in "
                         f"{FLEET_CYCLES} cycles")
    t = poses.copy()
    out = {name: dict(**fleet_rate(times[name], B),
                      k1_launches=launches[name],
                      k1_launches_per_cycle=launches[name] / FLEET_CYCLES)
           for name in times}
    out["device"]["profile"] = profile_cycles(
        lambda: devp.compute(FLEET_CYCLES * 0.1, t, vs), FLEET_PROFILED)
    out.update(batch=B, cycles=FLEET_CYCLES, worst=worst,
               bars=dict(cmd=BAR_CMD, lag=BAR_LAG), k1=k1)
    emit("fleet_trajectory", **out)
    return out


# bench.py's compact check: its N=30 knobs at N=48, cap 22
VERIFY_LONG = dataclasses.replace(PROD, n_steps=48, max_sqp_iters=22)


def bench_verify(dev) -> dict:
    """Phase 30: `bench_cuda.kernel_verify` on the card, K1 held against
    the XLA lane path at `bench.py --verify`'s gates: plain, blobs and
    bicycle at N=30, B=1,024, and the compact N=48 schedule (cap 22) at
    B=4,096 with compaction read engaged from the schedule's counters.
    Each check's K1 launches counted from 0 around it."""
    # imported here: tools/compare_k1_builds.py loads this file beside
    # older trees, which lack bench_cuda.py
    from bench_cuda import kernel_verify

    p = MPCParams().astype(torch.float32, dev)
    out = {}
    for name, cfg, B, variant in (
            ("plain", PROD, 1024, "plain"), ("blobs", PROD, 1024, "blobs"),
            ("bicycle", PROD, 1024, "bicycle"),
            ("compact_n48", VERIFY_LONG, 4096, "plain")):
        reset_launches()
        t0 = time.perf_counter()
        kv = kernel_verify(p, cfg, torch.float32, batch=B, variant=variant,
                           expect_compact=name == "compact_n48", device=dev)
        kv["k1_launches"] = solve_mega.launches
        kv["seconds"] = time.perf_counter() - t0
        out[name] = kv
    emit("bench_verify", **out)
    for name, kv in out.items():
        if not kv["ok"] or not kv["k1_launches"]:
            raise SystemExit(f"kernel_verify {name}: K1 deviates from the "
                             f"XLA lane path on this card: {kv}")
    return out


def compare(dev) -> dict:
    """Phase 31: `sim.compare.run_one` for the baseline controllers (Pure
    Pursuit, DWA) over the whole infinity course on the card, at
    tests/test_baselines.py's envelope: the goal reached, mean geometric
    error < 0.1 m, max < 0.5 m, every error column finite; ms per cycle
    on the host clock. The MPC controller's course is phase 24."""
    from mpc_ros_tpu_torch.sim.compare import run_one

    out = {}
    for kind in ("pure_pursuit", "dwa"):
        reset_launches()
        t0 = time.perf_counter()
        row = run_one(kind, "infinity", n_steps=LOOP_STEPS, dt=0.1,
                      ref_vel=0.5, max_cycles=1500, device=dev)
        wall = time.perf_counter() - t0
        row.update(ms_per_cycle=wall / max(row["cycles"], 1) * 1e3,
                   k1_launches=solve_mega.launches)
        out[kind] = row
    emit("compare", **out)
    for kind, row in out.items():
        cols = [row[k] for k in ("mean_abs_cte", "max_abs_cte",
                                 "geo_err_mean_m", "geo_err_max_m")]
        if not (row["reached"] and row["geo_err_mean_m"] < 0.1
                and row["geo_err_max_m"] < 0.5
                and all(np.isfinite(c) for c in cols)):
            raise SystemExit(f"{kind} outside the course envelope: {row}")
    return out


# phase 32: `bench.py --obstacles-grid`'s ensemble (N=30, cap 30, one
# Gaussian costmap per scenario) on the XLA lane path: spline_coeff at
# B=4,096, then bilinear and the 9-tap spline at B=1,024; the first
# GRID_CPU_LANES lanes of each also on the CPU
GRID = dataclasses.replace(PROD, max_sqp_iters=30)
B_GRID = 4096
B_GRID_SMALL = 1024
GRID_CPU_LANES = 256
GRID_REPS = 2
# the converged fraction each sampling is held to: PERF.md's 0.99 on the
# smooth (C1) spline surface; bilinear's minimizers sit on cell-boundary
# kinks where the certificate cannot fire, and the JAX package pins its
# conv at >= 0.93 (tests/test_obstacle_fit.py:151, "conv ~0.94" in
# bench.py's help), its unconverged lanes cost-converged
GRID_CONV = {"spline_coeff": 0.99, "spline": 0.99, "bilinear": 0.93}
# bilinear against the CPU: a lane at a kink whose certificate fires on
# one side only is cost-converged on both (the JAX package's diagnosis,
# tests/test_obstacle_fit.py:115-160: doubling its cap moves its cost by
# < 0.1%), so such lanes are held to that cost bar in place of the
# convergence-match and flip gates, and may be at most 1 - GRID_CONV of
# the lanes
KINK_REL_COST = 1e-3
# phase 33: the costmap routes. The fleet: FLEET_B robots, a 64x64 world
# map per robot (one Gaussian obstacle 0.2 m off its course at plan[40])
# through `set_costmaps` every cycle, FLEET_COLD + COSTMAP_CYCLES cycles;
# the device fit at B_FIT against the host greedy fit at the bar of
# tests/test_obstacle_fit.py:161; the single robot past an obstacle
# (tests/test_obstacle_planner.py's course and planner).
COSTMAP_CYCLES = 10
COSTMAP_BLOBS = 4
B_FIT = 8192
FIT_BAR = (("cx", 1e-5), ("cy", 1e-5), ("gamma", 5e-4), ("w", 1e-4))
# the fitted field's largest error against the grid, above the host fit's
# (grid units: 1% of the costmap's [0, 1] range)
FIELD_TOL = 1e-2
OBSTACLE = (3.0, 0.2)
ROBOT_PARAMS = dict(dt=0.1, ref_vel=0.5, max_angvel=1.5, w_angvel_d=10.0,
                    w_accel_d=10.0)
# tests/test_obstacle_planner.py:60-79: the run without the obstacle
# passes within 0.12 m of it (here the plan's own distance, 0.2 m, stands
# for it); with it, at least 0.1 m further and above 0.2 m
ROBOT_CLEAR = 0.2
ROBOT_GAIN = 0.1


def grid_maps(centres, sampling: str, dev):
    """`bench.py --obstacles-grid`'s maps: per scenario a 64x64 map over
    +-2 m with one Gaussian (sigma 0.3, weight 100) at its centre."""
    from mpc_ros_tpu_torch.models.obstacles import gaussian_blob_map

    return gaussian_blob_map((centres[:, 0], centres[:, 1]), sigma=0.3,
                             weight=100.0, sampling=sampling, device=dev)


def lanes_of(omaps, n: int, dev):
    """The first n maps of a batch, on `dev`."""
    return omaps.replace(**{
        f: getattr(omaps, f)[:n].to(dev)
        for f in ("grid", "origin", "resolution", "weight", "coeff")
        if getattr(omaps, f) is not None})


def grid_main_path(dev) -> dict:
    """Phase 32: grid costmaps through `batch_solve_lane(omaps=...)` on the
    card (the XLA lane path: grid maps take no kernel, as in the JAX
    package) at `bench.py --obstacles-grid`'s shape: spline_coeff at
    B=4,096, bilinear and the 9-tap spline at B=1,024. Per sampling:
    solves/s and ms per solve (median of GRID_REPS synced solves),
    converged fraction (GRID_CONV), iterations, no kernel launch; the first
    GRID_CPU_LANES lanes held against the same lanes solved by the port
    on the CPU in float32 at the single-pass parity gates."""
    from bench_cuda import blob_centres

    p = MPCParams().astype(torch.float32, dev)
    p_cpu = MPCParams().astype(torch.float32)
    out = {}
    for sampling, B in (("spline_coeff", B_GRID), ("bilinear", B_GRID_SMALL),
                        ("spline", B_GRID_SMALL)):
        z0s, coeffs = scenarios(32, B, dev)
        omaps = grid_maps(blob_centres(1, B, torch.float32, dev), sampling,
                          dev)
        res = batch_solve_lane(z0s, coeffs, p, GRID, omaps=omaps)
        torch.cuda.synchronize()
        reset_launches()
        times = []
        for _ in range(GRID_REPS):
            res, t = host_s(lambda: batch_solve_lane(z0s, coeffs, p, GRID,
                                                     omaps=omaps))
            times.append(t)
        launches = (solve_mega.launches + backward_fused.launches
                    + forward.launches)
        check_result(res, B)
        n = GRID_CPU_LANES
        cpu, t_cpu = host_s(lambda: batch_solve_lane(
            z0s[:n].cpu(), coeffs[:n].cpu(), p_cpu, GRID,
            omaps=lanes_of(omaps, n, "cpu")))
        g = grid_vs_cpu(res, cpu, n, sampling)
        t = statistics.median(times)
        conv = float(res.converged.float().mean())
        out[sampling] = dict(
            batch=B, ms_per_solve=t * 1e3, solves_per_s=B / t,
            times_ms=[x * 1e3 for x in times], converged_frac=conv,
            mean_iters=float(res.n_iters.float().mean()),
            max_iters=int(res.n_iters.max()), kernel_launches=launches,
            conv_bar=GRID_CONV[sampling], cpu_lanes=n, cpu_ms=t_cpu * 1e3,
            vs_cpu=g)
        if conv < GRID_CONV[sampling] or launches or not g["ok"]:
            emit("grid_main_path", **out)
            raise SystemExit(f"grid main path ({sampling}): {out[sampling]}")
    emit("grid_main_path", cap=GRID.max_sqp_iters, **out)
    return out


def grid_vs_cpu(res, cpu, n: int, sampling: str) -> dict:
    """The card's first n lanes against the CPU's at the single-pass
    parity gates; for bilinear the lanes converged on one side only (cell
    kinks) held to KINK_REL_COST on their cost instead (see GRID_CONV)."""
    card = [res.us[:n].cpu().numpy(), res.cost[:n].cpu().numpy(),
            res.converged[:n].cpu().numpy(), res.n_iters[:n].cpu().numpy()]
    g = parity_gates(*card, cpu.us.numpy(), cpu.cost.numpy(),
                     cpu.converged.numpy(), cpu.n_iters.numpy(),
                     GRID.n_steps)
    if sampling != "bilinear":
        return g
    one_side = card[2] != cpu.converged.numpy()
    rel = np.abs(card[1] - cpu.cost.numpy()) / (1.0 + np.abs(
        cpu.cost.numpy()))
    lim = g["limits"]
    g["kink_rule"] = dict(
        one_side_lanes=int(one_side.sum()),
        one_side_frac=float(one_side.mean()),
        max_rel_dcost=float(rel[one_side].max()) if one_side.any() else 0.0,
        bar=KINK_REL_COST, frac_bar=1.0 - GRID_CONV["bilinear"])
    g["ok"] = bool(
        g["max_du"] <= lim["max_du"]
        and g["max_rel_dcost"] <= lim["max_rel_dcost"]
        and g["iters_match_frac"] >= lim["iters_match_frac"]
        and abs(g["mean_iters"][0] - g["mean_iters"][1])
        <= lim["mean_iters_diff"] and g["finite"]
        and g["kink_rule"]["max_rel_dcost"] < KINK_REL_COST
        and g["kink_rule"]["one_side_frac"] <= 1.0 - GRID_CONV["bilinear"])
    return g


def world_costmaps(plans, B: int):
    """Per robot a world-frame 64x64 map over +-2 m around plan[40] with
    one Gaussian obstacle (sigma 0.3, weight 50) 0.2 m off the course
    there, as host tensors (a costmap arrives from the host)."""
    from mpc_ros_tpu_torch.models.obstacles import gaussian_blob_map

    at = torch.tensor(np.stack([pl[40, :2] for pl in plans]),
                      dtype=torch.float32)
    m = gaussian_blob_map((torch.full((B,), 0.2), torch.zeros(B)),
                          sigma=0.3, weight=50.0)
    return m.replace(origin=m.origin + at)


def costmap_fleet(dev) -> dict:
    """Phase 33 (fleet): `FleetPlanner` with FLEET_B robots, their world
    costmaps through `set_costmaps` every cycle (one pinned upload, the
    greedy fit on the card), FLEET_COLD + COSTMAP_CYCLES cycles on their
    own pose stream: ms per cycle (p50 / p99, the fit included) and the
    fit's own ms, K1 launches per cycle (exactly 1), the tracking robots'
    convergence; one warm cycle's K1 solve held against the plain version
    at the single-pass gates."""
    from mpc_ros_tpu_torch.planner import FleetPlanner, fleet
    from mpc_ros_tpu_torch.testing import step_poses

    B = FLEET_B
    plans = fleet_plans(B)
    maps = world_costmaps(plans, B)
    with SolveTap(fleet) as tap:
        fp = FleetPlanner(fleet_params(), FLEET, LOOP_PLANNER, device=dev)
        fp.initialize(B)
        poses = np.stack([pl[0] for pl in plans]).astype(float)
        fb = np.zeros((B, 2))
        if not fp.set_plans(plans, poses).all():
            raise SystemExit("costmap fleet: a plan was refused")
        times, fit_ms, conv, iters = [], [], [], []
        cycles = FLEET_COLD + COSTMAP_CYCLES
        reset_launches()
        for c in range(cycles):
            tap.want = c == FLEET_CAPTURE
            t0 = time.perf_counter()
            fp.set_costmaps(maps, COSTMAP_BLOBS)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            _, cmds, info = fp.compute_velocity_commands(poses, fb)
            times.append(time.perf_counter() - t0)
            fit_ms.append((t1 - t0) * 1e3)
            if not np.isfinite(cmds).all():
                raise SystemExit(f"costmap fleet: non-finite commands at "
                                 f"cycle {c}")
            track = np.isfinite(info.cost)
            conv.append(info.converged[track])
            iters.append(info.n_iters[track])
            fb = step_poses(poses, cmds, 0.1)
        launches = solve_mega.launches
        if (fp.world_obstacles.cx.shape != (B, COSTMAP_BLOBS)
                or fp.world_obstacles.cx.device != dev):
            raise SystemExit("costmap fleet: the fitted blobs are not on "
                             "the card")
        k1 = fleet_k1_check(tap.calls.pop(), "costmap fleet")
    conv, iters = np.concatenate(conv), np.concatenate(iters)
    out = dict(batch=B, cycles=cycles, **fleet_rate(times, B),
               set_costmaps_ms=dict(
                   p50=float(np.percentile(fit_ms[FLEET_COLD:], 50)),
                   max=float(max(fit_ms[FLEET_COLD:])),
                   cold=fit_ms[:FLEET_COLD]),
               k1_launches=launches, k1_launches_per_cycle=launches / cycles,
               tracking_robot_cycles=int(conv.size),
               converged_frac=float(conv.mean()),
               mean_iters=float(iters.mean()), k1=k1)
    if launches != cycles:
        emit("costmap_fleet", **out)
        raise SystemExit(f"costmap fleet: {launches} K1 launches in "
                         f"{cycles} cycles")
    return out


def fitted_field(blobs, maps) -> torch.Tensor:
    """The blobs' penalty on each map's cells in grid units (divided by
    the map's weight), float64 on the CPU: (B, H, W)."""
    H, W = maps.grid.shape[-2:]
    o, r = maps.origin.double().cpu(), maps.resolution.double().cpu()
    xs = o[:, 0:1] + torch.arange(W, dtype=torch.float64) * r[:, None]
    ys = o[:, 1:2] + torch.arange(H, dtype=torch.float64) * r[:, None]
    cx, cy, ga, w = (getattr(blobs, f).double().cpu()
                     for f in ("cx", "cy", "gamma", "w"))
    f = torch.zeros((len(xs), H, W), dtype=torch.float64)
    for k in range(cx.shape[1]):
        f += w[:, k, None, None] * torch.exp(-ga[:, k, None, None] * (
            (xs[:, None, :] - cx[:, k, None, None]) ** 2
            + (ys[:, :, None] - cy[:, k, None, None]) ** 2))
    wm = maps.weight.double().cpu()[:, None, None]
    return f / torch.where(wm == 0, torch.ones_like(wm), wm)


def device_fit(dev) -> dict:
    """Phase 33 (fit): `fit_gaussians_to_maps` on B_FIT maps on the card
    (median of WINDOW synced calls) against the host greedy fit
    (`fit_gaussians_to_map`, refine=False) map for map. Maps 0-2 are the
    maps of tests/test_obstacle_fit.py:161, the rest one Gaussian each at
    a random spot and width (every 16th empty). The JAX bar (centres
    1e-5, gamma 5e-4, w 1e-4, relative to 1 + |host|) holds on every blob
    of maps 0-2 and on the obstacle's own blob (the first peel) of every
    map. The later peels model the residual the first leaves (a few % of
    the peak), where a float32 subtraction on the card and the host's
    float64 one may put the next peak in another cell: there each map's
    fitted field is held to the host's fidelity, its largest error
    against the grid within FIELD_TOL of the host fit's; the parameters'
    errors are reported."""
    from mpc_ros_tpu_torch.models.obstacles import (ObstacleMap,
                                                    fit_gaussians_to_map,
                                                    fit_gaussians_to_maps,
                                                    gaussian_blob_map)

    gen = torch.Generator().manual_seed(33)
    c = torch.rand((B_FIT, 2), generator=gen) * 2.4 - 1.2
    sig = 0.25 + 0.3 * torch.rand(B_FIT, generator=gen)
    m = gaussian_blob_map((c[:, 0], c[:, 1]), sigma=0.3, weight=50.0)
    # per-map widths: the map of sigma s is the sigma-0.3 map to the power
    # (0.3 / s)^2
    grid = m.grid ** ((0.3 / sig) ** 2)[:, None, None]
    grid[::16] = 0.0
    weight = m.weight.clone()
    for i, jm in enumerate((
            gaussian_blob_map((0.8, 0.5), sigma=0.3, weight=100.0),
            gaussian_blob_map((-0.5, 1.0), sigma=0.5, weight=50.0),
            ObstacleMap.empty())):
        grid[i], weight[i] = jm.grid, jm.weight
    maps = m.replace(grid=grid, weight=weight)
    dmaps = maps.to(device=dev)
    fit = fit_gaussians_to_maps(dmaps, COSTMAP_BLOBS)
    torch.cuda.synchronize()
    times = []
    for _ in range(WINDOW):
        fit, t = host_s(lambda: fit_gaussians_to_maps(dmaps, COSTMAP_BLOBS))
        times.append(t)
    t0 = time.perf_counter()
    host = [fit_gaussians_to_map(maps.replace(**{
        f: getattr(maps, f)[i] for f in ("grid", "origin", "resolution",
                                         "weight")}), COSTMAP_BLOBS,
        refine=False) for i in range(B_FIT)]
    host_s_total = time.perf_counter() - t0
    hb = GaussianObstacles(*(torch.stack([getattr(b, f) for b in host])
                             for f in ("cx", "cy", "gamma", "w")))
    worst, ok = {}, True
    for name, tol in FIT_BAR:
        h = getattr(hb, name).double()
        d = getattr(fit, name).double().cpu()
        e = (h - d).abs() / (1.0 + h.abs())
        worst[name] = dict(jax_test_maps=float(e[:3].max()),
                           first_peel=float(e[:, 0].max()),
                           later_peels=float(e[:, 1:].max()))
        ok = ok and (worst[name]["jax_test_maps"] < tol
                     and worst[name]["first_peel"] < tol)
    g = grid.double()
    f_host, f_dev = fitted_field(hb, maps), fitted_field(fit, maps)
    err_host = (f_host - g).abs().amax(dim=(1, 2))
    err_dev = (f_dev - g).abs().amax(dim=(1, 2))
    fidelity = dict(
        host_max_err=float(err_host.max()), device_max_err=float(
            err_dev.max()),
        worst_excess=float((err_dev - err_host).max()),
        fields_max_diff=float((f_host - f_dev).abs().max()),
        tol=FIELD_TOL)
    ok = ok and fidelity["worst_excess"] <= FIELD_TOL
    out = dict(batch=B_FIT, device_ms=statistics.median(times) * 1e3,
               device_times_ms=[t * 1e3 for t in times],
               host_ms_per_map=host_s_total / B_FIT * 1e3,
               worst_rel=worst, bar=dict(FIT_BAR), fidelity=fidelity)
    if not ok:
        emit("device_fit", **out)
        raise SystemExit(f"device fit against the host fit: {out}")
    return out


def robot_past_obstacle(dev, route: str) -> dict:
    """Phase 33 (single robot): `MPCPlanner` (float32, N=20, on the card)
    on a straight 6 m course through OBSTACLE, the costmap through
    `set_costmap` (a world map fitted to blobs once) or through
    `tracker.obstacle_map` (a robot-frame 64x64 map of every cycle's pose,
    sampled by the solver: spline_coeff): the goal reached, the closest
    approach above ROBOT_CLEAR and ROBOT_GAIN beyond the plan's own
    distance; cycles and ms per cycle."""
    from mpc_ros_tpu_torch.models.obstacles import (ObstacleMap,
                                                    gaussian_blob_map)
    from mpc_ros_tpu_torch.obs import RunStats
    from mpc_ros_tpu_torch.planner import MPCPlanner
    from mpc_ros_tpu_torch.sim import run_closed_loop

    n = 120
    plan = np.stack([np.linspace(0.0, 6.0, n), np.zeros(n), np.zeros(n)],
                    -1)
    pl = MPCPlanner(MPCParams(**ROBOT_PARAMS), SolverConfig(n_steps=20),
                    LOOP_PLANNER, device=dev)
    pl.initialize()
    stats = RunStats()
    pl.on_cycle = stats.record_cycle
    if route == "set_costmap":
        pl.set_costmap(gaussian_blob_map(OBSTACLE, sigma=0.3, extent=8.0,
                                         weight=50.0))
    else:
        cells, extent = 64, 4.0
        xs = np.linspace(-extent / 2, extent / 2, cells)
        XR, YR = np.meshgrid(xs, xs)
        cycle = pl.compute_velocity_commands

        def with_map(pose, fb):
            ct, st = np.cos(pose[2]), np.sin(pose[2])
            wx = XR * ct - YR * st + pose[0]
            wy = XR * st + YR * ct + pose[1]
            g = np.exp(-((wx - OBSTACLE[0]) ** 2 + (wy - OBSTACLE[1]) ** 2)
                       / (2.0 * 0.3 ** 2))
            pl.tracker.obstacle_map = ObstacleMap(
                grid=torch.tensor(g, dtype=torch.float32),
                origin=torch.tensor([-extent / 2, -extent / 2]),
                resolution=torch.tensor(extent / (cells - 1)),
                weight=torch.tensor(50.0), sampling="spline_coeff")
            return cycle(pose, fb)

        pl.compute_velocity_commands = with_map
    reset_launches()
    res = run_closed_loop(pl, plan, max_cycles=600)
    d = float(np.min(np.hypot(res.poses[:, 0] - OBSTACLE[0],
                              res.poses[:, 1] - OBSTACLE[1])))
    d0 = abs(OBSTACLE[1])
    out = dict(route=route, reached=res.reached, cycles=res.n_cycles,
               course_time_s=res.course_time_s, wall_s=res.wall_time_s,
               closest_m=d, plan_distance_m=d0,
               cycle_ms=cycle_ms(stats.cycle_times_s),
               converged_frac=stats.summary()["converged_frac"],
               kernel_launches=solve_mega.launches,
               records_finite=bool(np.all(np.isfinite(res.records))))
    if route == "obstacle_map":
        om = pl.tracker.obstacle_map
        out["map_device"] = str(om.grid.device)
        if not (om.grid.device == dev and om.coeff is not None):
            raise SystemExit(f"obstacle_map not on the card: {out}")
    else:
        out["blobs_device"] = str(pl.world_obstacles.cx.device)
    if not (res.reached and d > ROBOT_CLEAR and d > d0 + ROBOT_GAIN
            and out["records_finite"]):
        raise SystemExit(f"single robot past the obstacle ({route}): {out}")
    return out


def costmap_routes(dev) -> dict:
    """Phase 33: the costmap routes on the card — the fleet through
    `set_costmaps` (K1's blob variant, one launch per cycle), the device
    fit against the host fit, the single robot through `set_costmap` and
    `tracker.obstacle_map`."""
    out = dict(fleet=costmap_fleet(dev), fit=device_fit(dev),
               robot=[robot_past_obstacle(dev, r)
                      for r in ("set_costmap", "obstacle_map")])
    emit("costmap_routes", **out)
    return out


def supervisors(dev) -> dict:
    """Phase 34: `SafetyMonitor` and `RecoverySupervisor` around the card's
    `MPCPlanner` on tests/test_recovery.py:189's lost-plan case (N=10, cap
    8, the XLA lane knobs): the plan vanishes after the first cycle, the
    ladder replans on the third failure and tracking resumes, the
    monitor's fault cleared on the recovery (the JAX package's node
    wiring); every command through the monitor finite, the planner's
    cycles on the card."""
    from mpc_ros_tpu_torch.planner import (MPCPlanner, RecoveryConfig,
                                           RecoveryState, RecoverySupervisor,
                                           SafetyMonitor)

    planner = MPCPlanner(MPCParams(),
                         SolverConfig(n_steps=10, max_sqp_iters=8,
                                      backward="xla"),
                         PlannerConfig(), device=dev)
    planner.initialize()
    plan = np.stack([np.linspace(0, 3, 30), np.zeros(30), np.zeros(30)], 1)
    pose = np.array([0.0, 0.05, 0.0])
    sup = RecoverySupervisor(planner, RecoveryConfig(
        failures_to_recover=3, rotate_speed=0.4, rotate_cycles_max=5,
        max_rounds=2))
    mon = SafetyMonitor(period_s=0.1)
    if not sup.set_plan(plan, pose):
        raise SystemExit("supervisors: the plan was refused")
    trace = []
    t0 = time.perf_counter()
    for k in range(8):
        if k == 1:
            planner.global_plan = None        # a host-side fault
        ok, cmd, info = planner.compute_velocity_commands(pose, (0.2, 0.0))
        ok, cmd = sup.on_cycle(ok, cmd, pose, (0.2, 0.0))
        # the JAX package's node wiring: a recovery clears the fault the
        # monitor latched during the outage
        if ok and mon.status.fault and sup.state is RecoveryState.NORMAL:
            mon.clear_fault()
        v, w = mon.check(ok, cmd, info)
        trace.append(dict(ok=ok, cmd=[float(c) for c in cmd], applied=[v, w],
                          state=sup.state.value))
    out = dict(trace=trace, stats=dataclasses.asdict(sup.stats),
               safety=dataclasses.asdict(mon.status),
               wall_ms_per_cycle=(time.perf_counter() - t0) / 8 * 1e3,
               carry_device=str(planner.tracker._warm_dev.device))
    emit("supervisors", **out)
    if not (sup.state is RecoveryState.NORMAL and sup.stats.replans == 1
            and trace[-1]["ok"] and planner.global_plan is not None
            and not mon.status.fault
            and all(np.isfinite(t["applied"]).all() for t in trace)
            and planner.tracker._warm_dev.is_cuda):
        raise SystemExit(f"supervisors: the planner did not recover: {out}")
    return out


# Scale-out and the rest of the port (phases 35-41). The card machine has
# one GPU, so a mesh here repeats it: [cuda:0] * 2 splits a batch into two
# shards, each solved on a CUDA stream of its own (one K1 launch per
# shard); NCCL between GPUs is not exercised.
SHARDS = 2
# phase 36: the compact N=48 solve, split the same way
B_SHARD_LONG = 131072
# phase 37: the host fleet split over the mesh, held to the unsharded one
MESH_FLEET_CYCLES = 10
# phase 38: the horizon-parallel solve at PERF.md's N=100 shape, and 256
# of its lanes against the CPU
HORIZON = dataclasses.replace(LONGEST, horizon_parallel=True)
HORIZON_CPU_LANES = 256
# phase 40: the supervised node at the reference's 20 Hz
# (tests/test_realtime_20hz.py's planner, course and plant loop)
NODE_DT = 0.05
NODE_SECONDS = 35.0


def mesh_of(dev, n_data: int, n_time: int = 1):
    from mpc_ros_tpu_torch.parallel import make_mesh

    return make_mesh(n_data=n_data, n_time=n_time,
                     devices=[dev] * (n_data * n_time))


def results_equal(a, b) -> bool:
    return all(torch.equal(getattr(a, f), getattr(b, f))
               for f in ("us", "zs", "cost", "converged", "n_iters"))


def sharded_main(dev) -> dict:
    """Phase 35: `sharded_batch_solve` at the main path's shape (N=30,
    B=524,288) on a mesh of two entries of this card: two K1 launches of
    262,144 lanes per solve, each shard on its own stream, bit for bit
    the unsharded `batch_solve_lane` (at done_frac = 1 a lane's result
    does not depend on how the lanes group into blocks); ms per sharded
    and unsharded solve; one shard's launch timed, bounded and held
    against the plain version."""
    from mpc_ros_tpu_torch.parallel import sharded_batch_solve

    mesh = mesh_of(dev, SHARDS)
    z0s, coeffs = scenarios(1, B_MAIN, dev)
    p = params(B_MAIN, dev, False)
    sharded_batch_solve(mesh, z0s, coeffs, p, PROD)            # warm-up
    reps = 3
    reset_launches()
    res, t_sh = host_s(lambda: [sharded_batch_solve(mesh, z0s, coeffs, p,
                                                    PROD)
                                for _ in range(reps)][-1])
    launches = solve_mega.launches
    if launches != SHARDS * reps:
        raise SystemExit(f"sharded_main: {launches} K1 launches over {reps}"
                         f" solves on {SHARDS} shards")
    check_result(res, B_MAIN)
    flat, t_flat = host_s(lambda: batch_solve_lane(z0s, coeffs, p, PROD))
    equal = results_equal(res, flat)
    half = B_MAIN // SHARDS
    ins = lane_inputs(z0s[:half], coeffs[:half], params(half, dev, False),
                      PROD)
    _, win, bound, _ = timed_launch(ins, PROD)
    vs_plain, _, plain_s, _, _ = held_against_plain(ins, PROD,
                                                    "sharded_main shard 0")
    out = dict(batch=B_MAIN, shards=SHARDS, launches=launches,
               sharded_ms=t_sh / reps * 1e3, unsharded_ms=t_flat * 1e3,
               bit_for_bit=equal,
               converged_frac=float(res.converged.float().mean()),
               mean_iters=float(res.n_iters.float().mean()),
               kernel_ms=win["median_ms"], window=win, plain_ms=plain_s * 1e3,
               bound_ms=bound[0], bound_by=bound[1], vs_plain=vs_plain)
    emit("sharded_main", **out)
    if not equal:
        raise SystemExit("sharded_main: the sharded solve differs from the "
                         "unsharded one")
    return out


def sharded_compact(dev) -> dict:
    """Phase 36: the compact N=48 solve split over two shards against the
    unsharded compact solve: under done_frac < 1 the grouping of lanes
    matters, so the two are held at the single-pass fraction gates only
    (converged and iteration matches, flips, mean iterations)."""
    from mpc_ros_tpu_torch.parallel import sharded_batch_solve

    mesh = mesh_of(dev, SHARDS)
    z0s, coeffs = scenarios(7, B_SHARD_LONG, dev)
    p = params(B_SHARD_LONG, dev, False)
    sharded_batch_solve(mesh, z0s, coeffs, p, LONG)            # warm-up
    reset_launches()
    res, t_sh = host_s(lambda: sharded_batch_solve(mesh, z0s, coeffs, p,
                                                   LONG))
    launches, passes = solve_mega.launches, solve_mega.passes
    check_result(res, B_SHARD_LONG, LONG.n_steps)
    flat, t_flat = host_s(lambda: batch_solve_lane(z0s, coeffs, p, LONG))
    g = parity_gates(res.us.cpu().numpy(), res.cost.cpu().numpy(),
                     res.converged.cpu().numpy(), res.n_iters.cpu().numpy(),
                     flat.us.cpu().numpy(), flat.cost.cpu().numpy(),
                     flat.converged.cpu().numpy(),
                     flat.n_iters.cpu().numpy(), LONG.n_steps)
    lim = g["limits"]
    ok = (g["conv_match_frac"] >= lim["conv_match_frac"]
          and g["iters_match_frac"] >= lim["iters_match_frac"]
          and g["flip_or_oneside_frac"] <= lim["flip_or_oneside_frac"]
          and abs(g["mean_iters"][0] - g["mean_iters"][1])
          <= lim["mean_iters_diff"])
    out = dict(batch=B_SHARD_LONG, shards=SHARDS, launches=launches,
               passes=passes, sharded_ms=t_sh * 1e3,
               unsharded_ms=t_flat * 1e3, gates=g, fraction_gates_ok=ok)
    emit("sharded_compact", **out)
    if launches < 2 * SHARDS or not ok:
        raise SystemExit(f"sharded_compact: {out}")
    return out


def fleet_mesh(dev) -> dict:
    """Phase 37: `FleetPlanner(mesh=)` with 1,024 robots over 10 cycles on
    its own pose stream, each cycle's solve split over two shards (two K1
    launches of 512 lanes), against the unsharded fleet fed the same
    poses: the commands equal every cycle. ms per cycle of both; one
    shard's warm solve held against the plain version."""
    from mpc_ros_tpu_torch.planner import FleetPlanner
    from mpc_ros_tpu_torch.solver import batch_lane
    from mpc_ros_tpu_torch.testing import step_poses

    plans = fleet_plans(FLEET_B)
    fps = []
    for mesh in (None, mesh_of(dev, SHARDS)):
        fp = FleetPlanner(fleet_params(), FLEET, LOOP_PLANNER, device=dev,
                          mesh=mesh)
        fp.initialize(FLEET_B)
        poses = np.stack([pl[0] for pl in plans]).astype(float)
        if not fp.set_plans(plans, poses).all():
            raise SystemExit("fleet_mesh: a plan was refused")
        fps.append(fp)
    poses = np.stack([pl[0] for pl in plans]).astype(float)
    fb = np.zeros((FLEET_B, 2))
    times = ([], [])
    launches = [0, 0]
    worst = 0.0
    with SolveTap(batch_lane) as tap:
        for c in range(MESH_FLEET_CYCLES):
            cmds = []
            for k, fp in enumerate(fps):
                tap.want = k == 1 and c == FLEET_CAPTURE
                reset_launches()
                t0 = time.perf_counter()
                _, cmd, _ = fp.compute_velocity_commands(poses.copy(),
                                                         fb.copy())
                times[k].append(time.perf_counter() - t0)
                launches[k] += solve_mega.launches
                cmds.append(cmd)
            if not np.isfinite(cmds[1]).all():
                raise SystemExit(f"fleet_mesh: non-finite commands, cycle "
                                 f"{c}")
            worst = max(worst, float(np.abs(cmds[0] - cmds[1]).max()))
            fb = step_poses(poses, cmds[0], 0.1)
        k1 = fleet_k1_check(tap.calls.pop(), "fleet_mesh shard 0")
    out = dict(batch=FLEET_B, shards=SHARDS, cycles=MESH_FLEET_CYCLES,
               unsharded=fleet_rate(times[0], FLEET_B),
               sharded=fleet_rate(times[1], FLEET_B),
               k1_launches=launches[1], k1_launches_unsharded=launches[0],
               max_cmd_diff=worst, k1=k1)
    emit("fleet_mesh", **out)
    if worst != 0.0 or launches[1] != SHARDS * MESH_FLEET_CYCLES:
        raise SystemExit(f"fleet_mesh: {out}")
    return out


def horizon_parallel(dev) -> dict:
    """Phase 38: `ilqr.solve` with the horizon-parallel backward at N=100,
    B=16,384 (cap 45) in float32: ms per solve, SQP iterations, active-set
    sweeps per iteration and host reads, no kernel on this path; its
    gates against the sequential Gauss-Newton solve of the same profile
    on the card printed, not held (the JAX package's own pair fails them
    at this shape alike: `tools/horizon_parallel_vs_jax.py`, PERF.md).
    Held: 256 of its lanes in float64 on the card against the same solve
    on the CPU (equal iterations and convergence on every lane, controls
    within tests/test_riccati.py's 1e-6), and tests/test_riccati.py:105's
    interior problem (N=40) against the sequential solve on the card in
    float64 within 1e-6."""
    from mpc_ros_tpu_torch.solver import ilqr, riccati

    seq_cfg = dataclasses.replace(HORIZON, horizon_parallel=False, ddp=False)
    z0s, coeffs = scenarios(5, B_LONGEST, dev)
    p = params(B_LONGEST, dev, False)
    reset_launches()
    reads, sweeps = ilqr.host_reads, riccati.sweeps
    sweep_reads = riccati.host_reads
    res, t_par = host_s(lambda: ilqr.solve(z0s, coeffs, p, HORIZON))
    iters = ilqr.host_reads - reads
    sweeps = riccati.sweeps - sweeps
    sweep_reads = riccati.host_reads - sweep_reads
    launches = solve_mega.launches
    check_result(res, B_LONGEST, HORIZON.n_steps)
    seq, t_seq = host_s(lambda: ilqr.solve(z0s, coeffs, p, seq_cfg))
    vs_seq = parity_gates(*(x.cpu().numpy() for x in (
        res.us, res.cost, res.converged, res.n_iters, seq.us, seq.cost,
        seq.converged, seq.n_iters)), HORIZON.n_steps)
    # float64: the card against the CPU on the first 256 lanes
    n, f64 = HORIZON_CPU_LANES, torch.float64
    cpu = torch.device("cpu")
    z64, c64 = z0s[:n].to(f64), coeffs[:n].to(f64)
    p64 = MPCParams().astype(f64, dev)
    card, t_card = host_s(lambda: ilqr.solve(z64, c64, p64, HORIZON))
    t0 = time.perf_counter()
    ref = ilqr.solve(z64.to(cpu), c64.to(cpu), MPCParams().astype(f64),
                     HORIZON)
    t_cpu = time.perf_counter() - t0
    vs_cpu = dict(
        lanes=n, iters_equal=bool(torch.equal(card.n_iters.cpu(),
                                              ref.n_iters)),
        converged_equal=bool(torch.equal(card.converged.cpu(),
                                         ref.converged)),
        max_du=float((card.us.cpu() - ref.us).abs().max()), bar=1e-6,
        card_ms=t_card * 1e3, cpu_ms=t_cpu * 1e3)
    # tests/test_riccati.py's interior problem in float64 on the card
    f64d = dict(dtype=f64, device=dev)
    z1 = torch.tensor([0.0, 0.0, 0.0, 0.3, 0.05, -0.0997], **f64d)
    c1 = torch.tensor([0.05, -0.1, 0.2, -0.02], **f64d)
    p1 = MPCParams(w_cte=100.0, w_vel=100.0, w_angvel_d=10.0,
                   w_accel_d=10.0).astype(f64, dev)
    r_seq = ilqr.solve(z1, c1, p1, SolverConfig(n_steps=40, tol_grad=1e-9))
    r_par = ilqr.solve(z1, c1, p1, SolverConfig(n_steps=40, tol_grad=1e-9,
                                                horizon_parallel=True))
    f64_du = float((r_par.us - r_seq.us).abs().max())
    out = dict(batch=B_LONGEST, n_steps=HORIZON.n_steps,
               cap=HORIZON.max_sqp_iters, ms_per_solve=t_par * 1e3,
               sequential_ms_per_solve=t_seq * 1e3, sqp_iterations=iters,
               sweeps=sweeps, sweeps_per_iteration=sweeps / max(iters, 1),
               sweep_host_reads=sweep_reads, k1_launches=launches,
               converged_frac=float(res.converged.float().mean()),
               mean_iters=float(res.n_iters.float().mean()),
               vs_sequential_printed=vs_seq, vs_cpu_f64=vs_cpu,
               f64_interior=dict(max_du=f64_du, bar=1e-6,
                                 converged=bool(r_par.converged)))
    emit("horizon_parallel", **out)
    if not (vs_cpu["iters_equal"] and vs_cpu["converged_equal"]
            and vs_cpu["max_du"] <= 1e-6 and f64_du <= 1e-6
            and bool(r_par.converged) and launches == 0):
        raise SystemExit(f"horizon_parallel: {out}")
    return out


def dryrun(dev) -> dict:
    """Phase 39: `entry()` on the card (one K1 launch, finite first
    controls), then `dryrun_multichip(4)` on [cuda:0] * 4 (data 2 x
    time 2), every phase within the JAX dryrun's bounds."""
    from mpc_ros_tpu_torch import entry as port_entry

    fn, args = port_entry.entry()
    reset_launches()
    u0 = fn(*args)
    torch.cuda.synchronize()
    launches = solve_mega.launches
    t0 = time.perf_counter()
    out = port_entry.dryrun_multichip(4)
    out = dict(entry=dict(shape=list(u0.shape), k1_launches=launches,
                          finite=bool(torch.isfinite(u0).all())),
               dryrun=out, dryrun_s=time.perf_counter() - t0)
    emit("dryrun_multichip", **out)
    if launches != 1 or not out["entry"]["finite"]:
        raise SystemExit(f"entry: {out['entry']}")
    return out


def node_realtime(dev) -> dict:
    """Phase 40: the supervised `PlannerNode` (SafetyMonitor and
    RecoverySupervisor) at the reference's dt = 0.05 with
    tests/test_realtime_20hz.py's planner (N=20), course segment
    (infinity[:160]) and plant loop (integrated over the real elapsed
    time), its planner on the card, its cycle a captured solve: the two
    warm calls before `node.start()` capture it (one capture), the paced
    loop captures nothing. Gated on finite commands, a clean stop() and
    the bars of tests/test_realtime_20hz.py:83-108: the course reached or
    ended < 0.3 m from the goal, no latched fault, at most 2 budget
    failures in all and in a row, no node error, at least 100 cycles,
    overruns <= 5% of them and the worst lateness < 400 ms."""
    import struct

    from mpc_ros_tpu_torch.planner import (MPCPlanner, RecoverySupervisor,
                                           SafetyMonitor)
    from mpc_ros_tpu_torch.planner.node import (TWIST_FMT, PlannerNode,
                                                pack_pose, pack_twist)
    from mpc_ros_tpu_torch.sim import get_shape
    from mpc_ros_tpu_torch.solver import graphed

    p = MPCParams(dt=NODE_DT, ref_vel=0.5, w_cte=300.0, w_angvel_d=10.0,
                  w_accel_d=10.0, max_angvel=1.5)
    planner = MPCPlanner(params=p,
                         solver_cfg=SolverConfig(n_steps=20, backward="xla"),
                         planner_cfg=PlannerConfig(local_plan_length=2.5),
                         device=dev)
    planner.initialize()
    safety = SafetyMonitor(period_s=NODE_DT)
    recovery = RecoverySupervisor(planner)
    node = PlannerNode(planner, period_s=NODE_DT, recovery=recovery,
                       safety=safety)
    plan = get_shape("infinity")[:160]
    pose = plan[0].copy().astype(float)
    vel = (0.0, 0.0)
    node.pose_topic.publish(pack_pose(*pose))
    node.feedback_topic.publish(pack_twist(*vel))
    if not node.set_plan(plan):
        raise SystemExit("node_realtime: the plan was refused")
    # the cold and the first warm cycle outside the paced loop: the first
    # captures the cycle, the second replays it
    captures = graphed.captures
    t0 = time.perf_counter()
    planner.compute_velocity_commands(pose, vel)
    planner.compute_velocity_commands(pose, vel)
    warm_s = time.perf_counter() - t0
    warm_captures = graphed.captures - captures
    node.start()
    reached, cmds = False, []
    t_end = time.time() + NODE_SECONDS
    last = time.time()
    try:
        while time.time() < t_end:
            now = time.time()
            h, last = now - last, now
            raw = node.cmd_topic.read()
            if raw is not None:
                v, w = struct.unpack(TWIST_FMT, raw)
                cmds.append((v, w))
                pose = pose + h * np.array(
                    [v * np.cos(pose[2]), v * np.sin(pose[2]), w])
                vel = (v, w)
            node.pose_topic.publish(pack_pose(*pose))
            node.feedback_topic.publish(pack_twist(*vel))
            if planner.is_goal_reached(pose, vel):
                reached = True
                break
            time.sleep(0.004)
    finally:
        stopped = node.stop(timeout=10.0)
    goal = plan[-1]
    rs = node.rate_stats
    out = dict(dt=NODE_DT, rate_stats=rs,
               overrun_frac=rs["overruns"] / max(rs["cycles"], 1),
               node_cycles=node.cycles, errors=node.errors,
               last_error=node.last_error, reached=reached,
               dist_to_goal_m=float(np.hypot(pose[0] - goal[0],
                                             pose[1] - goal[1])),
               safety=dataclasses.asdict(safety.status),
               recovery=dataclasses.asdict(recovery.stats),
               commands_read=len(cmds), warm_up_s=warm_s, stopped=stopped,
               warm_captures=warm_captures,
               loop_captures=graphed.captures - captures - warm_captures,
               carry_device=str(planner.tracker._warm_dev.device))
    st = safety.status
    out["bars"] = bars = dict(
        course=reached or out["dist_to_goal_m"] < 0.3,
        no_fault=st.fault is False, failures=st.total_failures <= 2,
        streak=st.max_consecutive_failures <= 2, errors=node.errors == 0,
        cycles=rs["cycles"] >= 100,
        overruns=rs["overruns"] <= 0.05 * rs["cycles"],
        lateness=rs["worst_late_ms"] < 400.0,
        captures=warm_captures == 1 and out["loop_captures"] == 0)
    emit("node_realtime", **out)
    if not (stopped and cmds and np.isfinite(np.asarray(cmds)).all()
            and all(bars.values())):
        raise SystemExit(f"node_realtime: {out}")
    return out


def examples_on_card(dev) -> dict:
    """Phase 41: the examples `fleet_serving`, `fleet_planner --fleet 64
    --cycles 20` and `custom_model` on the card, each run to its end
    (`main`), with their seconds and K1 launches (their batches, 32, 64
    and 256 scenarios of a custom family, take the XLA lane path and the
    generic engine: B % 128 != 0 or no lane family)."""
    import importlib

    out = {}
    for name, argv in (("fleet_serving", []),
                       ("fleet_planner", ["--fleet", "64", "--cycles",
                                          "20"]),
                       ("custom_model", [])):
        mod = importlib.import_module(f"mpc_ros_tpu_torch.examples.{name}")
        reset_launches()
        _, s = host_s(lambda: mod.main(argv))
        out[name] = dict(argv=argv, seconds=s,
                         k1_launches=solve_mega.launches)
    emit("examples", **out)
    return out


# Phase 42: the benchmark's solver and weights (benchmark/configs/
# ref_nlp_n30.json, `MPCParams.reference_defaults()`), on whose cold
# batches the launcher's rule takes the persistent grid; the retiling
# fixture's batch (64 tiles) on a grid of 32 blocks
GRID_CFG = SolverConfig(n_steps=N_STEPS, max_sqp_iters=12, ls_iters=4,
                        ddp=True, tol_grad=1e-4, mu_init=1e-6, ddp_gate=2.5)
GRID_TILES = 64
GRID_SMALL = 32 * solve_mega.TILE


def bits_equal(x, y) -> bool:
    """Every output of two K1 calls equal bit for bit (NaN included)."""
    return all(torch.equal(a.contiguous().view(torch.int32),
                           b.contiguous().view(torch.int32))
               for a, b in zip(x, y))


def k1_kernels(prof) -> dict:
    """Launches and summed device ms of each K1 kernel, and of the memsets,
    in a `torch.profiler` trace."""
    out = {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        name = next((k for k in ("solve_mega_retile", "solve_mega_kernel")
                     if k in e.name), None)
        if name is None and "memset" in e.name.lower():
            name = "memset"
        if name is None:
            continue
        rec = out.setdefault(name, {"launches": 0, "ms": 0.0})
        rec["launches"] += 1
        rec["ms"] += e.time_range.elapsed_us() / 1e3
    return out


def persistent_grid(dev) -> dict:
    """Phase 42: K1's persistent grid forced at full residency
    (`testing.k1_grid`) on the batch cell's shape, B=524,288 cold at the
    benchmark's solver and weights: bit for bit one thread per lane, and
    against the plain version on the same inputs lane by lane (us and cost
    within LANE_TOL on LANE_FRAC of the lanes, the converged flags and the
    iterations matched on the parity gates' shares; the parity gates
    printed); its counts read from one call of its own after they are
    zeroed (calls, refilled lanes, re-solved tiles) with each kernel's
    launches and device ms from a profiler trace of that call, checked
    where the trace holds device events (`kernels_traced`); the grid
    and one thread per lane timed (`device_window`). Then lanes planted
    with NaN, inf and an overflowing coefficient, half of them resumed
    done beside running ones, over 64 tiles on a 32-block grid: bit for
    bit one thread per lane, tiles re-solved, and the planted lanes held
    to the plain version (`nonfinite_agreement`)."""
    from torch.profiler import ProfilerActivity, profile

    from mpc_ros_tpu_torch.testing import (k1_grid, nonfinite_agreement,
                                           plant_nonfinite)

    cfg = GRID_CFG
    variant = solve_mega.resolve_knobs(cfg, torch.float32).variant
    blocks, n_sm = solve_mega._residency(variant, dev)
    slots = blocks * n_sm * solve_mega.TILE
    weights = MPCParams.reference_defaults()
    z0s, coeffs = scenarios(42, B_MAIN, dev)
    ins = lane_inputs(z0s, coeffs, weights.astype(torch.float32, dev), cfg)

    def call():
        return solve_mega.solve_mega_cuda(*ins, cfg)

    with k1_grid(0):
        lane = call()
        lane_win = device_window(call)
    with k1_grid(slots):
        call()
        torch.cuda.synchronize()
        reset_launches()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            grid = call()
            torch.cuda.synchronize()
        counts = dict(calls=solve_mega.launches,
                      refilled_lanes=int(solve_mega.refilled_lanes),
                      retiled_tiles=int(solve_mega.retiled_tiles))
        grid_win = device_window(call)
    kernels = k1_kernels(prof)
    plain = solve_mega.solve_mega_plain(*ins, cfg)
    within = lanes_within([(grid[1], plain[1]), (grid[2], plain[2])],
                          LANE_TOL)
    gates = outputs_gates(grid, plain, cfg.n_steps)
    out = dict(batch=B_MAIN, slots=slots, blocks_per_sm=blocks, sms=n_sm,
               equals_one_lane_per_thread=bits_equal(grid, lane),
               counts=counts, kernels=kernels,
               kernels_traced=bool(kernels),
               grid=grid_win, one_lane_per_thread=lane_win,
               mean_iters=float(lane[4].mean()),
               pace=float(solve_mega.pace(lane[4])),
               lanes_within_frac=float(within.float().mean()),
               conv_match_frac=gates["conv_match_frac"],
               iters_match_frac=gates["iters_match_frac"],
               vs_plain=gates)
    # the retiling fixture
    B = GRID_TILES * solve_mega.TILE
    z0s, coeffs = scenarios(43, B, dev)
    clean = lane_inputs(z0s, coeffs, params(B, dev, False), cfg)
    lanes = [5 + 131 * i for i in range(60)]
    planted = plant_nonfinite({"z": clean[0], "coeffs": clean[1]}, lanes)
    bad = (planted["z"], planted["coeffs"]) + tuple(clean[2:])
    done = torch.zeros(B, device=dev)
    done[lanes[::2] + [9, 60, 1000, 4000]] = 1.0
    resume = (done, torch.zeros_like(done), torch.full_like(done, 1e-6),
              torch.full_like(done, float("inf")))
    with k1_grid(GRID_SMALL):
        ref = solve_mega.solve_mega_cuda(*clean, cfg, resume=resume)
        reset_launches()
        tiled = solve_mega.solve_mega_cuda(*bad, cfg, resume=resume)
        tiled_counts = dict(calls=solve_mega.launches,
                            refilled_lanes=int(solve_mega.refilled_lanes),
                            retiled_tiles=int(solve_mega.retiled_tiles))
    with k1_grid(0):
        tiled_lane = solve_mega.solve_mega_cuda(*bad, cfg, resume=resume)
    agree = nonfinite_agreement(
        tiled, solve_mega.solve_mega_plain(*bad, cfg, resume=resume), ref,
        lanes, LANE_TOL)
    out["retiling"] = dict(
        batch=B, slots=GRID_SMALL, planted_lanes=len(lanes),
        counts=tiled_counts,
        equals_one_lane_per_thread=bits_equal(tiled, tiled_lane),
        vs_plain=agree)
    emit("persistent_grid", **out)
    faults = []
    if not out["equals_one_lane_per_thread"]:
        faults.append("the grid differs from one thread per lane")
    if counts != dict(calls=1, refilled_lanes=B_MAIN - slots,
                      retiled_tiles=0):
        faults.append(f"counts {counts}")
    if kernels and {k: v["launches"] for k, v in kernels.items()
                    if k != "memset"} != {"solve_mega_kernel": 1,
                                          "solve_mega_retile": 1}:
        faults.append(f"kernels {kernels}")
    if not (out["lanes_within_frac"] >= LANE_FRAC
            and gates["conv_match_frac"] >= gates["limits"]["conv_match_frac"]
            and gates["iters_match_frac"]
            >= gates["limits"]["iters_match_frac"]):
        faults.append("the grid against the plain version")
    rt = out["retiling"]
    if not (rt["equals_one_lane_per_thread"] and agree["ok"]
            and agree["planted_lanes_with_nan"]
            and rt["counts"]["retiled_tiles"] > 0
            and rt["counts"]["refilled_lanes"] == B - GRID_SMALL):
        faults.append(f"the retiling fixture {rt}")
    if faults:
        raise SystemExit(f"persistent grid: {'; '.join(faults)}")
    return out


def build_pairs(survey: bool = False) -> set:
    """Every (kernel, variant) pair the phases launch (the survey's alone
    with `survey`): the whole-solve kernel's variants, then the fused
    backward and the line search."""
    # (config, blobs per lane, setpoint profile)
    cfgs = [(LONG, 0, False), (dataclasses.replace(LONG, done_frac=0.97), 0,
                               False), (OBST, K_MAIN, False),
            (solve_mega.compact_pass1_cfg(OBST), K_MAIN, False)]
    if not survey:
        cfgs += [(c, 0, False) for _, c, _ in variants()] + [
            (ROUTE_MEGA, 0, False), (BICYCLE, 0, False), (PROD, 0, True),
            (PROD_TILE, 0, False),
            (LONG, K_MAIN, True),
            (solve_mega.compact_pass1_cfg(LONG), K_MAIN, True)] + [
            (c, K_MAIN if bl else 0, rf) for _, c, bl, rf, _ in EFG_VARIANTS]
        # the fleet's solves (phases 27-29): plain, world blobs, the
        # bicycle, the trajectory tracker's setpoints
        cfgs += [(FLEET, 0, False), (FLEET, 1, False),
                 (FLEET_BICYCLE, 0, False), (FLEET, 0, True)]
        # the costmap fleet's (phase 33): the fitted blobs
        cfgs += [(FLEET, COSTMAP_BLOBS, False)]
        # `kernel_verify`'s (phase 30): exact trig on the kernel's side
        exact = dataclasses.replace(PROD, trig="exact")
        long_exact = dataclasses.replace(VERIFY_LONG, trig="exact")
        cfgs += [(exact, K_MAIN, False),
                 (dataclasses.replace(exact, model="bicycle"), 0, False),
                 (long_exact, 0, False),
                 (solve_mega.compact_pass1_cfg(long_exact), 0, False)]
    pairs = {("solve_mega", solve_mega.resolve_knobs(
        cfg, torch.float32, n_blobs=k, has_setp=rf).variant)
        for cfg, k, rf in cfgs}
    if not survey:
        pairs |= {("backward_fused", ()), ("forward", (N_ALPHA,))}
    return pairs


def main(argv) -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device; none found")
    seeds = None
    if argv:
        if len(argv) != 2 or argv[0] != "--survey":
            raise SystemExit("usage: chip_smoke.py [--survey SEED,SEED,...]")
        seeds = [int(s) for s in argv[1].split(",")]
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    global CARD
    CARD = card_line()
    print(CARD, flush=True)

    # every kernel variant the phases launch, one nvcc each, all at once
    t0 = time.perf_counter()
    pairs = build_pairs(survey=seeds is not None)
    builds = _build.build_many(sorted(pairs))
    emit("build", seconds=time.perf_counter() - t0,
         variants={f"{k}{v}": {"seconds": s, "ptxas": lines}
                   for (k, v), (s, lines) in builds.items()})
    # registers, local memory, the knot ring's shared memory and resident
    # blocks per SM of each variant of the whole-solve kernel
    emit("occupancy", variants={
        str(v): solve_mega.occupancy(v)
        for k, v in sorted(pairs) if k == "solve_mega"},
        forward={str(v): forward.occupancy(v[0])
                 for k, v in sorted(pairs) if k == "forward"})
    if seeds is not None:
        survey(dev, seeds)
        return

    max_err = kernel_vs_plain(dev)
    mp = main_path(dev)
    sv = serving(dev)
    max_err = max(max_err, mp["vs_plain"]["max_du"], sv["vs_plain"]["max_du"])
    st = stage_kernels_vs_plain(dev)
    nonfinite_lanes(dev)
    rm = route_main_path(dev, st["plain_route_s"])
    route_serving(dev)
    long_err = long_kernel_vs_plain(dev)
    lm = long_main_path(dev)
    longest_path(dev)
    sorted_schedule(dev)
    sweep_phase(dev)
    long_serving(dev)
    efg = stage_efg_vs_plain(dev)
    om = obstacle_main_path(dev)
    osv = obstacle_serving(dev)
    bk = bicycle_paths(dev)
    rf = main_path(dev, "refs_main_path", PROD, 19, with_refs=True)
    sched_err = schedules_blobs_refs(dev)
    engine_batch(dev)
    profiles_off_kernel(dev)
    single_scenario(dev)
    closed_loop(dev)
    closed_loop_cpu_parity(dev)
    trajectory_tracking(dev)
    fh = fleet_host(dev)
    fd = fleet_device(dev)
    ft = fleet_trajectory(dev)
    bench_verify(dev)
    compare(dev)
    grid_main_path(dev)
    cm = costmap_routes(dev)
    supervisors(dev)
    sh = sharded_main(dev)
    sharded_compact(dev)
    fm = fleet_mesh(dev)
    horizon_parallel(dev)
    dryrun(dev)
    node_realtime(dev)
    examples_on_card(dev)
    pg = persistent_grid(dev)
    fleet_err = max(fh[k]["k1"]["vs_plain"]["max_du"]
                    for k in ("plain", "bicycle", "blobs"))
    fleet_err = max(fleet_err, fd["k1"]["vs_plain"]["max_du"])
    fk = fh["plain"]["k1"]
    ck = cm["fleet"]["k1"]

    def entry(name, source, replaces, launches, err, ms, plain_ms, bound):
        return {"name": name, "route": "cuda",
                "source": f"mpc_ros_tpu_torch/kernels/csrc/{source}",
                "replaces": replaces, "launches": launches,
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound[0], "bound_by": bound[1],
                "library_ms": None}

    print(json.dumps({"kernels": [
        entry("solve_mega", "solve_mega.cu",
              "mpc_ros_tpu/kernels/solve_pallas.py:53", mp["launches"],
              max_err, mp["kernel_ms"], mp["plain_ms"],
              (mp["bound_ms"], mp["bound_by"])),
        # the same kernel on the long-horizon main path: both compact
        # passes per solve (the per-block exit, then the resumed tail)
        entry("solve_mega[N=48,compact]", "solve_mega.cu",
              "mpc_ros_tpu/kernels/solve_pallas.py:53",
              lm["counts_over_reps"]["launches"],
              max(long_err, lm["vs_plain"]["max_du"]), lm["kernel_ms"],
              lm["plain_ms"], (lm["bound_ms"], lm["bound_by"])),
        # the same kernel's blobs, bicycle and setpoint variants on their
        # main paths (the obstacle path: both compact passes per solve)
        entry("solve_mega[blobs]", "solve_mega.cu",
              "mpc_ros_tpu/kernels/solve_pallas.py:53",
              om["counts_over_reps"]["launches"],
              max(efg["blobs"], om["vs_plain"]["max_du"],
                  osv["vs_plain"]["max_du"], sched_err),
              om["kernel_ms"], om["plain_ms"],
              (om["bound_ms"], om["bound_by"])),
        entry("solve_mega[bicycle]", "solve_mega.cu",
              "mpc_ros_tpu/kernels/solve_pallas.py:53", bk["launches"],
              max(efg["bicycle"], bk["vs_plain"]["max_du"]),
              bk["kernel_ms"], bk["plain_ms"],
              (bk["bound_ms"], bk["bound_by"])),
        entry("solve_mega[refs]", "solve_mega.cu",
              "mpc_ros_tpu/kernels/solve_pallas.py:53", rf["launches"],
              max(efg["refs"], rf["vs_plain"]["max_du"], sched_err),
              rf["kernel_ms"], rf["plain_ms"],
              (rf["bound_ms"], rf["bound_by"])),
        # the same kernel serving a fleet, one launch per cycle: the host
        # pipeline's main run (its plain, bicycle and blob solves and the
        # device pipeline's held against the plain version), and the
        # trajectory tracker's setpoint solves (stage (f))
        entry("solve_mega[fleet]", "solve_mega.cu",
              "mpc_ros_tpu/kernels/solve_pallas.py:53",
              fh["plain"]["k1_launches"], fleet_err, fk["kernel_ms"],
              fk["plain_ms"], (fk["bound_ms"], fk["bound_by"])),
        entry("solve_mega[fleet_refs]", "solve_mega.cu",
              "mpc_ros_tpu/kernels/solve_pallas.py:53",
              ft["device"]["k1_launches"], ft["k1"]["vs_plain"]["max_du"],
              ft["k1"]["kernel_ms"], ft["k1"]["plain_ms"],
              (ft["k1"]["bound_ms"], ft["k1"]["bound_by"])),
        # the same kernel on the fleet's costmap route: grids fitted to
        # blobs on the card every cycle, K1's blob variant once a cycle
        entry("solve_mega[fleet_costmap]", "solve_mega.cu",
              "mpc_ros_tpu/kernels/solve_pallas.py:53",
              cm["fleet"]["k1_launches"], ck["vs_plain"]["max_du"],
              ck["kernel_ms"], ck["plain_ms"],
              (ck["bound_ms"], ck["bound_by"])),
        # the same kernel split over a mesh of two entries of this card:
        # one launch per shard per solve (phase 35) and per fleet cycle
        # (phase 37), each shard held against the plain version
        entry("solve_mega[sharded]", "solve_mega.cu",
              "mpc_ros_tpu/kernels/solve_pallas.py:53", sh["launches"],
              sh["vs_plain"]["max_du"], sh["kernel_ms"], sh["plain_ms"],
              (sh["bound_ms"], sh["bound_by"])),
        entry("solve_mega[fleet_mesh]", "solve_mega.cu",
              "mpc_ros_tpu/kernels/solve_pallas.py:53", fm["k1_launches"],
              fm["k1"]["vs_plain"]["max_du"], fm["k1"]["kernel_ms"],
              fm["k1"]["plain_ms"],
              (fm["k1"]["bound_ms"], fm["k1"]["bound_by"])),
        # the same kernel on its persistent grid at the batch cell's
        # shape: one call, two kernels (phase 42)
        entry("solve_mega[grid]", "solve_mega.cu",
              "mpc_ros_tpu/kernels/solve_pallas.py:53",
              pg["counts"]["calls"], pg["vs_plain"]["max_du"],
              pg["grid"]["median_ms"], None, (None, None)),
        entry("backward_fused", "backward_fused.cu",
              "mpc_ros_tpu/kernels/backward_fused_pallas.py:52",
              rm["launches"]["backward_fused"], st["bwd_err"], rm["bwd_ms"],
              st["bwd_plain_ms"], (rm["bwd_bound_ms"], rm["bwd_bound_by"])),
        entry("forward", "forward.cu",
              "mpc_ros_tpu/kernels/forward_pallas.py:37",
              rm["launches"]["forward"], st["fwd_err"], rm["fwd_ms"],
              st["fwd_plain_ms"], (rm["fwd_bound_ms"], rm["fwd_bound_by"])),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
