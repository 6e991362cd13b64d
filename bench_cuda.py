#!/usr/bin/env python3
"""Benchmark harness of the PyTorch/CUDA port (`mpc_ros_tpu_torch`) on one
GPU: the counterpart of `bench.py`, its flags, default shapes, seeds'
roles and timing method, on the card.

Prints ONE JSON line per run (`--roofline` adds a second):

  {"metric": ..., "value": N, "unit": ..., "device": "<card, power limit>",
   ...extras}

Usage:
  python3 bench_cuda.py                 # the K1 main path, N=30, B=524,288
  python3 bench_cuda.py --verify        # K1 against the XLA lane path
  python3 bench_cuda.py --serving | --sweep | --fleet | --fleet-trajectory
  python3 bench_cuda.py --quick         # small CPU run (plain versions)

Without `--quick` it runs on the card (`planner.tracking.resolve_device`)
and exits non-zero when there is none; `--quick` is the caller asking for
the CPU: small batches, and the kernels' plain versions in their place.

Where it differs from `bench.py`:
  * `vs_baseline` is gone (its denominator was a per-TPU-chip target);
    `device` is the card's name and power limit as nvidia-smi reports
    them ("cpu" under --quick);
  * the latency floor is a bare fetch of an 8-element reduction
    (`fetch_floor_ms_*`, `solve_net_of_floor_ms`), not a tunnel's RTT;
  * `--roofline` reports `mean_warp_max_iters`: K1 exits per thread, so a
    32-lane warp runs to its slowest lane (there is no TPU tile);
  * the fleet modes report their first FLEET_COLD cycles apart
    (`cold_ms`), and p50 / p99 ms and robot-cycles/s (robots x cycles
    over the window's whole time) over the rest;
  * `kernel_verify` holds K1 against the port's XLA lane path on seeded
    numpy scenarios (`testing.numpy_scenarios`, `numpy_blobs`) and reads
    whether the compact schedule engaged from the schedule's own counters;
  * `--obstacles-grid` (bench.py's grid ensemble: B=4,096, one Gaussian
    costmap per scenario, cap 30, `--grid-sampling` spline_coeff by
    default) runs on the XLA lane path on the card, as the JAX package
    runs grid maps off its kernels; the line adds `grid_sampling` and
    `max_sqp_iters`.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import time

import numpy as np
import torch

# the fleet modes' first cycles, reported apart from the timed window
FLEET_COLD = 2


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def warp_max_iters(iters) -> float:
    """The mean over 32-lane warps of the warp's largest iteration count:
    the iterations a warp pays under K1's per-thread exit."""
    return float(iters.reshape(-1, 32).max(dim=1).values.float().mean())


def blob_centres(seed: int, B: int, dtype, dev) -> torch.Tensor:
    """(B, 2) blob centres uniform in [0.3, 1.2]^2 (bench.py's field)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    return 0.3 + 0.9 * torch.rand((B, 2), dtype=dtype, device=dev,
                                  generator=gen)


def blob_field(centres: torch.Tensor, K: int):
    """bench.py's obstacle layout: the live blob at `centres`, K - 1 inert
    ones at (50, 50), sigma 0.3, weight 100."""
    from mpc_ros_tpu_torch.models.obstacles import GaussianObstacles

    B = centres.shape[0]
    far = torch.full((B, K - 1), 50.0, dtype=centres.dtype,
                     device=centres.device)
    full = torch.full((B, K), 0.3, dtype=centres.dtype, device=centres.device)
    return GaussianObstacles.from_sigmas(
        torch.cat([centres[:, :1], far], 1), torch.cat([centres[:, 1:], far],
                                                       1),
        full, torch.full_like(full, 100.0))


def kernel_verify(p, cfg, dtype, batch: int = 1024, strict_trig: bool = True,
                  variant: str = "plain", expect_compact: bool = False,
                  device=None) -> dict:
    """K1 (`backward="mega"`) against the XLA lane path (`backward="xla"`)
    on the same batch, on `device` (the card unless the caller names
    another), held to `bench.py::kernel_verify`'s gates
    (`verify.parity_gates`; its compact rule where compaction engaged).

    The scenarios are `testing.numpy_scenarios(0, B)`; "blobs" adds
    bench.py's K=4 field (`testing.numpy_blobs(1, B)`), "bicycle" the
    bicycle family. `trig="exact"` on the kernel side keeps a failure
    attributable to the kernel, not to the fast trig. Whether the compact
    schedule engaged is read from the schedule's counters
    (`solve_mega.passes`, `tail_lanes`): two passes, a tail smaller than
    the batch; `expect_compact` fails the check when it did not."""
    from mpc_ros_tpu_torch.kernels import solve_mega
    from mpc_ros_tpu_torch.models.obstacles import GaussianObstacles
    from mpc_ros_tpu_torch.planner.tracking import resolve_device
    from mpc_ros_tpu_torch.solver.batch_lane import batch_solve_lane
    from mpc_ros_tpu_torch.testing import numpy_blobs, numpy_scenarios
    from mpc_ros_tpu_torch.verify import parity_gates

    dev = resolve_device(device)
    B = batch - batch % 128
    z0, c = numpy_scenarios(0, B)
    z0s = torch.tensor(z0, dtype=dtype, device=dev)
    coeffs = torch.tensor(c, dtype=dtype, device=dev)
    blobs = None
    if variant == "blobs":
        blobs = GaussianObstacles.from_sigmas(*(
            torch.tensor(a, dtype=dtype, device=dev)
            for a in numpy_blobs(1, B, 4)))
    elif variant == "bicycle":
        cfg = dataclasses.replace(cfg, model="bicycle")
    trig = "exact" if strict_trig else cfg.trig
    sched = cfg.schedule
    if sched == "auto" and cfg.n_steps > 36:
        sched = "compact"
    solve_mega.passes = solve_mega.tail_lanes = 0
    r_m = batch_solve_lane(z0s, coeffs, p, dataclasses.replace(
        cfg, backward="mega", trig=trig), blobs=blobs)
    compact_engaged = (sched == "compact" and solve_mega.passes == 2
                       and 0 < solve_mega.tail_lanes < B)
    r_x = batch_solve_lane(z0s, coeffs, p, dataclasses.replace(
        cfg, backward="xla"), blobs=blobs)
    g = parity_gates(*(t.cpu().numpy() for t in (
        r_m.us, r_m.cost, r_m.converged, r_m.n_iters, r_x.us, r_x.cost,
        r_x.converged, r_x.n_iters)), cfg.n_steps, compact=compact_engaged)
    out = {
        "batch": B,
        "max_du": g["max_du"],
        "max_rel_dcost": g["max_rel_dcost"],
        "conv_match_frac": g["conv_match_frac"],
        "iters_match_frac": g["iters_match_frac"],
        "flip_or_oneside_frac": g["flip_or_oneside_frac"],
        "mean_iters_mega_xla": g["mean_iters"],
    }
    if sched == "compact":
        out["compact_engaged"] = compact_engaged
        out["tail_lanes"] = int(solve_mega.tail_lanes)
    out["limits"] = g["limits"]
    out["ok"] = bool(g["ok"] and (compact_engaged or not expect_compact))
    return out


def lat_stats(ls) -> dict:
    """Per-leg latency stats: p50, p99, the samples over 3x the leg's own
    p50 (stalls) and the p99 without them (bench.py's attribution)."""
    a = np.asarray(ls) * 1e3
    p50 = float(np.percentile(a, 50))
    clean = a[a <= 3.0 * p50]
    return {
        "p50": p50,
        "p99": float(np.percentile(a, 99)),
        "stalls": int(np.sum(a > 3.0 * p50)),
        "p99_net_of_stalls": (float(np.percentile(clean, 99)) if clean.size
                              else float("nan")),
    }


def fleet_rate(laps, B: int) -> dict:
    """A fleet run's per-cycle host times: the first FLEET_COLD apart,
    then p50 / p99 ms and robot-cycles/s over the rest."""
    warm = np.asarray(laps[FLEET_COLD:])
    return {
        "value": B * warm.size / float(warm.sum()),
        "cold_ms": [float(t) * 1e3 for t in laps[:FLEET_COLD]],
        "cycle_ms_p50": float(np.percentile(warm, 50)) * 1e3,
        "cycle_ms_p99": float(np.percentile(warm, 99)) * 1e3,
        "cycles": int(warm.size),
    }


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="small CPU run on the plain versions")
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--n-steps", type=int, default=30)
    ap.add_argument("--iters", type=int, default=None,
                    help="fixed SQP iteration cap for the throughput run")
    ap.add_argument("--schedule", choices=["auto", "single", "sorted",
                                           "compact"], default="auto",
                    help="K1's iteration schedule (see SolverConfig)")
    ap.add_argument("--ls-iters", type=int, default=None,
                    help="parallel line-search candidate count "
                         "(default: 4 with ddp, 5 with --no-ddp)")
    ap.add_argument("--no-ddp", dest="ddp", action="store_false",
                    help="disable the hybrid GN->DDP second-order backward "
                         "pass (SolverConfig.ddp)")
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--pipeline", type=int, default=None,
                    help="batches in flight for the steady-state throughput "
                         "measurement (default 16 on the card, 2 with "
                         "--quick)")
    ap.add_argument("--obstacles", action="store_true",
                    help="per-scenario Gaussian-blob obstacles (K1's blob "
                         "variant)")
    ap.add_argument("--obstacles-grid", action="store_true",
                    help="per-scenario grid-costmap obstacle penalties (the "
                         "XLA lane path: grid maps take no kernel)")
    ap.add_argument("--grid-sampling",
                    choices=["spline", "spline_coeff", "bilinear"],
                    default="spline_coeff",
                    help="costmap reconstruction for --obstacles-grid: "
                         "spline_coeff = the C1 quadratic B-spline from "
                         "per-cell coefficient planes, spline = the 9-tap "
                         "stencil, bilinear = costmap_2d's C0 "
                         "interpolation")
    ap.add_argument("--sweep", action="store_true",
                    help="Monte-Carlo tuning-sweep metric: 8 weight "
                         "candidates x 16,384 scenarios in one batch")
    ap.add_argument("--serving", action="store_true",
                    help="receding-horizon serving: warm-started control "
                         "cycles/s for the whole robot fleet")
    ap.add_argument("--fleet", action="store_true",
                    help="fleet serving: the whole planner lifecycle for "
                         "--batch robots, one batched solve per cycle")
    ap.add_argument("--fleet-host", dest="fleet_device",
                    action="store_false",
                    help="with --fleet: the host-pipeline FleetPlanner "
                         "instead of the default DeviceFleetPlanner")
    ap.add_argument("--fleet-wire", choices=["f32", "i16"], default="f32",
                    help="with the device fleet: the per-cycle wire format")
    ap.add_argument("--fleet-obs-every", type=int, default=1,
                    help="with the device fleet: fetch the observability "
                         "tile every K cycles (0 = commands only)")
    ap.add_argument("--fleet-pipelined", action="store_true",
                    help="with --fleet: overlap cycle k+1's host pipeline "
                         "with cycle k's solve (begin_cycle/finish_cycle)")
    ap.add_argument("--fleet-trajectory", action="store_true",
                    help="FleetTrajectoryTracker serving: B robots chasing "
                         "timed references, one setpoint-profile solve per "
                         "cycle")
    ap.add_argument("--roofline", action="store_true",
                    help="also print speed-of-light accounting (extra line)")
    ap.add_argument("--verify", action="store_true",
                    help="run ONLY K1 against the XLA lane path (plain, "
                         "blobs, bicycle at N=30 and the compact N=48 "
                         "schedule) and print its JSON line; exits 1 on a "
                         "broken gate")
    ap.add_argument("--presort", action="store_true",
                    help="host-side difficulty presort (engine.presort) "
                         "fitted on a calibration solve of another seed")
    ap.add_argument("--smart-init", action="store_true",
                    help="cold solves from engine.analytic_u_init instead "
                         "of zeros")
    ap.add_argument("--engine", choices=["lane", "vmap"], default="lane",
                    help="lane = the lane-major batched solver (K1); "
                         "vmap = the batch-first generic engine "
                         "(engine.batch_solve)")
    ap.add_argument("--model", choices=["diff_drive", "bicycle"],
                    default="diff_drive", help="vehicle family")
    args = ap.parse_args(argv)
    if args.ls_iters is None:
        args.ls_iters = 4 if args.ddp else 5
    return args


def main(argv=None) -> None:
    args = parse_args(argv)
    from mpc_ros_tpu_torch.config import MPCParams, SolverConfig
    from mpc_ros_tpu_torch.engine import batch_solve, make_random_scenarios
    from mpc_ros_tpu_torch.kernels import solve_mega
    from mpc_ros_tpu_torch.planner.tracking import resolve_device
    from mpc_ros_tpu_torch.solver.batch_lane import batch_solve_lane

    if args.quick:
        dev = torch.device("cpu")
        device_name = "cpu"
    else:
        try:
            dev = resolve_device(None)
        except RuntimeError as e:
            raise SystemExit(f"bench_cuda.py: {e}")
        torch.backends.cuda.matmul.allow_tf32 = False
        device_name = card_line()

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    # the plain throughput metric runs at 512k; serving holds 10 cycles of
    # state, the obstacle ensemble was characterized at 128k and the grid
    # ensemble at 4k
    plain = not (args.serving or args.obstacles or args.obstacles_grid
                 or args.sweep)
    batch = args.batch or (256 if args.quick else 524288 if plain
                           else 4096 if args.obstacles_grid else 131072)
    n_steps = args.n_steps
    # the horizon- and ensemble-aware cap of bench.py: 12 at N=30 with
    # DDP, a 30-iteration floor for the obstacle ensemble (and the bicycle
    # under GN), 0.45 N past N=32
    hard = args.obstacles or args.obstacles_grid or args.model == "bicycle"
    if args.ddp and not (args.obstacles or args.obstacles_grid):
        hard = False
    max_iters = args.iters or max(12 if not hard else 30,
                                  round(0.45 * n_steps) if n_steps > 32
                                  else 0)
    if args.obstacles and args.schedule == "auto" and args.iters is None:
        # the compact schedule for the obstacle ensemble's long tail
        args.schedule = "compact"
    dtype = torch.float32
    # on the CPU, K1's plain version stands in for the kernel
    backward = "mega" if args.quick else "auto"

    cfg = SolverConfig(n_steps=n_steps, max_sqp_iters=max_iters,
                       ls_iters=args.ls_iters, model=args.model,
                       schedule=args.schedule, ddp=args.ddp, tol_grad=1e-4,
                       backward=backward)
    p = MPCParams().astype(dtype, dev)

    if args.verify:
        t0 = time.perf_counter()
        out = {"metric": "kernel_parity_on_chip", "device": device_name}
        ok = True
        for variant in ("plain", "blobs", "bicycle"):
            kv = kernel_verify(p, cfg, dtype,
                               batch=min(args.batch or 1024, 1024),
                               variant=variant, device=dev)
            ok = ok and kv["ok"]
            out[variant] = kv
        # B=4,096 leaves the compact schedule a tail smaller than the batch
        kv = kernel_verify(
            p, dataclasses.replace(cfg, n_steps=48, max_sqp_iters=22),
            dtype, batch=4096, expect_compact=True, device=dev)
        ok = ok and kv["ok"]
        out["compact_n48"] = kv
        out["wall_s"] = time.perf_counter() - t0
        out["ok"] = ok
        print(json.dumps(out), flush=True)
        if not ok:
            raise SystemExit("kernel_verify FAILED: K1 deviates from the "
                             "XLA lane path on this card")
        return

    if not (args.sweep or args.fleet or args.fleet_trajectory):
        gen = torch.Generator(device=dev).manual_seed(0)
        z0s, coeffs = make_random_scenarios(gen, batch, dtype)
        centres_presorted = None
        if args.presort:
            # calibration on a DIFFERENT seed, then a host-side input
            # permutation; on the obstacle ensemble the calibration carries
            # blobs and the blob centres move with their scenarios
            from mpc_ros_tpu_torch.engine.presort import (
                fit_difficulty_model, predict_difficulty)

            nc = min(batch, 65536)
            zc, cc = make_random_scenarios(
                torch.Generator(device=dev).manual_seed(101), nc, dtype)
            cen_c = blobs_c = None
            if args.obstacles:
                cen_c = blob_centres(102, nc, dtype, dev)
                blobs_c = blob_field(cen_c, 4)
            rc = batch_solve_lane(zc, cc, p, cfg, blobs=blobs_c)
            model = fit_difficulty_model(
                zc.cpu().numpy(), cc.cpu().numpy(), rc.n_iters.cpu().numpy(),
                blob_xy=None if cen_c is None else cen_c.cpu().numpy())
            cen_b = None
            if args.obstacles:
                cen_b = blob_centres(1, batch, dtype, dev).cpu().numpy()
            keys = predict_difficulty(model, z0s.cpu().numpy(),
                                      coeffs.cpu().numpy(), blob_xy=cen_b)
            perm = torch.as_tensor(np.argsort(keys, kind="stable"),
                                   device=dev)
            z0s, coeffs = z0s[perm], coeffs[perm]
            if args.obstacles:
                centres_presorted = torch.as_tensor(cen_b, device=dev)[perm]

    if args.sweep:
        from mpc_ros_tpu_torch.engine.sweep import (sample_weight_candidates,
                                                    tuning_sweep)

        n_weights = 4 if args.quick else 8
        n_scen = 64 if args.quick else 16384
        cands = sample_weight_candidates(
            torch.Generator(device=dev).manual_seed(3), n_weights,
            MPCParams(), dtype=dtype)

        def sweep():
            return tuning_sweep(torch.Generator(device=dev).manual_seed(4),
                                cands, n_scen, cfg, dtype=dtype)

        t0 = time.perf_counter()
        sw = sweep()
        compile_s = time.perf_counter() - t0
        walls = []
        solve_mega.launches = 0
        for _ in range(max(1, args.repeats - 2)):
            t0 = time.perf_counter()
            sw = sweep()
            walls.append(time.perf_counter() - t0)
        wall = min(walls)
        total = n_weights * n_scen
        print(json.dumps({
            "metric": f"mc_tuning_sweep_solves_per_s_n{n_steps}",
            "value": total / wall,
            "unit": "solves/s",
            "total_solves": total,
            "n_weight_candidates": n_weights,
            "device": device_name,
            "compile_s": compile_s,
            "sweep_s": wall,
            "best_candidate": int(sw.best_index),
            "best_mean_terminal_cte": float(
                sw.mean_terminal_cte[sw.best_index]),
            "mean_iters_min_max": [float(sw.mean_iters.min()),
                                   float(sw.mean_iters.max())],
            "k1_launches_per_sweep": solve_mega.launches / len(walls),
        }), flush=True)
        return

    if args.fleet_trajectory:
        from mpc_ros_tpu_torch.config import PlannerConfig
        from mpc_ros_tpu_torch.models.obstacles import GaussianObstacles
        from mpc_ros_tpu_torch.planner.trajectory import (
            FleetTrajectoryTracker, TimedTrajectory)
        from mpc_ros_tpu_torch.sim import get_shape
        from mpc_ros_tpu_torch.testing import step_poses

        B = args.batch or (64 if args.quick else 1024)
        base = get_shape("infinity")
        trajs = []
        for i in range(B):
            pl2 = base.copy()
            pl2[:, :2] += 10.0 * (i % 64)
            trajs.append(TimedTrajectory.from_path(pl2,
                                                   0.3 + 0.002 * (i % 64)))
        ft_params = MPCParams(dt=0.1, max_angvel=1.5, w_cte=300.0,
                              w_angvel_d=10.0, w_accel_d=10.0)
        ft = FleetTrajectoryTracker(
            ft_params,
            SolverConfig(n_steps=20, ls_iters=args.ls_iters,
                         model=args.model, ddp=args.ddp, backward=backward),
            PlannerConfig(local_plan_length=2.5), pipeline="device",
            device=dev)
        ft.set_trajectories(trajs)
        if args.obstacles:
            # a world blob near each course, ahead of its start
            ahead, _, _ = ft._sample(np.full((B, 1), 2.0))
            ft.set_obstacles(GaussianObstacles.from_sigmas(
                torch.as_tensor(ahead[:, 0, 0:1] + 0.2, dtype=dtype),
                torch.as_tensor(ahead[:, 0, 1:2], dtype=dtype),
                torch.full((B, 1), 0.3, dtype=dtype),
                torch.full((B, 1), 40.0, dtype=dtype)))
        poses = np.stack([np.r_[t.xy[0], t.yaw[0]] for t in trajs])
        vs = np.zeros(B)
        lf = float(ft_params.lf) if args.model == "bicycle" else None
        laps = []
        t_now = 0.0
        solve_mega.launches = 0
        for _ in range(FLEET_COLD + max(5, args.repeats * 2)):
            t0 = time.perf_counter()
            cmds, _lags = ft.compute(t_now, poses, vs)
            laps.append(time.perf_counter() - t0)
            # the plant advances so cycles stay representative (mid-course)
            vs = step_poses(poses, cmds, 0.1, lf)[:, 0]
            t_now += 0.1
        tsuf = "_obstacles" if args.obstacles else ""
        tsuf += "" if args.model == "diff_drive" else f"_{args.model}"
        rate = fleet_rate(laps, B)
        print(json.dumps({
            "metric": f"fleet_trajectory_robot_cycles_per_s_n20{tsuf}",
            "value": rate.pop("value"),
            "unit": "robot-cycles/s",
            "batch": B,
            "device": device_name,
            "compile_s": laps[0],
            **rate,
            "k1_launches_per_cycle": solve_mega.launches / len(laps),
        }), flush=True)
        return

    if args.fleet:
        from mpc_ros_tpu_torch.planner import (DeviceFleetPlanner,
                                               FleetPlanner)
        from mpc_ros_tpu_torch.sim import get_shape

        B = args.batch or (64 if args.quick else 1024)
        plan0 = get_shape("infinity")
        plans = []
        for i in range(B):
            pl = plan0.copy()
            pl[:, :2] += 10.0 * (i % 64)
            plans.append(pl)
        fp_params = MPCParams(max_angvel=1.5, w_cte=300.0,
                              w_angvel_d=10.0, w_accel_d=10.0)
        if args.model == "bicycle":
            # steering authority covering the demo course (see sim.run)
            fp_params = dataclasses.replace(fp_params, lf=0.25,
                                            max_steer=0.6)
        fcfg = SolverConfig(n_steps=20, ls_iters=args.ls_iters,
                            model=args.model, ddp=args.ddp,
                            backward=backward)
        if args.fleet_device:
            fp = DeviceFleetPlanner(params=fp_params, solver_cfg=fcfg,
                                    obs_every=args.fleet_obs_every,
                                    wire=args.fleet_wire, device=dev)
        else:
            fp = FleetPlanner(params=fp_params, solver_cfg=fcfg, device=dev)
        fp.initialize(B)
        poses = np.stack([pl[0] for pl in plans])
        assert fp.set_plans(plans, poses).all()
        vw = np.zeros((B, 2))
        laps = []
        n_laps = FLEET_COLD + max(5, args.repeats * 2)
        solve_mega.launches = 0
        if args.fleet_pipelined:
            # steady-state pipelined rate: finish cycle k while k+1's host
            # pipeline runs against the in-flight solve
            h = fp.begin_cycle(poses, vw)
            for _ in range(n_laps):
                t0 = time.perf_counter()
                h_next = fp.begin_cycle(poses, vw)
                _, cmds, info = fp.finish_cycle(h)
                h = h_next
                laps.append(time.perf_counter() - t0)
            _, cmds, info = fp.finish_cycle(h)
        else:
            for _ in range(n_laps):
                t0 = time.perf_counter()
                _, cmds, info = fp.compute_velocity_commands(poses, vw)
                laps.append(time.perf_counter() - t0)
        launches = solve_mega.launches
        if args.fleet_device and args.fleet_obs_every != 1:
            # convergence from one unmeasured full-observability cycle
            fp.obs_every, fp._cycle_count = 1, 0
            _, _, info = fp.compute_velocity_commands(poses, vw)
        fsuffix = "" if args.model == "diff_drive" else f"_{args.model}"
        fsuffix += "_device" if args.fleet_device else "_host"
        if args.fleet_device and args.fleet_wire != "f32":
            fsuffix += f"_{args.fleet_wire}"
        if args.fleet_device and args.fleet_obs_every != 1:
            fsuffix += f"_obs{args.fleet_obs_every}"
        if args.fleet_pipelined:
            fsuffix += "_pipelined"
        rate = fleet_rate(laps, B)
        print(json.dumps({
            "metric": f"fleet_serving_robot_cycles_per_s_n20{fsuffix}",
            "value": rate.pop("value"),
            "unit": "robot-cycles/s",
            "batch": B,
            "device": device_name,
            "compile_s": laps[0],
            **rate,
            "converged_frac": float(np.mean(info.converged)),
            "k1_launches_per_cycle": launches / n_laps,
        }), flush=True)
        return

    if args.serving:
        from mpc_ros_tpu_torch.engine.receding import receding_horizon_rollout

        sblobs = None
        if args.obstacles:
            sblobs = blob_field(blob_centres(1, batch, dtype, dev), 1)
        n_cycles = 10

        def serve():
            tr = receding_horizon_rollout(z0s, coeffs, p, cfg,
                                          n_cycles=n_cycles, blobs=sblobs)
            float(tr.us.sum())
            return tr

        t0 = time.perf_counter()
        tr = serve()
        compile_s = time.perf_counter() - t0
        times = []
        solve_mega.launches = 0
        for _ in range(args.repeats):
            t0 = time.perf_counter()
            tr = serve()
            times.append(time.perf_counter() - t0)
        best = min(times)
        print(json.dumps({
            "metric": (f"mpc_serving_cycles_per_s_n{n_steps}"
                       + ("_obstacles" if sblobs is not None else "")),
            "value": batch * n_cycles / best,
            "unit": "control cycles/s",
            "batch": batch,
            "n_cycles": n_cycles,
            "device": device_name,
            "compile_s": compile_s,
            "mean_sqp_iters_warm": float(tr.iters[1:].float().mean()),
            "converged_frac": float(tr.converged.float().mean()),
            "k1_launches_per_cycle": solve_mega.launches / (
                n_cycles * len(times)),
        }), flush=True)
        return

    if args.obstacles:
        # one blob at a random spot ahead + 3 inert far blobs (K=4)
        centres = (centres_presorted if centres_presorted is not None
                   else blob_centres(1, batch, dtype, dev))
        blobs = blob_field(centres, 4)

        def solve_fn():
            return batch_solve_lane(z0s, coeffs, p, cfg, blobs=blobs)
    elif args.obstacles_grid:
        # one Gaussian costmap per scenario at bench.py's random spot
        # ahead; grid maps run on the XLA lane path whatever `backward`
        # says
        from mpc_ros_tpu_torch.models.obstacles import gaussian_blob_map

        centres = blob_centres(1, batch, dtype, dev)
        omaps = gaussian_blob_map((centres[:, 0], centres[:, 1]), sigma=0.3,
                                  weight=100.0, dtype=dtype,
                                  sampling=args.grid_sampling, device=dev)

        def solve_fn():
            return batch_solve_lane(z0s, coeffs, p, cfg, omaps=omaps)
    elif args.engine == "lane":
        if args.smart_init:
            from mpc_ros_tpu_torch.engine import analytic_u_init

            u_sm = analytic_u_init(z0s, coeffs, p, cfg)

            def solve_fn():
                return batch_solve_lane(z0s, coeffs, p, cfg, u_init=u_sm)
        else:
            def solve_fn():
                return batch_solve_lane(z0s, coeffs, p, cfg)
    else:
        def solve_fn():
            return batch_solve(z0s, coeffs, p, cfg)

    def done(res):
        # a scalar fetch: completion of the solve it reads
        return float(res.us.sum())

    # build + warm up
    t0 = time.perf_counter()
    res = solve_fn()
    done(res)
    compile_s = time.perf_counter() - t0

    times = []
    solve_mega.launches = 0
    for _ in range(args.repeats):
        t0 = time.perf_counter()
        res = solve_fn()
        done(res)
        times.append(time.perf_counter() - t0)
    best = min(times)
    launches = solve_mega.launches / args.repeats

    # steady-state throughput: n_pipe solves enqueued back to back, each
    # one's sum chained into the accumulator, one fetch at the end
    n_pipe = args.pipeline or (2 if args.quick else 16)
    pipe_times = []
    for _ in range(max(2, args.repeats - 2)):
        t0 = time.perf_counter()
        acc = None
        for _ in range(n_pipe):
            s = solve_fn().us.sum()
            acc = s if acc is None else acc + s
        float(acc)
        pipe_times.append(time.perf_counter() - t0)
    best_pipe = min(pipe_times)
    solves_per_s = batch * n_pipe / best_pipe

    conv = float(res.converged.float().mean())
    mean_iters = float(res.n_iters.float().mean())

    # the latency legs, sampled interleaved: the floor (a bare fetch), the
    # production single solve (`solve_jit` at the library's default
    # SolverConfig, as planner.tracking's cycle feeds it: one packed
    # upload through a pinned buffer, the warm carry shifted on the
    # device, one packed fetch; on the card the captured CUDA graphs of
    # solver/graphed.py) and the MPCPlanner cycle (captured too) on the
    # infinity course from plan[40]
    from mpc_ros_tpu_torch.planner.planner import MPCPlanner
    from mpc_ros_tpu_torch.planner.tracking import pack_result
    from mpc_ros_tpu_torch.sim import get_shape
    from mpc_ros_tpu_torch.solver import graphed
    from mpc_ros_tpu_torch.solver.ilqr import solve_jit

    tiny = torch.ones(8, dtype=dtype, device=dev)
    prod_cfg = SolverConfig(n_steps=n_steps, model=args.model)
    nc = prod_cfg.n_coeffs
    inp_host = np.zeros(6 + nc + 1, np.float64)
    inp_host[:6] = z0s[0].cpu().numpy()
    inp_host[6: 6 + nc] = coeffs[0].cpu().numpy()
    inp_host[6 + nc] = 0.5
    stage = torch.empty(len(inp_host), dtype=dtype,
                        pin_memory=dev.type == "cuda")
    state = {"carry": torch.zeros((prod_cfg.n_controls, 2), dtype=dtype,
                                  device=dev)}

    def prod_solve():
        stage.copy_(torch.from_numpy(inp_host))
        inp = stage.to(dev, non_blocking=True)
        carry = state["carry"]
        r = solve_jit(inp[:6], inp[6: 6 + nc],
                      dataclasses.replace(p, ref_vel=inp[6 + nc]), prod_cfg,
                      u_init=torch.cat([carry[1:], carry[-1:]]))
        state["carry"] = r.us
        pack_result(r).cpu().numpy()

    pparams = MPCParams(max_angvel=1.5, w_cte=300.0, w_angvel_d=10.0,
                        w_accel_d=10.0)
    if args.model == "bicycle":
        pparams = dataclasses.replace(pparams, lf=0.25, max_steer=0.6)
    pl = MPCPlanner(params=pparams, solver_cfg=prod_cfg, dtype=dtype,
                    device=dev)
    pl.initialize()
    plan = get_shape("infinity")
    pose = np.array([plan[40, 0], plan[40, 1], plan[40, 2]])
    pl.set_plan(plan, pose)

    # warm all three legs (each captured leg's first call records its
    # graphs), then interleave; the captures each leg made are counted
    float(tiny.sum())
    captures = {"single_solve": graphed.captures}
    prod_solve()
    captures["planner_cycle"] = graphed.captures
    captures["single_solve"] = graphed.captures - captures["single_solve"]
    pl.compute_velocity_commands(pose, (0.3, 0.0))
    captures["planner_cycle"] = graphed.captures - captures["planner_cycle"]
    warm_captures = graphed.captures
    n_lat = 10 if args.quick else 100
    floor_ls, solve_ls, cycle_ls = [], [], []
    for i in range(n_lat):
        t0 = time.perf_counter()
        float(tiny.sum())
        floor_ls.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        prod_solve()
        solve_ls.append(time.perf_counter() - t0)
        if i % 2 == 0:
            t0 = time.perf_counter()
            pl.compute_velocity_commands(pose, (0.3, 0.0))
            cycle_ls.append(time.perf_counter() - t0)
    floor_st = lat_stats(floor_ls)
    solve_st = lat_stats(solve_ls)
    cycle_st = lat_stats(cycle_ls)

    suffix = ("_obstacles" if args.obstacles
              else "_obstacles_grid" if args.obstacles_grid else "")
    if args.obstacles_grid and args.grid_sampling != "spline":
        suffix += f"_{args.grid_sampling}"
    suffix += "" if args.engine == "lane" or suffix else "_vmap"
    suffix += "" if args.model == "diff_drive" else f"_{args.model}"
    suffix += "_presorted" if args.presort else ""
    suffix += "_smart_init" if args.smart_init else ""
    it_arr = res.n_iters.double().cpu().numpy()
    out = {
        "metric": f"nmpc_solves_per_s_n{n_steps}{suffix}",
        "value": solves_per_s,
        "unit": "solves/s",
        "batch": batch,
        "device": device_name,
        "compile_s": compile_s,
        "best_batch_s": best,
        "pipeline": n_pipe,
        "steady_ms_per_batch": best_pipe / n_pipe * 1e3,
        "converged_frac": conv,
        "mean_sqp_iters": mean_iters,
        "p50_single_solve_ms": solve_st["p50"],
        "p99_single_solve_ms": solve_st["p99"],
        "p50_planner_cycle_ms": cycle_st["p50"],
        "p99_planner_cycle_ms": cycle_st["p99"],
        "fetch_floor_ms_p50": floor_st["p50"],
        "fetch_floor_ms_p99": floor_st["p99"],
        "solve_net_of_floor_ms": max(solve_st["p50"] - floor_st["p50"], 0.0),
        "latency_stalls": {"fetch_floor": floor_st["stalls"],
                           "single_solve": solve_st["stalls"],
                           "planner_cycle": cycle_st["stalls"]},
        "p99_net_of_stalls_ms": {
            "fetch_floor": floor_st["p99_net_of_stalls"],
            "single_solve": solve_st["p99_net_of_stalls"],
            "planner_cycle": cycle_st["p99_net_of_stalls"]},
        "iters_pcts": {q: float(np.percentile(it_arr, qq))
                       for q, qq in [("p50", 50), ("p90", 90), ("p97", 97),
                                     ("p99", 99), ("p999", 99.9)]},
        "iters_max": int(it_arr.max()),
        "unconverged_ppm": int(round(1e6 * (1.0 - conv))),
        "k1_launches_per_solve": launches,
        # CUDA-graph captures of the two latency legs (one signature each,
        # made by its warm call) and during the timed samples (none)
        "latency_captures": dict(captures,
                                 timed=graphed.captures - warm_captures),
    }
    if args.obstacles_grid:
        out.update(grid_sampling=args.grid_sampling,
                   max_sqp_iters=cfg.max_sqp_iters)
    # K1 against the XLA lane path on the card, every run of the main path
    # (plain N=30 and the compact N=48 schedule)
    if (args.engine == "lane" and not args.quick
            and not (args.obstacles or args.obstacles_grid)
            and dev.type == "cuda"):
        out["kernel_verify"] = kernel_verify(p, cfg, dtype, device=dev)
        out["kernel_verify_compact_n48"] = kernel_verify(
            p, dataclasses.replace(cfg, n_steps=48, max_sqp_iters=22), dtype,
            batch=4096, expect_compact=True, device=dev)
    print(json.dumps(out), flush=True)

    if args.roofline:
        from mpc_ros_tpu_torch.kernels import (efficiency,
                                               megakernel_accounting,
                                               solve_accounting)

        mega = (not args.obstacles_grid) and (
            cfg.backward == "mega" or (cfg.backward == "auto"
                                       and dev.type == "cuda"))
        make = megakernel_accounting if mega else solve_accounting
        kw = {"ddp": cfg.ddp} if mega else {}
        acct = make(batch, n_steps - 1, n_alpha=cfg.ls_iters,
                    n_iters=mean_iters, **kw)
        per_batch = best_pipe / n_pipe
        acct["measured_ms"] = per_batch * 1e3
        acct["speed_of_light_frac"] = efficiency(per_batch, acct)
        acct["schedule"] = args.schedule
        # a warp runs to its slowest lane under the per-thread exit: the
        # executed iterations, on the single pass only (the two-pass
        # schedules run pass 2 on a permuted or compacted batch)
        single = args.schedule == "single" or (args.schedule == "auto"
                                               and n_steps <= 36)
        if mega and single and batch % 32 == 0:
            exec_iters = warp_max_iters(res.n_iters)
            acct_exec = make(batch, n_steps - 1, n_alpha=cfg.ls_iters,
                             n_iters=exec_iters, **kw)
            acct["mean_warp_max_iters"] = exec_iters
            acct["per_executed_iter_frac"] = efficiency(per_batch, acct_exec)
        print(json.dumps(acct), flush=True)


if __name__ == "__main__":
    main()
