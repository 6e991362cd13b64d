"""Driver entry points (counterpart of the repository's `__graft_entry__.py`
for the JAX package): the flagship batched solve as a function and its
inputs, and the multi-device dryrun.

    python -c "from mpc_ros_tpu_torch import entry; entry.dryrun_multichip(4)"

Both run on the card unless the caller passes `device="cpu"`.
"""

from __future__ import annotations

import numpy as np
import torch

from .planner.tracking import resolve_device


def entry(device=None):
    """(fn, example_args): the batched NMPC solve of the flagship model.
    fn maps (z0s (B, 6), coeffs (B, 4)) to the first controls (B, 2)
    through the control-limited SQP / Riccati solve at N=30 (cap 12, the
    gated GN -> DDP backward, 4 line-search candidates): on the card one
    launch of the whole-solve kernel (K1), on the CPU the XLA lane path.
    The example batch is 128 scenarios from a generator seeded 0."""
    from .config import MPCParams, SolverConfig
    from .engine.batch import make_random_scenarios
    from .solver.batch_lane import batch_solve_lane

    dev = resolve_device(device)
    dtype = torch.float32
    cfg = SolverConfig(n_steps=30, max_sqp_iters=12, tol_grad=1e-4,
                       ddp=True, ls_iters=4)
    p = MPCParams().astype(dtype, dev)

    def fn(z0s, coeffs):
        return batch_solve_lane(z0s, coeffs, p, cfg).us[:, 0, :]

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    z0s, coeffs = make_random_scenarios(gen, 128, dtype)
    return fn, (z0s, coeffs)


def _maxdev(a, b) -> float:
    a = torch.as_tensor(a).detach().to("cpu", torch.float64)
    b = torch.as_tensor(b).detach().to("cpu", torch.float64)
    return float((a - b).abs().max())


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """Run the sharded paths on a mesh of `n_devices` entries of `device`
    (default the card; the entries may repeat one device) and hold each
    against the same solve unsharded:

    1. the data-parallel sweep (`sharded_sweep`), controls within 1e-6;
    2. the data x time horizon solve (`sharded_horizon_solve`, batch 64,
       N=30, cap 12) against the unsharded lane solve at the same
       configuration, within 5e-4 (the float32 solve noise: the time-
       sharded scan reorders every reduction);
    3. the fleet lane solve with per-robot ref_vel leaves
       (`sharded_batch_solve`), within 1e-6;
    4. warm serving (`sharded_receding_rollout`, 6 cycles), within 1e-6;
    5. the device fleet planner with `mesh=` against the unsharded one,
       command for command, within 1e-5;
    6. the device costmap -> Gaussians fit per data shard, within 1e-5;
    7. the fleet trajectory tracker's device cycle with `mesh=`, two
       cycles, within 1e-5.

    The time axis is 2 when n_devices is even and >= 4, else 1. Returns
    the deviations and statistics (also printed as one line); raises on a
    broken bound."""
    from .config import MPCParams, PlannerConfig, SolverConfig
    from .engine.batch import batch_solve, make_random_scenarios
    from .engine.receding import receding_horizon_rollout
    from .models.obstacles import ObstacleMap, fit_gaussians_to_maps
    from .parallel import (make_mesh, sharded_batch_solve,
                           sharded_horizon_solve, sharded_receding_rollout,
                           sharded_sweep)
    from .parallel.sharded import gather_rows, split_rows
    from .planner.fleet_device import DeviceFleetPlanner
    from .planner.trajectory import FleetTrajectoryTracker, TimedTrajectory
    from .sim import get_shape
    from .solver.batch_lane import batch_solve_lane

    dev = resolve_device(device)
    dtype = torch.float32
    n_time = 2 if n_devices % 2 == 0 and n_devices >= 4 else 1
    n_data = n_devices // n_time
    mesh = make_mesh(n_data=n_data, n_time=n_time,
                     devices=[dev] * (n_data * n_time))
    cfg = SolverConfig(n_steps=10, max_sqp_iters=5, tol_grad=1e-3)
    p = MPCParams().astype(dtype, dev)

    def scenarios(seed, batch):
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        return make_random_scenarios(gen, batch, dtype)

    batch = 4 * n_data
    z0s, coeffs = scenarios(0, batch)
    devs = {}

    # 1: the data-parallel sweep, statistics reduced over the shards
    parts, stats = sharded_sweep(mesh, z0s, coeffs, p, cfg)
    res = gather_rows(parts)
    assert res.us.shape == (batch, cfg.n_controls, 2)
    assert bool(torch.isfinite(stats.mean_cost))
    devs["sweep"] = _maxdev(res.us, batch_solve(z0s, coeffs, p, cfg).us)
    assert devs["sweep"] <= 1e-6, f"phase 1 sweep vs unsharded: {devs}"

    # 2: the horizon-parallel solve, data x time, at N=30, cap 12
    cfg_h = SolverConfig(n_steps=30, max_sqp_iters=12, tol_grad=1e-4,
                         horizon_parallel=True)
    batch_h = max(64, batch)
    z0h, ch = scenarios(1, batch_h)
    hs = sharded_horizon_solve(mesh, z0h, ch, p, cfg_h)
    assert hs.us.shape == (batch_h, cfg_h.n_controls, 2)
    assert bool(torch.isfinite(hs.us).all())
    hs_conv = float(hs.converged.to(dtype).mean())
    devs["horizon"] = _maxdev(hs.us, batch_solve_lane(z0h, ch, p, cfg_h).us)
    assert devs["horizon"] <= 5e-4, f"phase 2 horizon vs unsharded: {devs}"

    # 3: the fleet lane solve, per-robot leaves sliced with the batch
    p_fleet = MPCParams(ref_vel=torch.linspace(0.3, 0.7, batch)).astype(
        dtype, dev)
    fr = sharded_batch_solve(mesh, z0s, coeffs, p_fleet, cfg)
    assert bool(torch.isfinite(fr.us).all())
    devs["fleet"] = _maxdev(fr.us, batch_solve_lane(z0s, coeffs, p_fleet,
                                                    cfg).us)
    assert devs["fleet"] <= 1e-6, f"phase 3 fleet vs unsharded: {devs}"

    # 4: warm serving, a warm-start bank per shard
    tr, serve_cost, warm_iters = sharded_receding_rollout(
        mesh, z0s, coeffs, p, cfg, n_cycles=6)
    assert tr.us.shape == (6, batch, 2)
    assert bool(torch.isfinite(tr.us).all())
    devs["serving"] = _maxdev(tr.us, receding_horizon_rollout(
        z0s, coeffs, p, cfg, n_cycles=6).us)
    assert devs["serving"] <= 1e-6, f"phase 4 serving vs unsharded: {devs}"

    # 5: the device fleet planner, the whole cycle per data shard
    mesh_d = make_mesh(n_data=n_data, devices=[dev] * n_data)
    Bf = 2 * n_data
    base = get_shape("infinity")[:200]
    plans = []
    for i in range(Bf):
        pl = base.copy()
        pl[:, :2] += 3.0 * i
        plans.append(pl)
    poses = np.stack([pl[0] for pl in plans]).astype(float)
    cfg_f = SolverConfig(n_steps=10, max_sqp_iters=8, tol_grad=1e-3)
    kw = dict(params=MPCParams(), solver_cfg=cfg_f,
              planner_cfg=PlannerConfig(local_plan_length=2.5), device=dev)
    fd0 = DeviceFleetPlanner(**kw)
    fd1 = DeviceFleetPlanner(**kw, mesh=mesh_d)
    for f in (fd0, fd1):
        f.initialize(Bf)
        assert f.set_plans(plans, poses).all()
    fb = np.zeros((Bf, 2))
    _, cmd0, _ = fd0.compute_velocity_commands(poses, fb)
    _, cmd1, info1 = fd1.compute_velocity_commands(poses, fb)
    devs["device_fleet"] = float(np.max(np.abs(cmd0 - cmd1)))
    assert devs["device_fleet"] <= 1e-5, f"phase 5 device fleet: {devs}"

    # 6: the batched costmap -> Gaussians fit, per-map work per shard
    Bm, cells = 2 * n_data, 32
    xs = np.linspace(-2.0, 2.0, cells)
    X, Y = np.meshgrid(xs, xs)
    c6 = np.random.default_rng(0).uniform(-1, 1, (Bm, 2, 1, 1))
    grids = np.exp(-((X[None] - c6[:, 0]) ** 2 + (Y[None] - c6[:, 1]) ** 2)
                   / (2 * 0.3 ** 2))
    omaps = ObstacleMap(
        grid=torch.tensor(grids, dtype=dtype, device=dev),
        origin=torch.tensor([-2.0, -2.0], dtype=dtype,
                            device=dev).expand(Bm, 2),
        resolution=torch.full((Bm,), 4.0 / (cells - 1), dtype=dtype,
                              device=dev),
        weight=torch.full((Bm,), 50.0, dtype=dtype, device=dev))
    bl0 = fit_gaussians_to_maps(omaps, 4)
    bl1 = gather_rows([fit_gaussians_to_maps(m, 4)
                       for m in split_rows(mesh_d, omaps, Bm)])
    devs["costmap_fit"] = max(_maxdev(getattr(bl0, k), getattr(bl1, k))
                              for k in ("cx", "cy", "gamma", "w"))
    assert devs["costmap_fit"] <= 1e-5, f"phase 6 costmap fit: {devs}"

    # 7: the fleet trajectory tracker's device cycle per data shard
    trajs = [TimedTrajectory.from_path(pl, 0.35 + 0.01 * i)
             for i, pl in enumerate(plans)]
    kw7 = dict(kw, pipeline="device")
    ft0 = FleetTrajectoryTracker(**kw7)
    ft1 = FleetTrajectoryTracker(**kw7, mesh=mesh_d)
    for f in (ft0, ft1):
        f.set_trajectories(trajs)
    poses7 = np.stack([np.r_[t.xy[0], t.yaw[0]] for t in trajs])
    vs7 = np.zeros(Bf)
    dev7 = 0.0
    for cyc in range(2):
        cmd0t, lag0 = ft0.compute(cyc * 0.1, poses7, vs7)
        cmd1t, lag1 = ft1.compute(cyc * 0.1, poses7, vs7)
        dev7 = max(dev7, float(np.max(np.abs(cmd0t - cmd1t))),
                   float(np.max(np.abs(lag0 - lag1))))
        poses7[:, 0] += 0.1 * cmd0t[:, 0] * np.cos(poses7[:, 2])
        poses7[:, 1] += 0.1 * cmd0t[:, 0] * np.sin(poses7[:, 2])
        poses7[:, 2] += 0.1 * cmd0t[:, 1]
        vs7 = cmd0t[:, 0]
    devs["fleet_trajectory"] = dev7
    assert dev7 <= 1e-5, f"phase 7 fleet trajectory: {devs}"

    out = {"mesh": mesh.shape, "batch": batch,
           "mean_cost": float(stats.mean_cost),
           "converged": float(stats.converged_frac),
           "hsolve_conv": hs_conv, "hsolve_batch": batch_h,
           "fleet_conv": float(fr.converged.to(dtype).mean()),
           "serving_mean_cost": float(serve_cost),
           "serving_warm_iters": float(warm_iters),
           "device_fleet_conv": float(np.mean(info1.converged)),
           "max_dev_vs_unsharded": devs}
    print(f"dryrun ok: {out}", flush=True)
    return out
