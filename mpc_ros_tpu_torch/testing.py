"""Seeded numpy inputs for holding the port against the JAX package.

The two packages draw different numbers from their generators, so a
comparison makes its inputs once with numpy and hands the same arrays to
both. The scenarios' distributions are those of `make_random_scenarios`;
the blob fields are `bench.py`'s obstacle layout and the setpoint
profiles a ramp plus noise, as the JAX package's trajectory-tracking tests
draw them.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from .config import WEIGHT_NAMES


@contextlib.contextmanager
def torch_threads(n: int):
    """Run the block with n intra-op threads, restoring the count after.
    The comparisons run thousands of small ops, often in several test
    processes at once, where one thread each beats pools that
    oversubscribe the cores."""
    old = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(old)


@contextlib.contextmanager
def k1_grid(slots: int):
    """K1's launches inside on a persistent grid of `slots` threads (a
    multiple of 128 no larger than the card holds at once), or one thread
    per lane (0), whatever the launcher's rule would pick, to hold the two
    against each other."""
    from .kernels import solve_mega

    rule = solve_mega._grid_choice
    solve_mega._grid_choice = lambda kn, B, dev: (None, slots)
    try:
        yield
    finally:
        solve_mega._grid_choice = rule


def numpy_scenarios(seed: int, batch: int, pose_scale: float = 0.3,
                    curve_scale: float = 0.25):
    """z0s (B, 6) and coeffs (B, 4) as float64 numpy arrays."""
    rng = np.random.default_rng(seed)
    B = batch
    coeffs = rng.normal(size=(B, 4)) * np.array([0.1, 0.2, curve_scale,
                                                 0.05])
    v0 = rng.uniform(0.0, 0.8, size=B)
    cte = coeffs[:, 0] + rng.normal(size=B) * pose_scale * 0.3
    etheta = np.arctan(coeffs[:, 1]) + rng.normal(size=B) * 0.2
    zeros = np.zeros(B)
    z0s = np.stack([zeros, zeros, zeros, v0, cte, etheta], axis=-1)
    return z0s, coeffs


def scaled_weights(defaults: dict, batch: int,
                   factors=(0.5, 1.0, 4.0)) -> dict:
    """Per-lane (B,) weight leaves: every weight of lane i scaled by
    factors[i % len(factors)] (exercises the adaptive weight scale)."""
    f = np.resize(np.asarray(factors, np.float64), batch)
    return {k: np.asarray(defaults[k], np.float64) * f for k in WEIGHT_NAMES}


def numpy_blobs(seed: int, batch: int, n_blobs: int = 4):
    """A blob field per lane in `bench.py`'s obstacle layout: one live blob
    with its centre uniform in [0.3, 1.2]^2, then n_blobs - 1 inert blobs at
    (50, 50); sigma 0.3 and weight 100 for all. Returns (cx, cy, sigma, w),
    each (B, K) float64, for `GaussianObstacles.from_sigmas`."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(0.3, 1.2, size=(batch, 2))
    far = np.full((batch, n_blobs - 1), 50.0)
    cx = np.concatenate([centers[:, :1], far], axis=1)
    cy = np.concatenate([centers[:, 1:], far], axis=1)
    return (cx, cy, np.full((batch, n_blobs), 0.3),
            np.full((batch, n_blobs), 100.0))


def numpy_refs(seed: int, batch: int, n_steps: int, noise: float = 0.1,
               ref_vel: float = 0.5):
    """Per-lane (ref_cte, ref_etheta, ref_vel) setpoint profiles (B, N, 3),
    float64: a speed ramp from ref_vel + 0.2 down to ref_vel - 0.3 with a
    small sinusoidal cte setpoint, plus seeded Gaussian noise of scale
    `noise` per knot and lane (`noise=0` gives the ramp alone)."""
    rng = np.random.default_rng(seed)
    t = np.linspace(0.0, 1.0, n_steps)
    base = np.stack([0.02 * np.sin(2.0 * np.pi * t), np.zeros_like(t),
                     ref_vel + 0.2 - 0.5 * t], axis=-1)
    return base[None] + noise * rng.normal(size=(batch, n_steps, 3))


# Entries planted by `plant_nonfinite`, one kind per lane in turn: (input
# name, index before the lane axis from the input's shape, value).
_PLANTS = (
    ("ss", lambda a: (a.shape[0] // 2, 3), float("nan")),
    ("ks", lambda a: (min(1, a.shape[0] - 1), 0), float("inf")),
    ("Ks", lambda a: (a.shape[0] // 3, 1, 4), float("nan")),
    ("coeffs", lambda a: (min(2, a.shape[0] - 1),), float("inf")),
    ("z", lambda a: (3,), float("nan")),
    ("ss", lambda a: (a.shape[0] - 1, 2), float("-inf")),
    ("coeffs", lambda a: (a.shape[0] - 1,), 1e30),
)


def plant_nonfinite(named: dict, lanes) -> dict:
    """Copies of the batch-last tensors in `named` (any of ss, ks, Ks,
    coeffs, z: the initial state) with one entry of each given lane set to
    NaN, +-inf, or 1e30 in the leading coefficient (finite, but its
    rollouts overflow), the kinds that apply taken in turn."""
    out = {k: v.clone() for k, v in named.items()}
    kinds = [p for p in _PLANTS if p[0] in out]
    for i, lane in enumerate(lanes):
        name, where, value = kinds[i % len(kinds)]
        out[name][where(out[name]) + (int(lane),)] = value
    return out


# A lane that is done while its finite trajectory leads its next backward
# to overflow float32 (ROADMAP Queue 3 item 7): in numpy_scenarios(3, 128)
# at N=12, lane 31 started at v0 = 2.14926252e6 converges in one iteration,
# and the backward of the trajectory its accepted step leaves has
# non-finite gains, so the plain version's act = 0 blend turns it to NaN
# while the other lanes run.
WITNESS_SEED, WITNESS_LANE, WITNESS_V0 = 3, 31, 2.14926252e6


def next_backward_witness(dtype=torch.float32, device=None,
                          done_frac: float = 1.0):
    """(zT, cT, pp, lb, ub, u0) and the SolverConfig of the witness: one
    block of 128 lanes, N=12, cap 12, tol_grad 1e-4, default weights,
    controls boxed to [-1, 1], a zero cold start."""
    from .config import MPCParams, SolverConfig
    from .kernels.pack import pack_params

    B, n = 128, 12
    z0, coeffs = numpy_scenarios(WITNESS_SEED, B)
    z0[WITNESS_LANE, 3] = WITNESS_V0
    lb = torch.full((2, B), -1.0, dtype=dtype, device=device)
    ins = (torch.tensor(z0.T, dtype=dtype, device=device),
           torch.tensor(coeffs.T, dtype=dtype, device=device),
           pack_params(MPCParams(), B, dtype, device), lb, -lb,
           torch.zeros(n - 1, 2, B, dtype=dtype, device=device))
    return ins, SolverConfig(n_steps=n, max_sqp_iters=12, tol_grad=1e-4,
                             done_frac=done_frac)


def nonfinite_agreement(kernel, plain, clean, lanes, tol: float) -> dict:
    """A kernel against its plain version on inputs with planted lanes
    (`plant_nonfinite`), output by output (each with the batch last): on
    the planted lanes NaN where the plain version has NaN, the same
    infinities, and the finite values within tol * (1 + |plain|); on every
    other lane the kernel's outputs equal its outputs on the clean inputs
    bit for bit. `ok` holds all of it."""
    dev = plain[0].device
    idx = torch.as_tensor([int(i) for i in lanes], device=dev)
    others = torch.ones(plain[0].shape[-1], dtype=torch.bool, device=dev)
    others[idx] = False
    rec = {"nan_pattern": True, "inf_pattern": True, "max_rel": 0.0,
           "others_unchanged": True}
    with_nan = torch.zeros(len(idx), dtype=torch.bool, device=dev)
    for k_all, p_all, c_all in zip(kernel, plain, clean):
        k, p = k_all[..., idx].double(), p_all[..., idx].double()
        rec["nan_pattern"] &= bool(torch.equal(k.isnan(), p.isnan()))
        inf = p.isinf()
        rec["inf_pattern"] &= bool(torch.equal(k.isinf(), inf)
                                   and torch.equal(k[inf], p[inf]))
        fin = p.isfinite() & k.isfinite()
        if bool(fin.any()):
            rel = ((k - p).abs() / (1.0 + p.abs()))[fin]
            rec["max_rel"] = max(rec["max_rel"], float(rel.max()))
        with_nan |= p.isnan().reshape(-1, len(idx)).any(dim=0)
        rec["others_unchanged"] &= bool(torch.equal(k_all[..., others],
                                                    c_all[..., others]))
    rec["planted_lanes_with_nan"] = int(with_nan.sum())
    rec["tol"] = tol
    rec["ok"] = (rec["nan_pattern"] and rec["inf_pattern"]
                 and rec["max_rel"] <= tol and rec["others_unchanged"])
    return rec


def fleet_courses(batch: int, shapes=("infinity",), offset: float = 10.0,
                  period: int = 0, stagger: int = 0) -> list:
    """Plans for a fleet: robot i drives the course shapes[i % len(shapes)]
    (`sim.get_shape`, (M, 3) with headings) moved by offset * (i % period)
    in x and in y (period 0: by offset * i), with stagger * (i % 3) knots
    cut from its end (plans of unequal lengths exercise the padding)."""
    from .sim import get_shape

    plans = []
    for i in range(batch):
        plan = get_shape(shapes[i % len(shapes)]).copy()
        plan[:, :2] += offset * (i % period if period else i)
        plans.append(plan[: len(plan) - stagger * (i % 3)])
    return plans


def step_poses(poses: np.ndarray, cmds: np.ndarray, dt: float,
               lf=None) -> np.ndarray:
    """The kinematic plant one control period on, in place: poses (B, 3)
    driven by cmds (B, 2) = (v, u0), u0 the yaw rate (diff drive) or, with
    a wheelbase `lf`, the steering angle (bicycle: yaw rate v / lf u0).
    Returns the (B, 2) feedback (v, yaw rate)."""
    v = cmds[:, 0]
    w = cmds[:, 1] if lf is None else v / lf * cmds[:, 1]
    poses[:, 0] += v * np.cos(poses[:, 2]) * dt
    poses[:, 1] += v * np.sin(poses[:, 2]) * dt
    poses[:, 2] += w * dt
    return np.stack([v, w], axis=1)


def lockstep_cycles(controllers, cycles: int, plan=None, traj=None,
                    events=None) -> list:
    """Drive single-robot controllers through the same cycles: either
    `MPCPlanner`s on `plan` (M, 3), or `TrajectoryTracker`s on the
    `TimedTrajectory` `traj` (t_now = k dt). The first controller's
    commands move a kinematic plant; every controller gets the same pose
    and feedback each cycle. `events` maps a cycle index to a callable
    applied to each controller before that cycle (a parameter reload, a
    new costmap). Returns per controller a list of per-cycle records:
    the command, the FSM state (planners), the solver's host reads
    (`ilqr.host_reads`), and the solve's us, zs, cost and iterations
    (None on a cycle without a solve)."""
    from .sim import make_plant
    from .solver import ilqr

    first = controllers[0]
    params = first.params if plan is not None else first._np_params
    dt = float(np.max(np.asarray(params.to_numpy()["dt"])))
    start = plan[0] if plan is not None else np.array(
        [traj.xy[0, 0], traj.xy[0, 1], traj.yaw[0]])
    plant = make_plant(first.solver_cfg.model, np.array(start, float), dt,
                       params)
    if plan is not None:
        for c in controllers:
            c.set_plan(plan, plant.pose)
    else:
        for c in controllers:
            c.set_trajectory(traj)
    out = [[] for _ in controllers]
    for k in range(cycles):
        for c in controllers:
            if events and k in events:
                events[k](c)
        cmd0 = None
        for c, rec in zip(controllers, out):
            reads = ilqr.host_reads
            if plan is not None:
                _, cmd, info = c.compute_velocity_commands(
                    plant.pose.copy(), plant.feedback_vel)
                solve = None if info.tracking is None else \
                    info.tracking.solve
                state = info.state.value
            else:
                cmd, dbg = c.compute(k * dt, plant.pose.copy(),
                                     plant.feedback_vel[0])
                solve, state = dbg.solve, None
            rec.append(dict(
                cmd=np.asarray(cmd, float), state=state,
                reads=ilqr.host_reads - reads,
                solve=None if solve is None else dict(
                    us=np.asarray(solve.us), zs=np.asarray(solve.zs),
                    cost=float(solve.cost), iters=int(solve.n_iters))))
            cmd0 = cmd if cmd0 is None else cmd0
        plant.step(*cmd0)
    return out


def records_equal(a: list, b: list) -> dict:
    """Bit-for-bit agreement of two `lockstep_cycles` records (their host
    reads equal too): the cycles compared, the first cycle that differs
    (None) and the largest difference of commands and controls."""
    first, dmax = None, 0.0
    for k, (ra, rb) in enumerate(zip(a, b)):
        same = (np.array_equal(ra["cmd"], rb["cmd"])
                and ra["state"] == rb["state"] and ra["reads"] == rb["reads"]
                and (ra["solve"] is None) == (rb["solve"] is None))
        d = float(np.max(np.abs(ra["cmd"] - rb["cmd"])))
        if same and ra["solve"] is not None:
            sa, sb = ra["solve"], rb["solve"]
            same = (np.array_equal(sa["us"], sb["us"])
                    and np.array_equal(sa["zs"], sb["zs"])
                    and sa["cost"] == sb["cost"]
                    and sa["iters"] == sb["iters"])
            d = max(d, float(np.max(np.abs(sa["us"] - sb["us"]))))
        dmax = max(dmax, d)
        if not same and first is None:
            first = k
    return dict(cycles=min(len(a), len(b)), first_diff=first,
                max_abs_diff=dmax, equal=first is None and len(a) == len(b))


def multihost_sweep_worker(rank: int, port: int, out_dir: str) -> None:
    """One rank of the two-process gloo sweep (run by
    `torch.multiprocessing.spawn`): `init_multihost` on the CPU, this
    rank's scenarios from `host_local_scenarios` on a mesh of two CPU
    entries, `sharded_sweep`, and the global statistics written to
    `<out_dir>/rank<rank>.json`."""
    import json
    import os

    from .config import MPCParams, SolverConfig
    from .parallel.multihost import host_local_scenarios, init_multihost
    from .parallel.sharded import sharded_sweep

    torch.set_num_threads(1)
    topo = init_multihost(f"127.0.0.1:{port}", num_processes=2,
                          process_id=rank, device="cpu")
    cpu = torch.device("cpu")
    cfg = SolverConfig(n_steps=8, max_sqp_iters=6, tol_grad=1e-3)
    p = MPCParams().astype(torch.float32)
    mesh, z0s, coeffs = host_local_scenarios(0, 32, torch.float32,
                                             device=cpu, devices=[cpu] * 2)
    res, stats = sharded_sweep(mesh, z0s, coeffs, p, cfg)
    out = {"topology": topo, "local_batch": int(z0s.shape[0]),
           "shards": len(res), "z0_first": z0s[0].tolist()}
    out.update({k: float(getattr(stats, k)) for k in (
        "mean_cost", "max_cost", "converged_frac", "mean_iters",
        "mean_abs_omega0", "mean_abs_accel0")})
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    torch.distributed.destroy_process_group()


def shm_publish(name: str, n: int) -> None:
    """Attach to the shared-memory topic `name` and publish n 64-byte
    payloads, each the 8-byte counter repeated 8 times (a torn read shows
    mixed words): the other process of the cross-process topic test."""
    import struct

    from .native import ShmTopic

    t = ShmTopic(name)
    for i in range(1, n + 1):
        t.publish(struct.pack("<8Q", *([i] * 8)))
    t.close()


def node_over_shm(prefix: str, seconds: float) -> None:
    """A `PlannerNode` with the port's planner on the CPU serving over the
    shared-memory topics `<prefix>_pose`, `_fb`, `_cmd` and `_traj` until
    a payload arrives on `<prefix>_stop`, or for at most `seconds`: the
    planner process of the cross-process node test."""
    import time

    from .config import MPCParams, PlannerConfig, SolverConfig
    from .native import ShmTopic
    from .planner import MPCPlanner
    from .planner.node import PlannerNode

    torch.set_num_threads(1)
    topics = {"pose": ShmTopic(prefix + "_pose"),
              "feedback": ShmTopic(prefix + "_fb"),
              "cmd": ShmTopic(prefix + "_cmd"),
              "traj": ShmTopic(prefix + "_traj")}
    stop = ShmTopic(prefix + "_stop")
    p = MPCParams(dt=0.05, ref_vel=0.5, w_cte=300.0)
    planner = MPCPlanner(params=p,
                         solver_cfg=SolverConfig(n_steps=10, backward="xla"),
                         planner_cfg=PlannerConfig(local_plan_length=2.0),
                         device="cpu")
    planner.initialize()
    node = PlannerNode(planner, period_s=0.02, topics=topics)
    xs = np.linspace(0, 5.0, 100)
    plan = np.stack([xs, np.zeros(100), np.zeros(100)], axis=1)
    assert node.set_plan(plan)
    node.start()
    t_end = time.time() + seconds
    while time.time() < t_end and stop.read() is None:
        time.sleep(0.05)
    assert node.stop()
    for t in (*topics.values(), stop):
        t.close()
    print("cycles", node.cycles, "errors", node.errors, flush=True)
