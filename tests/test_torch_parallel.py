"""The port's scale-out (`parallel/`, the fleets' `mesh=`) on a mesh of CPU
entries, the counterpart of the JAX tests' 8 virtual CPU devices:

* `sharded_sweep`, `sharded_batch_solve`, `time_sharded_riccati`,
  `sharded_horizon_solve` and `sharded_receding_rollout` against JAX's own
  sharded functions on its 8-device virtual mesh (data 4 x time 2 where
  the function has a time axis) and against the port's unsharded call:
  bit for bit where each shard runs the unsharded algorithm (every
  function but the time-sharded scan), in float64; the cost and count
  statistics to 1e-12 relative of JAX's, the mean |first controls| within
  1e-8 (the noise-floor rule's floor: the two solvers' controls part at
  ~2e-10), and every statistic to 1e-12 of the same reduction of the
  port's own per-lane results; the serving rollout's mean final cost to
  1e-8 of JAX's (three closed-loop steps carry that parting), its
  iteration counts equal;
* `sharded_batch_solve` through K1's plain version (`backward="mega"`,
  two shards of 128 lanes) bit for bit against the unsharded solve;
* `FleetPlanner`, `DeviceFleetPlanner` and `FleetTrajectoryTracker` with
  `mesh=` equal to their unsharded selves over a few cycles;
* the two-process gloo sweep (`torch.multiprocessing.spawn`, 2 ranks x 2
  CPU entries; the worker is `testing.multihost_sweep_worker`), the
  counterpart of tests/test_multihost_sweep.py::test_two_process_dcn_sweep:
  both ranks report identical global statistics;
* `init_multihost` in one process, `host_local_scenarios`,
  `measure_scaling` and `make_mesh`'s rules.
"""

import dataclasses
import json
import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_ros_tpu import parallel as jpar
from mpc_ros_tpu.config import MPCParams as JMPCParams
from mpc_ros_tpu.config import SolverConfig as JSolverConfig
from mpc_ros_tpu_torch.config import MPCParams, PlannerConfig, SolverConfig
from mpc_ros_tpu_torch.engine.receding import receding_horizon_rollout
from mpc_ros_tpu_torch.parallel import (make_mesh, sharded_batch_solve,
                                        sharded_horizon_solve,
                                        sharded_receding_rollout,
                                        sharded_sweep, time_sharded_riccati)
from mpc_ros_tpu_torch.parallel.multihost import (host_local_scenarios,
                                                  init_multihost,
                                                  measure_scaling)
from mpc_ros_tpu_torch.parallel.sharded import gather_rows
from mpc_ros_tpu_torch.solver import ilqr, riccati
from mpc_ros_tpu_torch.solver.batch_lane import batch_solve_lane
from mpc_ros_tpu_torch.testing import numpy_scenarios, torch_threads

F64 = torch.float64
CPU = torch.device("cpu")
STATS = ("mean_cost", "max_cost", "converged_frac", "mean_iters",
         "mean_abs_omega0", "mean_abs_accel0")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with torch_threads(1):
        yield


def _t(a, dtype=F64):
    return torch.tensor(np.asarray(a), dtype=dtype)


def _mesh(n_data, n_time=1):
    return make_mesh(n_data=n_data, n_time=n_time,
                     devices=[CPU] * (n_data * n_time))


def _jmesh(n_data, n_time=1):
    return jpar.make_mesh(n_data=n_data, n_time=n_time,
                          devices=jax.devices()[:n_data * n_time])


def _stats_close(ours, ref, parts):
    """The cost and count statistics to 1e-12 relative of JAX's; the mean
    |first controls| within the noise-floor rule's 1e-8 (the two solvers'
    controls part at ~2e-10 on these lanes, their costs do not); every
    statistic to 1e-12 relative of the same reduction, in numpy, of the
    port's own per-lane results."""
    for k in STATS:
        a, b = float(getattr(ours, k)), float(getattr(ref, k))
        tol = 1e-8 if k.startswith("mean_abs") else 1e-12 * max(1.0, abs(b))
        assert abs(a - b) <= tol, (k, a, b)
    r = gather_rows(parts)
    own = dict(mean_cost=r.cost.mean(), max_cost=r.cost.max(),
               converged_frac=r.converged.double().mean(),
               mean_iters=r.n_iters.double().mean(),
               mean_abs_omega0=r.us[:, 0, 0].abs().mean(),
               mean_abs_accel0=r.us[:, 0, 1].abs().mean())
    for k in STATS:
        a, b = float(getattr(ours, k)), float(own[k])
        assert abs(a - b) <= 1e-12 * max(1.0, abs(b)), (k, a, b)


def _equal(a, b):
    for f in ("us", "zs", "cost", "converged", "n_iters"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f


# An interior problem set, solved tight: the port and JAX land on the same
# optimum to the last digits, so the statistics compare at 1e-12.
B = 16
CFG = dict(n_steps=8, max_sqp_iters=30, tol_grad=1e-10)


def test_sharded_sweep_matches_jax_and_unsharded():
    z0, c = numpy_scenarios(1, B)
    cfg = SolverConfig(**CFG)
    p = MPCParams().astype(F64)
    parts, stats = sharded_sweep(_mesh(8), _t(z0), _t(c), p, cfg)
    assert len(parts) == 8 and parts[0].us.shape == (2, 7, 2)
    _equal(gather_rows(parts), ilqr.solve(_t(z0), _t(c), p, cfg))
    jres, jstats = jpar.sharded_sweep(
        _jmesh(8), jnp.asarray(z0), jnp.asarray(c),
        JMPCParams().astype(jnp.float64), JSolverConfig(**CFG))
    _stats_close(stats, jstats, parts)
    np.testing.assert_array_equal(gather_rows(parts).n_iters.numpy(),
                                  np.asarray(jres.n_iters))


def test_sharded_batch_solve_matches_jax_and_unsharded():
    """Per-robot ref_vel leaves sliced with the batch (the dryrun's
    phase 3); the XLA lane path on CPU tensors."""
    z0, c = numpy_scenarios(2, B)
    cfg = SolverConfig(**CFG)
    refv = np.linspace(0.3, 0.7, B)
    p = MPCParams(ref_vel=_t(refv)).astype(F64)
    ours = sharded_batch_solve(_mesh(4), _t(z0), _t(c), p, cfg)
    _equal(ours, batch_solve_lane(_t(z0), _t(c), p, cfg))
    jp = JMPCParams(ref_vel=jnp.asarray(refv)).astype(jnp.float64)
    ref = jpar.sharded_batch_solve(_jmesh(4), jnp.asarray(z0),
                                   jnp.asarray(c), jp, JSolverConfig(**CFG))
    np.testing.assert_array_equal(ours.n_iters.numpy(),
                                  np.asarray(ref.n_iters))
    np.testing.assert_allclose(ours.us.numpy(), np.asarray(ref.us),
                               atol=1e-8)


def test_sharded_batch_solve_through_k1_plain_bit_for_bit():
    """Two shards of 128 lanes through K1's plain version at done_frac = 1
    and a warm start: a lane's result does not depend on how the lanes
    group, so the sharded solve equals the unsharded one bit for bit."""
    z0, c = numpy_scenarios(3, 256)
    cfg = SolverConfig(n_steps=10, max_sqp_iters=6, tol_grad=1e-4,
                       backward="mega")
    p = MPCParams().astype(torch.float32)
    u0 = _t(np.random.default_rng(4).normal(size=(256, 9, 2)) * 0.2,
            torch.float32)
    z, cc = _t(z0, torch.float32), _t(c, torch.float32)
    ours = sharded_batch_solve(_mesh(2), z, cc, p, cfg, u_init=u0)
    _equal(ours, batch_solve_lane(z, cc, p, cfg, u_init=u0))


def test_time_sharded_riccati_matches_jax_and_unsharded():
    rng = np.random.default_rng(0)
    Bn, T, n, m = 8, 12, 8, 2
    A = np.eye(n) + 0.1 * rng.normal(size=(Bn, T, n, n))
    Bm = 0.1 * rng.normal(size=(Bn, T, n, m))
    M = rng.normal(size=(Bn, T, n, n)) * 0.3
    l_ss = np.einsum("btij,btkj->btik", M, M) + 0.5 * np.eye(n)
    Lu = rng.normal(size=(Bn, T, m, m)) * 0.3
    l_uu = np.einsum("btij,btkj->btik", Lu, Lu) + np.eye(m)
    l_us = 0.2 * rng.normal(size=(Bn, T, m, n))
    l_s, l_u = rng.normal(size=(Bn, T, n)), rng.normal(size=(Bn, T, m))
    MT = rng.normal(size=(Bn, n, n)) * 0.3
    V_ss = np.einsum("bij,bkj->bik", MT, MT) + 0.5 * np.eye(n)
    V_s = rng.normal(size=(Bn, n))
    prob = (A, Bm, l_s, l_u, l_ss, l_uu, l_us, V_s, V_ss)
    ours = time_sharded_riccati(_mesh(4, 2), *(_t(a) for a in prob))
    ref = jpar.time_sharded_riccati(_jmesh(4, 2),
                                    *(jnp.asarray(a) for a in prob))
    flat = riccati.parallel_gains(*(_t(a) for a in prob))
    for a, b, f in zip(ours, ref, flat):
        scale = max(1.0, float(np.abs(np.asarray(b)).max()))
        assert float(np.abs(a.numpy() - np.asarray(b)).max()) <= 1e-10 * scale
        assert float((a - f).abs().max()) <= 1e-10 * scale


@pytest.mark.parametrize("saturated", [False, True])
def test_sharded_horizon_solve_matches_jax_and_unsharded(saturated):
    """tests/test_batch_parallel.py's two horizon cases in float64: the
    port's data 4 x time 2 solve against JAX's, and against the port's
    unsharded horizon-parallel solve at tests/test_riccati.py's bar."""
    kw = dict(n_steps=16, max_sqp_iters=25, tol_grad=1e-9,
              horizon_parallel=True)
    pk = dict(max_angvel=0.3, max_throttle=0.2, w_cte=300.0) if (
        saturated) else {}
    if saturated:
        rng = np.random.default_rng(5)
        c = np.stack([0.4 * rng.normal(size=B), 0.8 * rng.normal(size=B),
                      0.3 * rng.normal(size=B), np.zeros(B)], axis=-1)
        z0 = np.zeros((B, 6))
        z0[:, 4], z0[:, 5] = c[:, 0], np.arctan(c[:, 1])
    else:
        z0, c = numpy_scenarios(6, B)
    p = MPCParams(**pk).astype(F64)
    cfg = SolverConfig(**kw)
    ours = sharded_horizon_solve(_mesh(4, 2), _t(z0), _t(c), p, cfg)
    flat = ilqr.solve(_t(z0), _t(c), p, cfg)
    assert bool(ours.converged.all())
    np.testing.assert_allclose(ours.us.numpy(), flat.us.numpy(), atol=1e-6)
    if saturated:
        assert int((flat.us[..., 0].abs() > 0.3 - 1e-7).sum()) >= 10
    ref = jpar.sharded_horizon_solve(
        _jmesh(4, 2), jnp.asarray(z0), jnp.asarray(c),
        JMPCParams(**pk).astype(jnp.float64), JSolverConfig(**kw))
    np.testing.assert_allclose(ours.us.numpy(), np.asarray(ref.us),
                               atol=1e-6)


def test_sharded_receding_rollout_matches_jax_and_unsharded():
    z0, c = numpy_scenarios(7, B)
    kw = dict(n_steps=8, max_sqp_iters=30, tol_grad=1e-10)
    p = MPCParams().astype(F64)
    cfg = SolverConfig(**kw)
    tr, cost, warm = sharded_receding_rollout(_mesh(4, 2), _t(z0), _t(c), p,
                                              cfg, n_cycles=4)
    flat = receding_horizon_rollout(_t(z0), _t(c), p, cfg, n_cycles=4)
    for f in ("zs", "us", "costs", "iters"):
        assert torch.equal(getattr(tr, f), getattr(flat, f)), f
    jtr, jcost, jwarm = jpar.sharded_receding_rollout(
        _jmesh(4, 2), jnp.asarray(z0), jnp.asarray(c),
        JMPCParams().astype(jnp.float64), JSolverConfig(**kw), n_cycles=4)
    np.testing.assert_array_equal(tr.iters.numpy(), np.asarray(jtr.iters))
    # the final cycle's states went through three closed-loop steps of
    # controls that part from JAX's at the solvers' noise (~1e-10): the
    # mean final cost holds to 1e-8 relative of JAX's, and to 1e-12 of
    # the same reduction of the port's own trace
    assert abs(float(cost) - float(jcost)) <= 1e-8 * abs(float(jcost))
    own = float(tr.costs[-1].mean())
    assert abs(float(cost) - own) <= 1e-12 * abs(own)
    assert float(warm) == float(jwarm)
    assert float(warm) < float(flat.iters[0].double().mean())


# ------------------------------------------------------------------- fleets


def _fleet_setup(Bf):
    from mpc_ros_tpu_torch.testing import fleet_courses

    plans = [pl[:200] for pl in fleet_courses(Bf, offset=3.0)]
    poses = np.stack([pl[0] for pl in plans]).astype(float)
    kw = dict(params=MPCParams(), solver_cfg=SolverConfig(
        n_steps=10, max_sqp_iters=8, tol_grad=1e-3),
        planner_cfg=PlannerConfig(local_plan_length=2.5), device="cpu")
    return plans, poses, kw


@pytest.mark.parametrize("kind", ["host", "device"])
def test_fleet_planners_with_mesh_equal_unsharded(kind):
    from mpc_ros_tpu_torch.planner import DeviceFleetPlanner, FleetPlanner
    from mpc_ros_tpu_torch.testing import step_poses

    cls = FleetPlanner if kind == "host" else DeviceFleetPlanner
    Bf = 8
    plans, poses, kw = _fleet_setup(Bf)
    f0, f1 = cls(**kw), cls(**kw, mesh=_mesh(4))
    for f in (f0, f1):
        f.initialize(Bf)
        assert f.set_plans(plans, poses).all()
    fb = np.zeros((Bf, 2))
    for _ in range(3):
        assert (f0.is_goal_reached(poses, fb)
                == f1.is_goal_reached(poses, fb)).all()
        ok0, cmd0, info0 = f0.compute_velocity_commands(poses, fb)
        ok1, cmd1, info1 = f1.compute_velocity_commands(poses, fb)
        np.testing.assert_array_equal(cmd0, cmd1)
        np.testing.assert_array_equal(info0.n_iters, info1.n_iters)
        fb = step_poses(poses, cmd0, 0.1)
    sd0, sd1 = f0.state_dict(), f1.state_dict()
    for k in sd0:
        np.testing.assert_array_equal(np.asarray(sd0[k]), np.asarray(sd1[k]))


def test_fleet_trajectory_tracker_with_mesh_equals_unsharded():
    from mpc_ros_tpu_torch.planner.trajectory import (FleetTrajectoryTracker,
                                                      TimedTrajectory)

    Bt = 8
    plans, _, kw = _fleet_setup(Bt)
    trajs = [TimedTrajectory.from_path(pl, 0.35 + 0.01 * i)
             for i, pl in enumerate(plans)]
    kw = dict(kw, pipeline="device")
    t0 = FleetTrajectoryTracker(**kw)
    t1 = FleetTrajectoryTracker(**kw, mesh=_mesh(4))
    poses = np.stack([np.r_[t.xy[0], t.yaw[0]] for t in trajs])
    vs = np.zeros(Bt)
    for f in (t0, t1):
        f.set_trajectories(trajs)
    for cyc in range(3):
        cmd0, lag0 = t0.compute(cyc * 0.1, poses, vs)
        cmd1, lag1 = t1.compute(cyc * 0.1, poses, vs)
        np.testing.assert_array_equal(cmd0, cmd1)
        np.testing.assert_array_equal(lag0, lag1)
        poses[:, 0] += 0.1 * cmd0[:, 0] * np.cos(poses[:, 2])
        poses[:, 1] += 0.1 * cmd0[:, 0] * np.sin(poses[:, 2])
        poses[:, 2] += 0.1 * cmd0[:, 1]
        vs = cmd0[:, 0]
    with pytest.raises(AssertionError):
        FleetTrajectoryTracker(**dict(kw, pipeline="host"), mesh=_mesh(2))


# ------------------------------------------------------------- multi-process


def test_two_process_gloo_sweep(tmp_path):
    """Two OS processes, each a mesh of 2 CPU entries, one gloo group:
    init_multihost -> host_local_scenarios -> sharded_sweep, the
    statistics all-reduced across the processes. Both ranks report
    identical global statistics, from different local scenarios."""
    import torch.multiprocessing as mp

    from mpc_ros_tpu_torch.testing import multihost_sweep_worker

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    mp.spawn(multihost_sweep_worker, args=(port, str(tmp_path)), nprocs=2,
             join=True)
    outs = [json.loads((tmp_path / f"rank{r}.json").read_text())
            for r in range(2)]
    assert outs[0]["topology"]["processes"] == 2
    assert [o["topology"]["process_index"] for o in outs] == [0, 1]
    assert outs[0]["local_batch"] == 16 and outs[0]["shards"] == 2
    assert outs[0]["z0_first"] != outs[1]["z0_first"]
    for k in STATS:
        assert outs[0][k] == outs[1][k], k
    assert outs[0]["converged_frac"] > 0.9


def test_single_process_topology_and_local_scenarios():
    topo = init_multihost(device="cpu")
    assert topo["processes"] == 1 and topo["process_index"] == 0
    mesh, z0s, coeffs = host_local_scenarios(0, 64, F64, device="cpu",
                                             devices=[CPU] * 8)
    assert mesh.shape == {"data": 8, "time": 1}
    assert z0s.shape == (64, 6) and coeffs.shape == (64, 4)
    _, z1, _ = host_local_scenarios(0, 64, F64, device="cpu",
                                    devices=[CPU] * 8)
    assert torch.equal(z0s, z1)


def test_measure_scaling_runs_and_reports():
    rows = measure_scaling([1, 2, 4, 16], global_batch_per_device=4,
                           n_steps=8, dtype=F64, repeats=1,
                           devices=[CPU] * 4)
    assert [r["n_devices"] for r in rows] == [1, 2, 4]
    for r in rows:
        assert r["solves_per_s"] > 0 and np.isfinite(r["efficiency"])


def test_make_mesh_rules():
    mesh = _mesh(2, 2)
    assert mesh.shape == {"data": 2, "time": 2}
    assert mesh.data_devices() == [CPU, CPU]
    with pytest.raises(ValueError):
        make_mesh(n_data=3, n_time=2, devices=[CPU] * 4)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            make_mesh()
    with pytest.raises(ValueError):
        sharded_batch_solve(_mesh(3), torch.zeros(4, 6, dtype=F64),
                            torch.zeros(4, 4, dtype=F64),
                            MPCParams().astype(F64), SolverConfig(n_steps=6))
    assert dataclasses.is_dataclass(mesh)


def test_partitions_split_or_replicate():
    from mpc_ros_tpu_torch.parallel import batch_sharding, replicated
    from mpc_ros_tpu_torch.parallel.sharded import split_rows

    mesh = _mesh(2)
    x = torch.arange(8.0).reshape(4, 2)
    p = MPCParams(ref_vel=torch.arange(4.0))
    for where in (mesh, batch_sharding(mesh)):
        parts = split_rows(where, {"x": x, "s": torch.ones(3)}, 4)
        assert [q["x"].shape[0] for q in parts] == [2, 2]
        assert torch.equal(parts[1]["x"], x[2:]) and parts[1]["s"].shape == (3,)
        assert torch.equal(split_rows(where, p, 4)[1].ref_vel,
                           torch.tensor([2.0, 3.0]))
    whole = split_rows(replicated(mesh), x, 4)
    assert len(whole) == 2 and all(torch.equal(w, x) for w in whole)
    assert torch.equal(gather_rows(split_rows(mesh, x, 4)), x)
