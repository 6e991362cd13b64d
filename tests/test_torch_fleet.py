"""The port's host-pipeline fleet (`FleetPlanner`) against the JAX
package's, on the CPU.

In float64 both fleets solve on the XLA lane path: fed the same pose
stream, the commands agree within max(1e-8, twice the port's response to a
one-ulp change of the poses) every cycle (ROADMAP Queue 3 item 5), and the
FSM states, cursors and goal latches are equal — over 30 cycles on the
three courses, with the bicycle, with world-frame blobs and with per-robot
throttle leaves. On degenerate plans alone, a robot beyond that bar may be
a tie: its solve cost equal on both sides within 1e-12 relative, in the
same iterations, and its commands within 1e-6. A degenerate zigzag plan's
solve has a flat optimum: on identical inputs the two solvers end 1.07e-8
apart in the controls at costs 2e-16 apart, and no one-ulp change of its
inputs moves the port's answer. That test starts every cycle from the JAX
fleet's state, so the parting does not carry into the next. Then the JAX tests' own checks
on the port: robot by robot equal to the port's `MPCPlanner` (5e-3), goal
latching and idle commands, pipelined `begin_cycle`/`finish_cycle` equal to
sequential calls, checkpoints crossing between the two packages, and the
planner keeping a device mesh.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_ros_tpu.config import MPCParams as JMPCParams
from mpc_ros_tpu.config import PlannerConfig as JPlannerConfig
from mpc_ros_tpu.config import SolverConfig as JSolverConfig
from mpc_ros_tpu.models.obstacles import GaussianObstacles as JBlobs
from mpc_ros_tpu.planner import FleetPlanner as JFleet
from mpc_ros_tpu_torch.config import MPCParams, PlannerConfig, SolverConfig
from mpc_ros_tpu_torch.models.obstacles import GaussianObstacles
from mpc_ros_tpu_torch.planner import FleetPlanner, MPCPlanner
from mpc_ros_tpu_torch.testing import fleet_courses, step_poses, torch_threads

# tests/test_fleet.py's fleet
LEAVES = dict(max_angvel=1.5, w_cte=300.0, w_angvel_d=10.0, w_accel_d=10.0)
PLAN = dict(local_plan_length=2.5)
N = 20
COURSES = ("infinity", "epitrochoid", "square")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these tests run many small ops, and the suite
    runs in several processes at once (`testing.torch_threads`)."""
    with torch_threads(1):
        yield


def _pair(leaves=None, solver=None, planner=None, B=6, dtype="float64"):
    leaves = dict(LEAVES if leaves is None else leaves)
    solver = dict(n_steps=N) if solver is None else solver
    planner = PLAN if planner is None else planner
    jleaves = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
               for k, v in leaves.items()}
    ref = JFleet(JMPCParams(**jleaves), JSolverConfig(**solver),
                 JPlannerConfig(**planner), dtype=getattr(jnp, dtype))
    ours = FleetPlanner(MPCParams(**leaves), SolverConfig(**solver),
                        PlannerConfig(**planner), dtype=getattr(torch, dtype),
                        device="cpu")
    ref.initialize(B)
    ours.initialize(B)
    return ours, ref


def _ulp_response(ours, sd, poses, fb, cmds, blobs=None):
    """The largest command change of the port's cycle from the state `sd`
    when the poses move by one ulp (two random sign patterns): the f64
    noise floor of that cycle."""
    worst = 0.0
    for k in range(2):
        twin = FleetPlanner(ours.params, ours.solver_cfg, ours.planner_cfg,
                            dtype=ours.dtype, device="cpu")
        twin.initialize(ours.B)
        twin.load_state_dict(sd)
        twin.set_obstacles(blobs)
        flip = np.random.default_rng(100 + k).choice([-1.0, 1.0],
                                                     size=poses.shape)
        _, c, _ = twin.compute_velocity_commands(
            poses * (1.0 + 2.0 ** -52 * flip), fb)
        worst = max(worst, float(np.abs(c - cmds).max()))
    return worst


def _drive(ours, ref, plans, poses, cycles, lf=None, noise=None, blobs=None,
           resync=False, ties=False):
    """Both fleets on the JAX fleet's pose stream: states, cursors and
    latches equal, commands within max(1e-8, twice the one-ulp response)
    every cycle. `ties`: a robot beyond that bar passes if its costs agree
    within 1e-12 relative and its commands within 1e-6 (degenerate plans
    only). `resync`: the JAX fleet's state is loaded into the port's
    before every cycle, so each cycle starts from identical states.
    Returns the JAX commands of the last cycle."""
    assert (ours.set_plans(plans, poses) == ref.set_plans(plans, poses)).all()
    fb = np.zeros((ours.B, 2))
    rng = np.random.default_rng(7)
    for cyc in range(cycles):
        seen = poses if noise is None else poses + rng.normal(
            0, noise, poses.shape)
        if resync:
            ours.load_state_dict(ref.state_dict())
        sd = ours.state_dict()
        ok_j, c_j, i_j = ref.compute_velocity_commands(seen, fb)
        ok_t, c_t, i_t = ours.compute_velocity_commands(seen, fb)
        np.testing.assert_array_equal(ok_t, ok_j)
        np.testing.assert_array_equal(i_t.states, i_j.states, f"{cyc}")
        for k in ("_start", "latch_xy", "latch_yaw", "set_new_goal",
                  "_has_warm"):
            np.testing.assert_array_equal(getattr(ours, k), getattr(ref, k),
                                          f"cycle {cyc}: {k}")
        np.testing.assert_array_equal(i_t.converged, i_j.converged)
        np.testing.assert_array_equal(i_t.n_iters, i_j.n_iters)
        assert np.isfinite(c_t).all()
        d = np.abs(c_t - c_j).max(axis=1)
        if d.max() > 1e-8:
            ulp = _ulp_response(ours, sd, seen, fb, c_t, blobs)
            over = d > max(1e-8, 2.0 * ulp)
            if not ties:
                assert not over.any(), (cyc, d, ulp)
            rel = np.abs(i_t.cost - i_j.cost) / (1.0 + np.abs(i_j.cost))
            assert (rel[over] <= 1e-12).all() and (d[over] <= 1e-6).all(), (
                cyc, d, ulp, rel)
        fb = step_poses(poses, c_j, 0.1, lf)
    return c_j


def test_fleet_matches_jax_on_three_courses():
    """6 robots on the three courses (offset copies), 30 cycles in f64."""
    ours, ref = _pair()
    plans = fleet_courses(6, COURSES)
    poses = np.stack([p[0] for p in plans])
    _drive(ours, ref, plans, poses, 30)
    # every robot tracked through one batched solve
    assert ours._has_warm.all()


def test_bicycle_fleet_matches_jax():
    """The Ackermann family, stage (g) on the card: (v, delta) commands
    against bicycle plants, 12 cycles in f64."""
    leaves = dict(LEAVES, lf=0.25, max_steer=0.6)
    ours, ref = _pair(leaves, dict(n_steps=N, model="bicycle"), B=2)
    plans = fleet_courses(2, offset=20.0)
    poses = np.stack([p[0] for p in plans])
    _drive(ours, ref, plans, poses, 12, lf=0.25)


def test_world_obstacles_match_jax():
    """World-frame per-robot blobs through the batched frame transform
    (stage (e) on the card): robot 0 has a blob on its path, its twin one
    far away; 10 cycles in f64, and the blob changes robot 0's commands."""
    n = 100
    plan = np.stack([np.linspace(0, 6, n), np.zeros(n), np.zeros(n)], 1)
    leaves = dict(dt=0.1, ref_vel=0.5, max_angvel=1.5, w_angvel_d=10.0,
                  w_accel_d=10.0)
    ours, ref = _pair(leaves, B=2)
    arrays = ([[1.2], [50.0]], [[0.05], [50.0]], [[0.3], [0.3]],
              [[50.0], [50.0]])
    ref.set_obstacles(JBlobs.from_sigmas(*(jnp.asarray(a) for a in arrays)))
    blobs = GaussianObstacles.from_sigmas(*(torch.tensor(a)
                                            for a in arrays))
    ours.set_obstacles(blobs)
    poses = np.stack([plan[0], plan[0]])
    c = _drive(ours, ref, [plan, plan.copy()], poses, 10, blobs=blobs)
    assert np.abs(c[0] - c[1]).max() > 1e-3, c


def test_per_robot_throttle_scheduling():
    """(B,) MPCParams leaves apply per robot in the host schedulers: the
    low-throttle robot brakes, its twin at the same distance does not; the
    same on the JAX fleet."""
    n = 40
    plan = np.stack([np.linspace(0, 3, n), np.zeros(n), np.zeros(n)], 1)
    ours, ref = _pair(dict(max_throttle=np.array([0.5, 2.0]), ref_vel=0.5),
                      B=2)
    poses = np.array([[2.7, 0.0, 0.0], [2.7, 0.0, 0.0]])
    for fp in (ours, ref):
        assert fp.set_plans([plan, plan.copy()], poses).all()
    fb = np.array([[0.5, 0.0], [0.5, 0.0]])
    _, c_t, info = ours.compute_velocity_commands(poses, fb)
    _, c_j, info_j = ref.compute_velocity_commands(poses, fb)
    assert abs(info.ref_vel[0] - 0.15) < 1e-9, info.ref_vel
    assert abs(info.ref_vel[1] - 0.5) < 1e-9, info.ref_vel
    np.testing.assert_array_equal(info.ref_vel, info_j.ref_vel)
    assert np.abs(c_t - c_j).max() <= 1e-8


def _degenerate_plans(rng):
    def plan(kind):
        if kind == 0:
            return np.array([[1.0, 1.0, 0.5]])
        if kind == 1:
            return np.array([[1.0, 1.0, 0.5], [1.0, 1.0, 0.5]])
        if kind == 2:     # duplicated waypoints (zero-length segments)
            pts = np.repeat(np.cumsum(rng.normal(0, 0.2, (10, 2)), 0), 2,
                            axis=0)
            return np.concatenate([pts, np.zeros((len(pts), 1))], 1)
        if kind == 3:     # 2 columns (tangent yaws synthesized)
            return np.cumsum(rng.normal(0, 0.3, (15, 2)), 0)
        if kind == 4:
            pts = np.cumsum(rng.normal(0, 0.3, (40, 2)), 0)
            return np.concatenate([pts, np.zeros((40, 1))], 1)
        if kind == 5:     # zigzag: direction reversals
            x = np.arange(20) * 0.2
            y = np.where(np.arange(20) % 2 == 0, 0.0, 0.5)
            return np.stack([x, y, np.zeros(20)], 1)
        return np.array([[0.0, 0.0, 0.0], [5.0, 0.0, 0.0]])

    return [plan(i % 7) for i in range(14)]


@pytest.mark.parametrize("slow", [False, True], ids=["plain", "curvature"])
def test_degenerate_plans_match_jax(slow):
    """Fleets mixing degenerate plans (a single point, duplicate
    waypoints, 2-column, zigzag reversals, long jumps) give finite
    commands equal to the JAX fleet's, with and without the curvature
    scheduler, under pose noise (tests/test_fleet.py's fuzz); each cycle
    from the JAX fleet's state."""
    plans = _degenerate_plans(np.random.default_rng(0))
    ours, ref = _pair(dict(), dict(n_steps=10, max_sqp_iters=6,
                                   backward="xla"),
                      dict(curvature_slowdown=slow), B=14)
    poses = np.stack([np.array([p[0, 0], p[0, 1],
                                p[0, 2] if p.shape[1] >= 3 else 0.0])
                      for p in plans])
    _drive(ours, ref, plans, poses, 10, noise=0.05, resync=True,
           ties=True)


def test_fleet_matches_its_own_single_planner():
    """Robot by robot equal to the port's `MPCPlanner` on the single
    planner's pose stream (float32, tests/test_fleet.py's 5e-3), and the
    offset twin gives the same commands."""
    from mpc_ros_tpu_torch.sim import get_shape

    plan = get_shape("infinity")
    params = MPCParams(**LEAVES)
    single = MPCPlanner(params, SolverConfig(n_steps=N),
                        PlannerConfig(**PLAN), device="cpu")
    single.initialize()
    fp = FleetPlanner(params, SolverConfig(n_steps=N), PlannerConfig(**PLAN),
                      device="cpu")
    fp.initialize(2)
    off = np.array([50.0, 50.0, 0.0])
    pose = plan[0].copy()
    plan2 = plan.copy()
    plan2[:, :2] += 50.0
    assert single.set_plan(plan, pose)
    assert fp.set_plans([plan, plan2], np.stack([pose, pose + off])).all()
    vw = np.zeros(2)
    for cyc in range(30):
        ok1, (v1, w1), _ = single.compute_velocity_commands(pose, tuple(vw))
        okf, cmds, _ = fp.compute_velocity_commands(
            np.stack([pose, pose + off]), np.stack([vw, vw]))
        assert ok1 and okf.all()
        assert abs(cmds[0, 0] - v1) < 5e-3, (cyc, cmds[0], (v1, w1))
        assert abs(cmds[0, 1] - w1) < 5e-3, (cyc, cmds[0], (v1, w1))
        np.testing.assert_allclose(cmds[1], cmds[0], atol=5e-3)
        pose = pose + np.array([v1 * np.cos(pose[2]) * 0.1,
                                v1 * np.sin(pose[2]) * 0.1, w1 * 0.1])
        vw = np.array([v1, w1])


def test_goal_latching_and_idle_commands():
    """A robot at its goal goes idle with zero commands while its twin
    tracks; is_goal_reached consumes the latch pair once; the flags and
    latches equal the JAX fleet's."""
    plan_long = np.stack([np.linspace(0, 5, 50), np.zeros(50),
                          np.zeros(50)], 1)
    plan_done = np.stack([np.linspace(0, 0.3, 5), np.zeros(5),
                          np.zeros(5)], 1)
    ours, ref = _pair(B=2)
    poses = np.array([[0.0, 0.05, 0.0], [0.29, 0.0, 0.0]])
    fb = np.zeros((2, 2))
    for fp in (ours, ref):
        assert fp.set_plans([plan_long, plan_done], poses).all()
    flags = []
    for fp in (ours, ref):
        flags.append((fp.is_goal_reached(poses, fb),
                      fp.is_goal_reached(poses, fb)))
    for a, b in zip(*flags):
        np.testing.assert_array_equal(a, b)
    done, d2 = flags[0]
    assert not done[0] and not d2[0]
    assert done[1] or d2[1]
    ok, cmds, info = ours.compute_velocity_commands(poses, fb)
    _, cmds_j, _ = ref.compute_velocity_commands(poses, fb)
    assert np.abs(cmds - cmds_j).max() <= 1e-8
    assert ok.all()
    assert tuple(cmds[1]) == (0.0, 0.0)
    assert abs(cmds[0, 0]) > 0.0
    assert info.state_enum(1).value == "ReachedAndIdle"
    assert info.observed.all()
    np.testing.assert_array_equal(ours.latch_xy, ref.latch_xy)
    np.testing.assert_array_equal(ours.latch_yaw, ref.latch_yaw)


def test_pipelined_begin_finish_matches_sequential():
    """Interleaved begin(k+1)/finish(k) serving gives the sequential
    commands when the inputs repeat (tests/test_fleet.py's check): the
    first cycle exactly, the late ones within 2e-3, the states equal."""
    B = 8
    plans = [p[:200] for p in fleet_courses(B, offset=0.0)]
    p = MPCParams(w_cte=300.0, w_angvel_d=10.0, w_accel_d=10.0)
    poses = np.stack([pl[0] for pl in plans])
    vw = np.zeros((B, 2))
    n_cyc = 24

    def make():
        fp = FleetPlanner(p, SolverConfig(n_steps=10), device="cpu")
        fp.initialize(B)
        fp.set_plans(plans, poses)
        return fp

    fp_seq = make()
    for k in range(n_cyc):
        ok_s, cmds_s, info_s = fp_seq.compute_velocity_commands(poses, vw)
        if k == 0:
            first_s = cmds_s.copy()
    fp_pip = make()
    h = fp_pip.begin_cycle(poses, vw)
    for k in range(n_cyc):
        h_next = fp_pip.begin_cycle(poses, vw)
        ok_p, cmds_p, info_p = fp_pip.finish_cycle(h)
        if k == 0:
            first_p = cmds_p.copy()
        h = h_next
    ok_p, cmds_p, info_p = fp_pip.finish_cycle(h)
    np.testing.assert_allclose(first_p, first_s, atol=1e-6)
    np.testing.assert_allclose(cmds_p, cmds_s, atol=2e-3)
    np.testing.assert_array_equal(info_p.states, info_s.states)
    assert bool(np.all(ok_p == ok_s))


def test_checkpoints_cross_between_the_packages():
    """A JAX fleet's `state_dict()` (numpy) loaded into the port's fleet
    continues with the JAX fleet's commands, and the port's checkpoint
    loaded into a fresh JAX fleet continues with the port's (f64,
    1e-8); the restored fleet is warm."""
    B = 3
    plans = fleet_courses(B)
    ours, ref = _pair(B=B)
    poses = np.stack([p[0] for p in plans])
    _drive(ours, ref, plans, poses, 8)
    fb = np.zeros((B, 2))
    for src, make in ((ref, lambda: _pair(B=B)[0]),
                      (ours, lambda: _pair(B=B)[1])):
        dst = make()
        dst.load_state_dict(src.state_dict())
        p2, fb2 = poses.copy(), fb.copy()
        for _ in range(4):
            _, c_src, _ = src.compute_velocity_commands(p2, fb2)
            _, c_dst, _ = dst.compute_velocity_commands(p2, fb2)
            assert np.abs(c_src - c_dst).max() <= 1e-8
            fb2 = step_poses(p2, c_src, 0.1)
        assert np.asarray(dst._has_warm).all()


def test_what_waits_raises():
    fp = FleetPlanner(device="cpu")
    fp.initialize(2)
    fp.set_costmaps(None)
    assert fp.world_obstacles is None
    # a device mesh is ported (tests/test_torch_parallel.py holds the
    # sharded fleet to the unsharded one): the planner keeps it
    from mpc_ros_tpu_torch.parallel import make_mesh

    mesh = make_mesh(n_data=2, devices=["cpu"] * 2)
    assert FleetPlanner(device="cpu", mesh=mesh).mesh is mesh


def test_fleet_entry_points_need_the_card_or_cpu():
    from mpc_ros_tpu_torch.planner import (DeviceFleetPlanner,
                                           FleetTrajectoryTracker)

    if torch.cuda.is_available():
        pytest.skip("a card is present: the entry points run on it")
    for make in (lambda: FleetPlanner(), lambda: DeviceFleetPlanner(),
                 lambda: FleetTrajectoryTracker(MPCParams(),
                                                SolverConfig())):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
