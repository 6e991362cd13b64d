"""The planners' costmap routes in the port against the JAX package's, on
the CPU in float64, cycle by cycle (the same pose and feedback every cycle,
the JAX command driving the plant; the JAX trackers built with their numpy
path fit, `_native_prep = False`, ROADMAP Queue 3 item 6):

* `MPCPlanner.set_costmap` (a world-frame grid fitted to blobs on the
  host, greedy and refined) on a straight course past an obstacle;
* `TrackingController.obstacle_map` (a robot-frame grid every cycle, the
  solver sampling it) in the three samplings;
* `FleetPlanner.set_costmaps` (a batch of world maps fitted on the
  device);
* DWA's grid clearance (`tracker.obstacle_map`, float32 as in JAX);

commands within 1e-6 (DWA: 1e-9, float32 window) and the FSM states equal
every cycle; `set_costmap(None)` clearing the obstacles; and
`bench_cuda.py --quick --obstacles-grid` for each sampling.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_ros_tpu.config import MPCParams as JMPCParams
from mpc_ros_tpu.config import PlannerConfig as JPlannerConfig
from mpc_ros_tpu.config import SolverConfig as JSolverConfig
from mpc_ros_tpu.models import obstacles as jobs
from mpc_ros_tpu.planner import DWAPlanner as JDWAPlanner
from mpc_ros_tpu.planner import FleetPlanner as JFleet
from mpc_ros_tpu.planner import MPCPlanner as JPlanner
from mpc_ros_tpu_torch.config import MPCParams, PlannerConfig, SolverConfig
from mpc_ros_tpu_torch.models import obstacles
from mpc_ros_tpu_torch.planner import DWAPlanner, FleetPlanner, MPCPlanner
from mpc_ros_tpu_torch.testing import torch_threads

ROOT = Path(__file__).resolve().parents[1]
# tests/test_obstacle_planner.py's planner and course
LEAVES = dict(dt=0.1, ref_vel=0.5, max_angvel=1.5, w_angvel_d=10.0,
              w_accel_d=10.0)
PLAN_KW = dict(local_plan_length=2.5)
N = 12
OBST = (3.0, 0.2)
CMD_TOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these tests run many small ops, and the suite
    runs in several processes at once (`testing.torch_threads`)."""
    with torch_threads(1):
        yield


def straight_plan(length=6.0, n=120):
    x = np.linspace(0.0, length, n)
    return np.stack([x, np.zeros(n), np.zeros(n)], -1)


def _numpy_fit(planner):
    """The planner (either package's), its tracker built with the numpy
    path fit."""
    make_orig = type(planner)._make_tracker

    def make():
        tr = make_orig(planner)
        tr._native_prep = False
        return tr
    planner._make_tracker = make
    return planner


def planners(kind="mpc"):
    if kind == "dwa":
        ours = DWAPlanner(params=MPCParams(**LEAVES),
                          planner_cfg=PlannerConfig(**PLAN_KW), device="cpu")
        ref = JDWAPlanner(params=JMPCParams(**LEAVES),
                          planner_cfg=JPlannerConfig(**PLAN_KW))
    else:
        ours = _numpy_fit(MPCPlanner(MPCParams(**LEAVES),
                                     SolverConfig(n_steps=N),
                                     PlannerConfig(**PLAN_KW),
                                     dtype=torch.float64, device="cpu"))
        ref = _numpy_fit(JPlanner(JMPCParams(**LEAVES),
                                  JSolverConfig(n_steps=N),
                                  JPlannerConfig(**PLAN_KW)))
    ours.initialize()
    ref.initialize()
    return ours, ref


def world_map(cells=32, extent=8.0, dtype=np.float64):
    """One world-frame Gaussian obstacle (sigma 0.3) on the course, as
    numpy leaves (grid, origin, resolution, weight)."""
    xs = np.linspace(-extent / 2, extent / 2, cells) + np.array([[3.0]])
    X, Y = np.meshgrid(xs[0], xs[0] - 3.0)
    g = np.exp(-((X - OBST[0]) ** 2 + (Y - OBST[1]) ** 2) / (2 * 0.3 ** 2))
    return (g.astype(dtype), np.array([3.0 - extent / 2, -extent / 2], dtype),
            np.asarray(extent / (cells - 1), dtype), np.asarray(50.0, dtype))


def robot_frame_map(pose, cells=40, extent=4.0, dtype=np.float64):
    """The obstacle seen from `pose`: a robot-frame grid (the JAX package's
    tests/test_obstacle_fit.py construction)."""
    xs = np.linspace(-extent / 2, extent / 2, cells)
    XR, YR = np.meshgrid(xs, xs)
    ct, st = np.cos(pose[2]), np.sin(pose[2])
    wx = XR * ct - YR * st + pose[0]
    wy = XR * st + YR * ct + pose[1]
    g = np.exp(-((wx - OBST[0]) ** 2 + (wy - OBST[1]) ** 2) / (2 * 0.3 ** 2))
    return (g.astype(dtype), np.array([-extent / 2, -extent / 2], dtype),
            np.asarray(extent / (cells - 1), dtype), np.asarray(50.0, dtype))


def both_maps(leaves, sampling="bilinear"):
    jm = jobs.ObstacleMap(*(jnp.asarray(a) for a in leaves),
                          sampling=sampling)
    tm = obstacles.ObstacleMap(*(torch.tensor(np.asarray(a))
                                 for a in leaves), sampling=sampling)
    return jm, tm


def drive(ours, ref, cycles, start, per_cycle=None, tol=CMD_TOL):
    """Both planners on the JAX command's pose stream from `start`; the
    commands and FSM states held every cycle. Returns the poses."""
    plan = straight_plan()
    pose = np.array(start, float)
    assert ours.set_plan(plan, pose) and ref.set_plan(plan, pose)
    vw = (0.3, 0.0)
    poses = [pose.copy()]
    for c in range(cycles):
        if per_cycle is not None:
            per_cycle(pose)
        ok_o, cmd_o, _ = ours.compute_velocity_commands(pose, vw)
        ok_r, cmd_r, _ = ref.compute_velocity_commands(pose, vw)
        assert ok_o == ok_r and ours.state.value == ref.state.value, c
        cmd_r = tuple(float(x) for x in cmd_r)
        assert np.abs(np.subtract(cmd_o, cmd_r)).max() <= tol, (c, cmd_o,
                                                                cmd_r)
        v, w = cmd_r
        pose = pose + np.array([v * np.cos(pose[2]) * 0.1,
                                v * np.sin(pose[2]) * 0.1, w * 0.1])
        vw = (v, w)
        poses.append(pose.copy())
    return np.asarray(poses)


@pytest.mark.parametrize("refine", [False, True], ids=["greedy", "refined"])
def test_set_costmap_matches_jax(refine):
    """`set_costmap` on both planners (the same numpy world grid), then 14
    cycles approaching the obstacle: the fitted blobs equal, commands and
    states equal; the planner steers off the plan."""
    ours, ref = planners()
    jm, tm = both_maps(world_map())
    ours.set_costmap(tm, refine=refine)
    ref.set_costmap(jm, refine=refine)
    for f in ("cx", "cy", "gamma", "w"):
        np.testing.assert_allclose(getattr(ours.world_obstacles, f).numpy(),
                                   np.asarray(getattr(ref.world_obstacles,
                                                      f)),
                                   rtol=0, atol=1e-9 if refine else 1e-12)
    poses = drive(ours, ref, 14, (1.6, 0.0, 0.0))
    # an obstacle-free planner stays on y = 0 on this course
    assert np.abs(poses[:, 1]).max() > 1e-4


@pytest.mark.parametrize("sampling", ["bilinear", "spline", "spline_coeff"])
def test_obstacle_map_matches_jax(sampling):
    """`tracker.obstacle_map`: the robot-frame grid of every cycle's pose
    set on both trackers, 12 cycles near the obstacle."""
    ours, ref = planners()

    def per_cycle(pose):
        jm, tm = both_maps(robot_frame_map(pose), sampling)
        ours.tracker.obstacle_map = tm
        ref.tracker.obstacle_map = jm

    poses = drive(ours, ref, 12, (1.8, 0.0, 0.0), per_cycle)
    # an obstacle-free planner stays on y = 0 on this course
    assert np.abs(poses[:, 1]).max() > 1e-4
    # the map went to the controller's device and dtype once, spline_coeff
    # with its planes
    om = ours.tracker.obstacle_map
    assert om.grid.dtype == torch.float64
    assert (om.coeff is not None) == (sampling == "spline_coeff")


def test_set_costmaps_matches_jax():
    """`FleetPlanner.set_costmaps` (the device fit of a batch of world
    maps) on 4 robots at different starts, 8 cycles: blobs equal, commands
    within 1e-6 and states equal every cycle."""
    B = 4
    leaves = tuple(np.broadcast_to(a, (B,) + np.shape(a)).copy()
                   for a in world_map())
    leaves[0][1] *= 0.0          # robot 1's map: empty
    ours = FleetPlanner(MPCParams(**LEAVES), SolverConfig(n_steps=N),
                        PlannerConfig(**PLAN_KW), dtype=torch.float64,
                        device="cpu")
    ref = JFleet(JMPCParams(**LEAVES), JSolverConfig(n_steps=N),
                 JPlannerConfig(**PLAN_KW), dtype=jnp.float64)
    ours.initialize(B)
    ref.initialize(B)
    jm = jobs.ObstacleMap(*(jnp.asarray(a) for a in leaves))
    # numpy leaves: the port packs them into one upload
    tm = obstacles.ObstacleMap(*leaves)
    ours.set_costmaps(tm)
    ref.set_costmaps(jm)
    for f in ("cx", "cy", "gamma", "w"):
        np.testing.assert_allclose(getattr(ours.world_obstacles, f).numpy(),
                                   np.asarray(getattr(ref.world_obstacles,
                                                      f)), rtol=0, atol=1e-12)
    plan = straight_plan()
    poses = np.array([[1.6, 0.0, 0.0], [1.6, 0.0, 0.0], [2.0, 0.05, 0.1],
                      [1.2, -0.05, 0.0]])
    assert ours.set_plans([plan] * B, poses).all()
    assert np.asarray(ref.set_plans([plan] * B, poses)).all()
    fb = np.full((B, 2), 0.0)
    fb[:, 0] = 0.3
    for c in range(8):
        _, cmd_o, _ = ours.compute_velocity_commands(poses, fb)
        _, cmd_r, _ = ref.compute_velocity_commands(poses, fb)
        cmd_r = np.asarray(cmd_r, float)
        np.testing.assert_array_equal(ours.states, np.asarray(ref.states))
        assert np.abs(cmd_o - cmd_r).max() <= CMD_TOL, c
        v, w = cmd_r[:, 0], cmd_r[:, 1]
        poses = poses + np.stack([v * np.cos(poses[:, 2]) * 0.1,
                                  v * np.sin(poses[:, 2]) * 0.1, w * 0.1], 1)
        fb = cmd_r


def test_dwa_grid_clearance_matches_jax():
    """DWA with a robot-frame grid every cycle (float32 maps, the JAX
    evaluator's dtype): the same winner every cycle (1e-9) for 15 cycles
    toward the obstacle."""
    ours, ref = planners("dwa")

    def per_cycle(pose):
        jm, tm = both_maps(robot_frame_map(pose, dtype=np.float32))
        ours.tracker.obstacle_map = tm
        ref.tracker.obstacle_map = jm

    drive(ours, ref, 15, (1.8, 0.0, 0.0), per_cycle, tol=1e-9)


def test_set_costmap_none_clears():
    """`set_costmap(None)` clears the world obstacles: the next cycle's
    tracker carries none. The route equals the explicit one
    (tests/test_obstacle_planner.py::test_set_costmap_routes_match_explicit_fit):
    a planner given `fit_gaussians_to_map`'s blobs through `set_obstacles`
    and cleared with `set_obstacles(None)` commands the same, bit for bit,
    on both cycles."""
    ours, _ = planners()
    twin, _ = planners()
    free, _ = planners()
    _, tm = both_maps(world_map())
    ours.set_costmap(tm)
    twin.set_obstacles(obstacles.fit_gaussians_to_map(tm, 4, refine=False))
    plan = straight_plan()
    pose = np.array([2.0, 0.0, 0.0])
    for pl in (ours, twin, free):
        pl.set_plan(plan, pose)
    cmds = [pl.compute_velocity_commands(pose, (0.3, 0.0))[1]
            for pl in (ours, twin, free)]
    assert cmds[0] == cmds[1]
    assert np.abs(np.subtract(cmds[0], cmds[2])).max() > 1e-3
    assert ours.tracker.obstacles is not None
    ours.set_costmap(None)
    twin.set_obstacles(None)
    assert ours.world_obstacles is None
    cleared = [pl.compute_velocity_commands(pose, (0.3, 0.0))[1]
               for pl in (ours, twin)]
    assert ours.tracker.obstacles is None
    assert cleared[0] == cleared[1]


@pytest.mark.parametrize("sampling", ["spline_coeff", "spline", "bilinear"])
def test_bench_quick_obstacles_grid(sampling):
    """`bench_cuda.py --quick --obstacles-grid --grid-sampling S` (at N=12
    and 32 scenarios, to keep the CPU run short): one JSON line with
    bench.py's metric name (the sampling suffixed unless "spline"), the
    grid ensemble's cap, no K1 launch and the CPU as its device."""
    r = subprocess.run(
        [sys.executable, str(ROOT / "bench_cuda.py"), "--quick",
         "--obstacles-grid", "--grid-sampling", sampling, "--repeats", "1",
         "--pipeline", "1", "--batch", "32", "--n-steps", "12"],
        capture_output=True, text=True, timeout=300, cwd=str(ROOT),
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert r.returncode == 0, r.stderr[-2000:]
    lines = [ln for ln in r.stdout.splitlines() if ln.strip()]
    assert len(lines) == 1, r.stdout
    out = json.loads(lines[0])
    suffix = "" if sampling == "spline" else f"_{sampling}"
    assert out["metric"] == f"nmpc_solves_per_s_n12_obstacles_grid{suffix}"
    assert out["device"] == "cpu" and out["batch"] == 32
    assert out["value"] > 0 and out["converged_frac"] >= 0.9
    assert out["grid_sampling"] == sampling and out["max_sqp_iters"] == 30
    assert out["k1_launches_per_solve"] == 0
