"""The port's single-robot closed loop (`MPCPlanner` + `run_closed_loop`)
against the JAX package's, in float64 on the CPU:

* the lifecycle as tests/test_planner.py:110-245 checks it, each case
  against JAX: the FSM seeding, the first Tracking cycle, the rotate
  command's sign, the goal latches, a hot reconfigure, and the square
  course's corner with and without the heading-error wrap;
* 60 cycles of the infinity course, cycle by cycle: commands, logged
  errors and poses within 1e-6 and the same FSM state every cycle;
* world-frame blobs through `set_obstacles`;
* the tracking CSV against the JAX package's `sim/logger.py` (the same
  text for the same records, and each reads the other's);
* the whole infinity course in float32 (the planner's default) within
  the JAX envelope of tests/test_closed_loop.py;
* the CLI, `python -m mpc_ros_tpu_torch.sim.run --cpu --max-cycles 5`,
  and the entry points' refusals: no card without `device="cpu"`; its
  `--realtime` pacing.

Both packages fit the path with the same native C++ core by default; each
planner here, the JAX one and the port's, builds its tracker with
`_native_prep = False`, the numpy fit (an instance attribute; no JAX file
changes). tests/test_torch_tracking.py bounds the difference the native
fit makes.
"""

import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_ros_tpu.config import MPCParams as JMPCParams
from mpc_ros_tpu.config import PlannerConfig as JPlannerConfig
from mpc_ros_tpu.config import SolverConfig as JSolverConfig
from mpc_ros_tpu.models.obstacles import GaussianObstacles as JBlobs
from mpc_ros_tpu.planner import MPCPlanner as JPlanner
from mpc_ros_tpu.planner.tracking import TrackingController as JController
from mpc_ros_tpu.sim import logger as jlogger
from mpc_ros_tpu.sim import run_closed_loop as jrun_closed_loop
from mpc_ros_tpu_torch.config import MPCParams, PlannerConfig, SolverConfig
from mpc_ros_tpu_torch.models.obstacles import GaussianObstacles
from mpc_ros_tpu_torch.planner import MPCPlanner
from mpc_ros_tpu_torch.planner.fsm import DrivingState
from mpc_ros_tpu_torch.planner.tracking import TrackingController
from mpc_ros_tpu_torch.sim import (get_shape, infinity, logger,
                                   run_closed_loop)
from mpc_ros_tpu_torch.testing import torch_threads

ROOT = __import__("pathlib").Path(__file__).resolve().parents[1]
TOL = 1e-6
TOL_FIRST = 1e-8
# tests/test_closed_loop.py's planner
LOOP = dict(dt=0.1, ref_vel=0.5, max_angvel=1.5, w_cte=300.0,
            w_angvel_d=10.0, w_accel_d=10.0)
# tests/test_planner.py's
LIFE = dict(dt=0.1, ref_vel=0.5, w_cte=300.0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these tests run many small ops, and the suite
    runs in several processes at once (`testing.torch_threads`)."""
    with torch_threads(1):
        yield


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


def _planners(leaves, n_steps, dtype=torch.float64, **plan_kw):
    ours = _numpy_fit(MPCPlanner(MPCParams(**leaves),
                                 SolverConfig(n_steps=n_steps),
                                 PlannerConfig(**plan_kw), dtype=dtype,
                                 device="cpu"))
    ref = _numpy_fit(JPlanner(JMPCParams(**leaves),
                              JSolverConfig(n_steps=n_steps),
                              JPlannerConfig(**plan_kw)))
    return ours, ref


def _started(leaves=LIFE, n_steps=10, **plan_kw):
    ours, ref = _planners(leaves, n_steps, **plan_kw)
    ours.initialize()
    ref.initialize()
    return ours, ref


def straight_plan(n=100, length=10.0):
    xs = np.linspace(0, length, n)
    return np.stack([xs, np.zeros(n), np.zeros(n)], axis=1)


def _rel(a, b):
    a, b = np.asarray(a, float), np.asarray(b, float)
    return float(np.max(np.abs(a - b) / (1.0 + np.abs(b))))


# -- lifecycle (tests/test_planner.py:110-245) ---------------------------------

@pytest.mark.parametrize("pose,plan,want", [
    ((0.0, 0.0, 0.0), straight_plan(), DrivingState.TRACKING),
    ((0.0, 0.0, 2.0), straight_plan(), DrivingState.ROTATE_BEFORE_TRACKING),
    ((0.0, 0.0, 1.0), straight_plan(length=0.05, n=5),
     DrivingState.STOP_AND_ROTATE),
    # a plan without headings gets tangent headings
    ((0.0, 0.0, 0.0), straight_plan()[:, :2], DrivingState.TRACKING),
], ids=["aligned", "misaligned", "at_goal", "no_yaw"])
def test_set_plan_seeds_as_jax(pose, plan, want):
    ours, ref = _started()
    assert ours.set_plan(plan, np.array(pose)) and ref.set_plan(
        plan, np.array(pose))
    assert ours.state is want and ref.state.value == want.value
    np.testing.assert_array_equal(ours.global_plan, ref.global_plan)
    assert (ours.latch_xy, ours.set_new_goal) == (ref.latch_xy,
                                                 ref.set_new_goal)


def test_first_tracking_cycle_equals_jax():
    ours, ref = _started()
    pose = np.array([0.0, 0.0, 0.0])
    for pl in (ours, ref):
        pl.set_plan(straight_plan(), pose)
    ok, (v, w), info = ours.compute_velocity_commands(pose, (0.3, 0.0))
    jok, (jv, jw), jinfo = ref.compute_velocity_commands(pose, (0.3, 0.0))
    assert ok and jok and v > 0.0 and abs(w) < 0.3
    assert _rel((v, w), (jv, jw)) <= TOL_FIRST
    assert _rel(info.mpc_trajectory, jinfo.mpc_trajectory) <= TOL_FIRST
    assert _rel(info.tracking.state, jinfo.tracking.state) <= TOL_FIRST
    np.testing.assert_array_equal(info.ref_plan, jinfo.ref_plan)
    np.testing.assert_array_equal(info.local_plan, jinfo.local_plan)
    assert info.tracking.solve.n_iters == jinfo.tracking.solve.n_iters


def test_rotate_before_tracking_command_equals_jax():
    ours, ref = _started()
    pose = np.array([0.0, 0.0, 2.0])
    out = []
    for pl in (ours, ref):
        pl.set_plan(straight_plan(), pose)
        out.append(pl.compute_velocity_commands(pose, (0.0, 0.0)))
    (ok, (v, w), info), (_, jcmd, jinfo) = out
    assert ok and v == 0.0 and w < 0.0 and (v, w) == tuple(jcmd)
    assert info.state.value == jinfo.state.value
    assert info.tracking is None and info.mpc_trajectory is None


def test_goal_latching_equals_jax():
    ours, ref = _started()
    plan = straight_plan()
    goal_pose = np.array([10.0, 0.0, 0.0])
    seq = []
    for pl in (ours, ref):
        pl.set_plan(plan, np.array([9.95, 0.0, 0.0]))
        rec = [pl.is_goal_reached(goal_pose, (0.0, 0.0)), pl.state.value]
        pl.set_plan(plan, np.array([9.95, 0.0, 0.0]))
        for _ in range(3):
            rec += [pl.is_goal_reached(goal_pose, (0.0, 0.0)),
                    pl.latch_xy, pl.latch_yaw, pl.state.value]
        # still moving: the orientation latch waits for the stop
        rec += [pl.is_goal_reached(goal_pose, (0.5, 0.0))]
        seq.append(rec)
    assert seq[0] == seq[1]
    assert seq[0][:2] == [True, DrivingState.REACHED_AND_IDLE.value]


def test_hot_reconfigure_equals_jax():
    ours, ref = _started()
    cmds = []
    for pl, P in ((ours, MPCParams), (ref, JMPCParams)):
        pl.set_plan(straight_plan(), np.array([0.0, 0.5, 0.0]))
        _, c1, _ = pl.compute_velocity_commands(np.array([0.0, 0.5, 0.0]),
                                                (0.3, 0.0))
        pl.reconfigure(params=P(dt=0.1, ref_vel=0.2, w_cte=300.0),
                       planner_cfg=(PlannerConfig if P is MPCParams
                                    else JPlannerConfig)(max_speed=0.6))
        _, c2, _ = pl.compute_velocity_commands(np.array([0.1, 0.5, 0.0]),
                                                c1)
        cmds.append((c1, c2))
    assert _rel(cmds[0], cmds[1]) <= TOL_FIRST
    assert cmds[0][1][0] <= 0.2 + 1e-9
    assert ours.tracker.planner_cfg.max_speed == 0.6


@pytest.mark.parametrize("wrap", [True, False], ids=["wrap", "unwrapped"])
def test_square_corner_equals_jax(wrap):
    """The robot heading ~pi at the square's top-left corner, the window
    heading -pi/2 (tests/test_planner.py:188-214): wrapped, the heading
    error is the short way and the first control turns left; the
    reference's unwrapped formula turns right. Both as JAX does."""
    ref_plan = np.stack([np.linspace(0.0, -0.02, 12),
                         np.linspace(-0.05, -0.8, 12)], 1)
    pose = np.array([0.0, 0.02, 3.0])
    goal = np.array([0.0, -0.8, -np.pi / 2])
    kw = dict(delay_mode=False, wrap_etheta=wrap)
    ours = TrackingController(MPCParams(w_cte=300.0),
                              SolverConfig(n_steps=10), PlannerConfig(**kw),
                              device="cpu")
    ref = JController(JMPCParams(w_cte=300.0), JSolverConfig(n_steps=10),
                      JPlannerConfig(**kw), dtype=jnp.float64)
    ref._native_prep = False
    ours._native_prep = False
    (v, w0), dbg = ours.compute(pose, goal, 0.3, ref_plan)
    (jv, jw0), jdbg = ref.compute(pose, goal, 0.3, ref_plan)
    assert _rel((v, w0), (jv, jw0)) <= TOL_FIRST
    assert _rel(dbg.state, jdbg.state) <= TOL_FIRST
    if wrap:
        assert abs(dbg.state[5]) <= np.pi and w0 > 0.0
    else:
        assert dbg.state[5] > np.pi and w0 < 0.0


# -- the loop ------------------------------------------------------------------

def _loop_pair(cycles, blobs=None):
    ours, ref = _planners(LOOP, 20, local_plan_length=2.5)
    if blobs is not None:
        ours.initialize()
        ref.initialize()
        ours.set_obstacles(GaussianObstacles.from_sigmas(
            *(torch.tensor(b) for b in blobs)))
        ref.set_obstacles(JBlobs.from_sigmas(*(jnp.asarray(b)
                                              for b in blobs)))
    plan = infinity()
    return (run_closed_loop(ours, plan, max_cycles=cycles),
            jrun_closed_loop(ref, plan, max_cycles=cycles))


def _same_loop(res, jres):
    assert res.n_cycles == jres.n_cycles
    assert [s.value for s in res.states] == [s.value for s in jres.states]
    assert _rel(res.records, jres.records) <= TOL
    assert _rel(res.poses, jres.poses) <= TOL


def test_infinity_60_cycles_equal_jax(tmp_path):
    res, jres = _loop_pair(60)
    _same_loop(res, jres)
    assert {s.value for s in res.states} >= {"Tracking"}
    # the CSV: the same text from both writers, each reader reads both
    a, b = tmp_path / "port.csv", tmp_path / "jax.csv"
    logger.write_tracking_csv(str(a), res.records, res.course_time_s)
    jlogger.write_tracking_csv(str(b), res.records, res.course_time_s)
    assert a.read_text() == b.read_text()
    assert a.read_text().splitlines()[0] == jlogger.HEADER == logger.HEADER
    for path in (a, b):
        rec, t = logger.read_tracking_csv(str(path))
        jrec, jt = jlogger.read_tracking_csv(str(path))
        np.testing.assert_array_equal(rec, jrec)
        assert t == jt and abs(t - res.course_time_s) < 1e-6
        assert rec.shape == (60, 5)


def test_world_blobs_through_set_obstacles_equal_jax():
    """A blob beside the course's first metres, installed in the world
    frame; every Tracking cycle moves it into the robot frame."""
    blobs = ([3.0, 50.0], [0.45, 50.0], [0.3, 0.3], [60.0, 60.0])
    res, jres = _loop_pair(25, blobs)
    _same_loop(res, jres)


def test_infinity_course_within_jax_envelope():
    """The whole course in float32, the planner's default dtype: the goal
    reached, mean geometric error < 0.08 m and max < 0.25 m
    (tests/test_closed_loop.py:30-36), every record finite."""
    plan = get_shape("infinity")
    planner = MPCPlanner(MPCParams(**LOOP), SolverConfig(n_steps=20),
                         PlannerConfig(local_plan_length=2.5), device="cpu")
    assert planner.dtype == torch.float32
    res = run_closed_loop(planner, plan, max_cycles=1200)
    assert res.reached
    d = np.array([np.min(np.hypot(plan[:, 0] - q[0], plan[:, 1] - q[1]))
                  for q in res.poses])
    assert d.mean() < 0.08 and d.max() < 0.25, (d.mean(), d.max())
    assert np.all(np.isfinite(res.records))
    assert planner.tracker._warm_dev.device.type == "cpu"


# -- entry points ----------------------------------------------------------------

def test_cli_prints_one_json_line():
    import json

    out = subprocess.run(
        [sys.executable, "-m", "mpc_ros_tpu_torch.sim.run", "--cpu",
         "--max-cycles", "5"], cwd=ROOT, capture_output=True, text=True,
        timeout=300, check=True).stdout.strip().splitlines()
    assert len(out) == 1
    rec = json.loads(out[0])
    assert rec["cycles"] == 5 and rec["device"] == "cpu"
    assert rec["n_solves"] == 5 and rec["converged_frac"] == 1.0


@pytest.mark.parametrize("argv,item", [
    (["--realtime", "--max-cycles", "5"], "item 8")])
def test_cli_refuses_what_is_not_ported(argv, item, capsys):
    """`--realtime` (ROADMAP Queue 1 `item`) is ported now: the CLI paces
    the cycles after the first two with the native rate executor and
    prints its statistics (tests/test_torch_node.py drives
    `run_closed_loop(realtime=True)`)."""
    import json

    from mpc_ros_tpu_torch.sim import run

    run.main(["--cpu"] + argv)
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["cycles"] == 5
    assert rec["rate"]["cycles"] == 3


def test_costmap_route_is_not_ported():
    """The costmap route is ported now (tests/test_torch_costmap_planners.py
    holds it against JAX): `set_costmap` installs the fitted world blobs
    on the planner's device, `set_costmap(None)` clears them."""
    from mpc_ros_tpu_torch.models.obstacles import gaussian_blob_map

    pl = MPCPlanner(device="cpu", dtype=torch.float64)
    pl.initialize()
    pl.set_costmap(gaussian_blob_map((1.0, 0.2), dtype=torch.float64))
    wo = pl.world_obstacles
    assert wo.cx.shape == (4,) and wo.cx.dtype == torch.float64
    assert abs(float(wo.cx[0]) - 1.0) < 0.1 and float(wo.w[0]) > 10.0
    pl.set_costmap(None)
    assert pl.world_obstacles is None


def test_entry_points_need_the_card_or_cpu():
    from mpc_ros_tpu_torch.planner import TrajectoryTracker
    from mpc_ros_tpu_torch.sim import run

    if torch.cuda.is_available():
        pytest.skip("a card is present: the entry points run on it")
    for make in (lambda: MPCPlanner(),
                 lambda: TrackingController(MPCParams(), SolverConfig(),
                                            PlannerConfig()),
                 lambda: TrajectoryTracker(MPCParams(), SolverConfig())):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    with pytest.raises(RuntimeError, match="--cpu"):
        run.main(["--max-cycles", "1"])
