"""The port's single-robot trajectory tracking (`TimedTrajectory`,
`TrajectoryTracker`, `run_trajectory_tracking`) against the JAX
package's, in float64 on the CPU: `from_path` and `sample` equal to JAX's
(duplicate waypoints, scalar and per-waypoint speeds, times outside the
schedule), `finished`, and 30 tracker cycles on the infinity course with
and without a world-frame blob — the error state, coefficients, setpoint
profile, controls and cost within 1e-8 on cycle 1 and 1e-6 on every
cycle, with equal iterations — then the loop itself for 40 cycles, and
the near-end fit (no RankWarning) as tests/test_trajectory_tracking.py
checks it."""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_ros_tpu.config import MPCParams as JMPCParams
from mpc_ros_tpu.config import PlannerConfig as JPlannerConfig
from mpc_ros_tpu.config import SolverConfig as JSolverConfig
from mpc_ros_tpu.models.obstacles import GaussianObstacles as JBlobs
from mpc_ros_tpu.planner.trajectory import TimedTrajectory as JTimed
from mpc_ros_tpu.planner.trajectory import TrajectoryTracker as JTracker
from mpc_ros_tpu.sim.simulator import run_trajectory_tracking as jrun
from mpc_ros_tpu_torch.config import MPCParams, PlannerConfig, SolverConfig
from mpc_ros_tpu_torch.models.obstacles import GaussianObstacles
from mpc_ros_tpu_torch.planner import TimedTrajectory, TrajectoryTracker
from mpc_ros_tpu_torch.sim import get_shape
from mpc_ros_tpu_torch.sim.simulator import run_trajectory_tracking
from mpc_ros_tpu_torch.testing import torch_threads

N = 20
TOL_FIRST = 1e-8
TOL = 1e-6
# tests/test_trajectory_tracking.py's tracker
LEAVES = dict(dt=0.1, max_angvel=1.5, w_cte=300.0, w_angvel_d=10.0,
              w_accel_d=10.0)
BLOB = ([3.0], [0.3], [0.35], [120.0])


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these tests run many small ops, and the suite
    runs in several processes at once (`testing.torch_threads`)."""
    with torch_threads(1):
        yield


def _pair():
    ours = TrajectoryTracker(MPCParams(**LEAVES), SolverConfig(n_steps=N),
                             PlannerConfig(local_plan_length=2.5),
                             dtype=torch.float64, device="cpu")
    ref = JTracker(JMPCParams(**LEAVES), JSolverConfig(n_steps=N),
                   JPlannerConfig(local_plan_length=2.5))
    return ours, ref


def _rel(a, b):
    a, b = np.asarray(a, float), np.asarray(b, float)
    return float(np.max(np.abs(a - b) / (1.0 + np.abs(b))))


@pytest.mark.parametrize("case", ["scalar", "profile", "duplicates",
                                  "no_yaw"])
def test_timed_trajectory_equals_jax(case):
    plan = get_shape("infinity")[:120]
    speed = 0.4
    if case == "profile":
        speed = 0.2 + 0.3 * np.abs(np.sin(np.linspace(0, 3, len(plan))))
    if case == "duplicates":
        plan = np.repeat(plan, 2, axis=0)
    if case == "no_yaw":
        plan = plan[:, :2]
    ours, ref = TimedTrajectory.from_path(plan, speed), JTimed.from_path(
        plan, speed)
    for f in ("xy", "yaw", "t"):
        np.testing.assert_array_equal(getattr(ours, f), getattr(ref, f))
    assert ours.duration == ref.duration
    times = np.concatenate([[-1.0, 0.0], np.linspace(0, ours.duration + 2,
                                                     97)])
    for a, b in zip(ours.sample(times), ref.sample(times)):
        np.testing.assert_array_equal(a, b)


def test_timed_trajectory_rejects_what_jax_rejects():
    for Timed in (TimedTrajectory, JTimed):
        with pytest.raises(ValueError, match="strictly increasing"):
            Timed(xy=np.zeros((3, 2)), yaw=np.zeros(3),
                  t=np.array([0.0, 1.0, 1.0]))


def test_finished_equals_jax():
    traj = get_shape("infinity")[:80]
    ours, ref = _pair()
    ours.set_trajectory(TimedTrajectory.from_path(traj, 0.4))
    ref.set_trajectory(JTimed.from_path(traj, 0.4))
    goal = ours.traj.xy[-1]
    end = ours.traj.t[-1]
    for t in (0.0, end - 0.1, end, end + 1.0):
        for pose in (goal, goal + [0.15, 0.0], goal + [5.0, 0.0]):
            p = np.array([pose[0], pose[1], 0.0])
            assert ours.finished(t, p) == ref.finished(t, p)
    assert ours.finished(end + 1.0, np.array([goal[0], goal[1], 0.0]))
    assert not ours.finished(0.0, np.array([goal[0], goal[1], 0.0]))


@pytest.mark.parametrize("blobs", [False, True], ids=["free", "blob"])
def test_tracker_cycles_equal_jax(blobs):
    """30 cycles, the same inputs on both sides (the pose sequence from a
    plant driven by the JAX tracker)."""
    ours, ref = _pair()
    plan = get_shape("infinity")
    ours.set_trajectory(TimedTrajectory.from_path(plan, 0.4))
    ref.set_trajectory(JTimed.from_path(plan, 0.4))
    if blobs:
        ours.set_obstacles(GaussianObstacles.from_sigmas(
            *(torch.tensor(b, dtype=torch.float64) for b in BLOB)))
        ref.set_obstacles(JBlobs.from_sigmas(
            *(jnp.asarray(b, jnp.float64) for b in BLOB)))
    pose = np.array([plan[0, 0], plan[0, 1], plan[0, 2]])
    v = 0.0
    worst = []
    for cycle in range(30):
        t_now = cycle * 0.1
        (v1, w1), d1 = ours.compute(t_now, pose, v)
        (v2, w2), d2 = ref.compute(t_now, pose, v)
        worst.append(max(
            _rel(d1.state, d2.state), _rel(d1.coeffs, d2.coeffs),
            _rel(d1.refs, d2.refs), _rel(d1.solve.us, d2.solve.us),
            _rel(d1.cost, d2.cost), _rel((v1, w1), (v2, w2)),
            _rel(d1.lag, d2.lag)))
        np.testing.assert_array_equal(d1.ref_point, d2.ref_point)
        assert d1.solve.n_iters == d2.solve.n_iters
        pose = pose + 0.1 * np.array([v2 * np.cos(pose[2]),
                                      v2 * np.sin(pose[2]), w2])
        v = v2
    assert worst[0] <= TOL_FIRST, worst[0]
    assert max(worst) <= TOL, max(worst)


def test_trajectory_loop_equals_jax():
    plan = get_shape("infinity")
    ours, ref = _pair()
    res = run_trajectory_tracking(ours, TimedTrajectory.from_path(plan, 0.4),
                                  max_cycles=40)
    jres = jrun(ref, JTimed.from_path(plan, 0.4), max_cycles=40)
    assert res.n_cycles == jres.n_cycles == 40
    for f in ("records", "poses", "lags", "dist_to_ref"):
        assert _rel(getattr(res, f), getattr(jres, f)) <= TOL, f
    np.testing.assert_array_equal(res.ref_points, jres.ref_points)
    assert res.course_time_s == jres.course_time_s
    assert float(res.dist_to_ref.max()) < 0.55


def test_near_end_fit_is_well_conditioned():
    """Past the schedule's end the knots clamp onto the final waypoint: the
    fit's degree drops (tests/test_trajectory_tracking.py:122-138)."""
    plan = get_shape("infinity")[:60]
    ours, ref = _pair()
    ours.set_trajectory(TimedTrajectory.from_path(plan, 0.4))
    ref.set_trajectory(JTimed.from_path(plan, 0.4))
    pose = np.array([ours.traj.xy[-1, 0] - 0.05, ours.traj.xy[-1, 1],
                     ours.traj.yaw[-1]])
    t = float(ours.traj.t[-1]) - 1.5
    with warnings.catch_warnings():
        warnings.simplefilter("error", np.exceptions.RankWarning)
        (v, w), dbg = ours.compute(t, pose, 0.3)
    (jv, jw), jdbg = ref.compute(t, pose, 0.3)
    assert np.all(np.isfinite(dbg.coeffs)) and np.isfinite(v + w)
    assert _rel(dbg.coeffs, jdbg.coeffs) <= TOL_FIRST
    assert _rel((v, w), (jv, jw)) <= TOL_FIRST
