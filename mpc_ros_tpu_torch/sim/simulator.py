"""Kinematic closed-loop simulator (counterpart of
`mpc_ros_tpu/sim/simulator.py`): the plant rolls the same kinematics the
solver optimizes, so a closed-loop run isolates the controller. Diff-drive
commands are (v, w); the bicycle's are (v, delta), its heading advancing
by v / lf * delta. The plant is host numpy; the planner's solve runs where
the planner was built (the card unless `device="cpu"`).

`realtime=True` paces cycles at the control period with the native rate
executor (`native.RateLoop`) and reports its overrun statistics.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np

from ..planner.planner import MPCPlanner


@dataclasses.dataclass
class UnicyclePlant:
    """Differential-drive kinematics: the pose integrates (v, w)."""

    pose: np.ndarray          # (3,) x, y, yaw
    dt: float = 0.1
    v: float = 0.0
    w: float = 0.0

    def step(self, v_cmd: float, w_cmd: float) -> np.ndarray:
        self.v = float(v_cmd)
        self.w = float(w_cmd)
        x, y, yaw = self.pose
        self.pose = np.array([
            x + self.v * np.cos(yaw) * self.dt,
            y + self.v * np.sin(yaw) * self.dt,
            yaw + self.w * self.dt,
        ])
        return self.pose

    @property
    def feedback_vel(self) -> tuple[float, float]:
        return self.v, self.w


@dataclasses.dataclass
class BicyclePlant:
    """Kinematic bicycle (Ackermann): the pose integrates (v, delta) with
    psi' = v / lf * delta."""

    pose: np.ndarray          # (3,) x, y, yaw
    dt: float = 0.1
    lf: float = 0.5           # CoG -> front-axle distance [m]
    v: float = 0.0
    delta: float = 0.0

    def step(self, v_cmd: float, delta_cmd: float) -> np.ndarray:
        self.v = float(v_cmd)
        self.delta = float(delta_cmd)
        x, y, yaw = self.pose
        self.pose = np.array([
            x + self.v * np.cos(yaw) * self.dt,
            y + self.v * np.sin(yaw) * self.dt,
            yaw + self.v / self.lf * self.delta * self.dt,
        ])
        return self.pose

    @property
    def feedback_vel(self) -> tuple[float, float]:
        # (v, yaw rate): the realized heading rate, as the FSM's stopped
        # check expects
        return self.v, self.v / self.lf * self.delta


def make_plant(model_name: str, pose: np.ndarray, dt: float, params):
    """The plant matching a solver model family."""
    if model_name == "bicycle":
        return BicyclePlant(pose=pose, dt=dt, lf=float(params.lf))
    return UnicyclePlant(pose=pose, dt=dt)


def _max_dt(params) -> float:
    return float(np.max(np.asarray(params.to_numpy()["dt"])))


@dataclasses.dataclass
class ClosedLoopResult:
    records: np.ndarray       # (n, 5): idx, cte, etheta, v_cmd, w_cmd
    poses: np.ndarray         # (n, 3)
    states: list              # per-cycle DrivingState
    reached: bool
    n_cycles: int
    wall_time_s: float
    course_time_s: float      # n_cycles * dt
    rate_stats: Optional[dict] = None

    @property
    def mean_abs_cte(self) -> float:
        return float(np.mean(np.abs(self.records[:, 1])))

    @property
    def max_abs_cte(self) -> float:
        return float(np.max(np.abs(self.records[:, 1])))


def run_closed_loop(planner: MPCPlanner, plan: np.ndarray,
                    start_pose: Optional[np.ndarray] = None,
                    max_cycles: int = 5000,
                    log_path: Optional[str] = None,
                    realtime: bool = False) -> ClosedLoopResult:
    """Drive the plant with the planner until the goal is reached, logging
    per cycle (idx, cte, etheta, v_cmd, w_cmd) in the reference CSVs'
    schema: cte and etheta are the solver's error-state inputs, or outside
    Tracking the distance to the nearest plan point and 0.

    `realtime=True` paces the cycles at the control period with the native
    rate executor (`native.RateLoop`), armed after the first two cycles
    (the cold solve and the first warm one), and puts its overrun
    statistics on the result (`rate_stats`)."""
    dt = _max_dt(planner.params)
    if start_pose is None:
        start_pose = plan[0].copy()
    plant = make_plant(planner.solver_cfg.model,
                       np.asarray(start_pose, float), dt, planner.params)

    planner.initialize()
    if not planner.set_plan(plan, plant.pose, plant.feedback_vel):
        raise ValueError("planner rejected the plan")

    rate = None
    records = []
    poses = []
    states = []
    reached = False
    t_start = time.perf_counter()
    n_cycles = 0
    for cycle in range(1, max_cycles + 1):
        if realtime and rate is None and cycle > 2:
            from ..native import RateLoop

            rate = RateLoop(dt)
        if planner.is_goal_reached(plant.pose, plant.feedback_vel):
            reached = True
            break
        ok, (v_cmd, w_cmd), info = planner.compute_velocity_commands(
            plant.pose, plant.feedback_vel)
        if not ok:
            break
        n_cycles = cycle
        if info.tracking is not None and info.tracking.solve is not None:
            cte = float(info.tracking.state[4])
            etheta = float(info.tracking.state[5])
        else:
            d = np.hypot(plan[:, 0] - plant.pose[0],
                         plan[:, 1] - plant.pose[1])
            cte = float(np.min(d))
            etheta = 0.0
        records.append([cycle, cte, etheta, v_cmd, w_cmd])
        states.append(info.state)
        poses.append(plant.pose.copy())
        plant.step(v_cmd, w_cmd)
        if rate is not None:
            rate.sleep()

    wall = time.perf_counter() - t_start
    rate_stats = None
    if rate is not None:
        rate_stats = rate.stats
        rate.close()
    result = ClosedLoopResult(
        records=np.asarray(records) if records else np.zeros((0, 5)),
        poses=np.asarray(poses) if poses else np.zeros((0, 3)),
        states=states,
        reached=reached,
        # the cycles that executed a command (the goal-reached iteration
        # breaks before stepping the plant)
        n_cycles=n_cycles,
        wall_time_s=wall,
        course_time_s=n_cycles * dt,
        rate_stats=rate_stats,
    )
    if log_path is not None:
        from .logger import write_tracking_csv

        write_tracking_csv(log_path, result.records, result.course_time_s)
    return result


@dataclasses.dataclass
class TrajectoryLoopResult:
    records: np.ndarray      # (n, 5): idx, cte, etheta, v_cmd, w_cmd
    poses: np.ndarray        # (n, 3)
    ref_points: np.ndarray   # (n, 2) where the reference was each cycle
    lags: np.ndarray         # (n,) longitudinal schedule lag [m]
    reached: bool
    n_cycles: int
    wall_time_s: float
    course_time_s: float

    @property
    def dist_to_ref(self) -> np.ndarray:
        """Per-cycle distance to the moving reference point."""
        return np.hypot(self.poses[:, 0] - self.ref_points[:, 0],
                        self.poses[:, 1] - self.ref_points[:, 1])


def run_trajectory_tracking(tracker, traj,
                            start_pose: Optional[np.ndarray] = None,
                            max_cycles: int = 5000,
                            log_path: Optional[str] = None
                            ) -> TrajectoryLoopResult:
    """The closed loop of the trajectory-tracking mode: the plant chases a
    `TimedTrajectory` on its schedule; the same CSV schema as the path
    loop."""
    dt = _max_dt(tracker.params)
    if start_pose is None:
        start_pose = np.array([traj.xy[0, 0], traj.xy[0, 1], traj.yaw[0]])
    plant = make_plant(tracker.solver_cfg.model,
                       np.asarray(start_pose, float), dt, tracker.params)
    tracker.set_trajectory(traj)

    records, poses, ref_pts, lags = [], [], [], []
    reached = False
    n_cycles = 0
    t_start = time.perf_counter()
    for cycle in range(1, max_cycles + 1):
        t_now = (cycle - 1) * dt
        if tracker.finished(t_now, plant.pose):
            reached = True
            break
        (v_cmd, w_cmd), dbg = tracker.compute(
            t_now, plant.pose, plant.feedback_vel[0])
        n_cycles = cycle
        records.append([cycle, float(dbg.state[4]), float(dbg.state[5]),
                        v_cmd, w_cmd])
        poses.append(plant.pose.copy())
        ref_pts.append(dbg.ref_point.copy())
        lags.append(dbg.lag)
        plant.step(v_cmd, w_cmd)

    result = TrajectoryLoopResult(
        records=np.asarray(records) if records else np.zeros((0, 5)),
        poses=np.asarray(poses) if poses else np.zeros((0, 3)),
        ref_points=np.asarray(ref_pts) if ref_pts else np.zeros((0, 2)),
        lags=np.asarray(lags) if lags else np.zeros((0,)),
        reached=reached,
        n_cycles=n_cycles,
        wall_time_s=time.perf_counter() - t_start,
        course_time_s=n_cycles * dt,
    )
    if log_path is not None:
        from .logger import write_tracking_csv

        write_tracking_csv(log_path, result.records, result.course_time_s)
    return result
