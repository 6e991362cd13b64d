"""The planner lifecycle (counterpart of `mpc_ros_tpu/planner/planner.py`,
the nav_core::BaseLocalPlanner successor):

    initialize / set_plan / compute_velocity_commands / is_goal_reached

with an `on_cycle` callback in place of ROS topics. The caller supplies the
pose and the feedback velocity; the latched goal tolerances, the plan
cutoff, truncation and downsampling, the FSM and the predicted-trajectory
record follow the JAX package line for line. The Tracking state's solve
runs on the card unless the planner is built with `device="cpu"`; the
dtype is an explicit argument (float32 by default) where the JAX package
reads `jax_enable_x64`.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch

from ..config import MPCParams, PlannerConfig, SolverConfig
from ..models.base import get_model
from ..models.obstacles import GaussianObstacles, fit_gaussians_to_map
from ..obs.timers import span
from . import plan_utils
from .fsm import (DrivingState, check_transition, normalize_angle,
                  rotate_command, seed_state)
from .tracking import TrackingController, TrackingDebug, resolve_device


@dataclasses.dataclass
class CycleInfo:
    """Per-cycle observability record."""

    state: DrivingState
    cmd: tuple[float, float]
    local_plan: np.ndarray
    ref_plan: np.ndarray
    mpc_trajectory: Optional[np.ndarray]   # (N, 3) x, y, theta, robot frame
    tracking: Optional[TrackingDebug]
    solve_time_s: float


class MPCPlanner:
    """The local planner with the reference's lifecycle semantics."""

    def __init__(self, params: MPCParams = MPCParams(),
                 solver_cfg: SolverConfig = SolverConfig(),
                 planner_cfg: PlannerConfig = PlannerConfig(),
                 dtype=torch.float32, device=None):
        self._initialized = False
        self.params = params
        self.solver_cfg = solver_cfg
        self.planner_cfg = planner_cfg
        self.dtype = dtype
        self.device = resolve_device(device)
        self.on_cycle: Optional[Callable[[CycleInfo], None]] = None

    # -- lifecycle ---------------------------------------------------------

    def initialize(self) -> None:
        """Seeds the FSM in ReachedAndIdle and builds the tracking
        controller."""
        self.state = DrivingState.REACHED_AND_IDLE
        self.tracker = self._make_tracker()
        # Ackermann-style families cannot rotate in place: Tracking absorbs
        # heading errors, and the goal completes on position + stopped
        self._can_rotate = get_model(self.solver_cfg.model).can_rotate_in_place
        self.global_plan: Optional[np.ndarray] = None
        self.latch_xy = False
        self.latch_yaw = False
        self.set_new_goal = False
        # survives re-initialization
        self.world_obstacles = getattr(self, "world_obstacles", None)
        self._initialized = True

    def set_obstacles(self, blobs) -> None:
        """Install world-frame parametric obstacles (`GaussianObstacles`,
        leaves (K,)); each Tracking cycle moves them into the robot frame
        (`to_frame`) and hands them to the solver. None clears."""
        self.world_obstacles = blobs

    def set_costmap(self, omap, n_blobs: int = 4,
                    refine: bool = False) -> None:
        """A world-frame costmap snapshot (`ObstacleMap`) fitted to
        `n_blobs` Gaussian blobs on the host (`fit_gaussians_to_map`; with
        `refine` the scipy least-squares refinement, at map-update rate
        only) and installed as the world obstacles, on the planner's
        device: the single-robot production costmap route. None clears."""
        if omap is None:
            self.set_obstacles(None)
            return
        blobs = fit_gaussians_to_map(omap, n_blobs, refine=refine)
        self.set_obstacles(GaussianObstacles(*(
            getattr(blobs, f).to(self.device, self.dtype)
            for f in ("cx", "cy", "gamma", "w"))))

    def _make_tracker(self):
        """The Tracking state's controller."""
        return TrackingController(self.params, self.solver_cfg,
                                  self.planner_cfg, self.dtype, self.device)

    def _tracking_command(self, pose: np.ndarray,
                          feedback_vel: tuple[float, float],
                          cut: np.ndarray):
        """The Tracking state's control law. Returns (cmd, ref_plan,
        predicted trajectory or None, TrackingDebug or None)."""
        ref_plan = plan_utils.downsample_plan(
            cut, self.planner_cfg.downsample_segments)
        # assigned every cycle, so set_obstacles(None) clears the tracker's
        # robot-frame copy
        self.tracker.obstacles = (
            self.world_obstacles.to_frame(pose)
            if self.world_obstacles is not None else None)
        (v_cmd, w_cmd), tracking_dbg = self.tracker.compute(
            pose, self.goal, feedback_vel[0], ref_plan, raw_plan=cut)
        mpc_traj = None
        if tracking_dbg.solve is not None:
            mpc_traj = np.asarray(tracking_dbg.solve.zs)[:, :3]
        return (v_cmd, w_cmd), ref_plan, mpc_traj, tracking_dbg

    def reconfigure(self, params: MPCParams = None,
                    planner_cfg: PlannerConfig = None) -> None:
        """Runtime reconfiguration: solver parameters hot-reload (new
        device leaves, nothing rebuilt)."""
        if params is not None:
            self.params = params
            self.tracker.update_params(params)
        if planner_cfg is not None:
            self.planner_cfg = planner_cfg
            self.tracker.planner_cfg = planner_cfg

    def set_plan(self, plan: np.ndarray, pose: np.ndarray,
                 feedback_vel: tuple[float, float] = (0.0, 0.0)) -> bool:
        """A new global plan (M, 3) world waypoints (x, y, yaw); the goal is
        its last pose. The FSM is seeded from position and heading alone,
        as the reference's setPlan does (`feedback_vel` is not read)."""
        if not self._initialized:
            return False
        plan = np.asarray(plan, float)
        if plan.ndim != 2 or len(plan) == 0:
            return False
        if plan.shape[1] < 3:
            # tangent headings: the goal-yaw logic reads column 2
            yaw = np.zeros(len(plan))
            if len(plan) >= 2:
                d = np.diff(plan[:, :2], axis=0)
                yaw[:-1] = np.arctan2(d[:, 1], d[:, 0])
                yaw[-1] = yaw[-2]
            plan = np.concatenate([plan[:, :2], yaw[:, None]], axis=1)
        self.global_plan = plan
        self.set_new_goal = True
        self.tracker.reset()

        cut = plan_utils.cutoff_plan(plan, np.asarray(pose[:2]))
        below = (not self._can_rotate) or self._below_heading_error(pose, cut)
        self.state = seed_state(
            position_reached=self._is_position_reached(pose),
            below_heading_error=below)
        return True

    # -- queries -----------------------------------------------------------

    @property
    def goal(self) -> Optional[np.ndarray]:
        if self.global_plan is None or len(self.global_plan) == 0:
            return None
        return self.global_plan[-1]

    def _is_position_reached(self, pose: np.ndarray) -> bool:
        """The latched xy tolerance."""
        goal = self.goal
        if goal is None:
            return False
        within = (np.hypot(pose[0] - goal[0], pose[1] - goal[1])
                  <= self.planner_cfg.limits.xy_goal_tolerance)
        if not self.set_new_goal and self.latch_xy:
            return True
        self.set_new_goal = False
        self.latch_xy = bool(within)
        return self.latch_xy

    def _is_orientation_reached(self, pose: np.ndarray,
                                feedback_vel: tuple[float, float]) -> bool:
        """The yaw tolerance and the stopped check, latching yaw (a family
        that cannot rotate in place completes on position + stopped)."""
        goal = self.goal
        if goal is None:
            return False
        angle = normalize_angle(pose[2] - goal[2])
        if not self._can_rotate or (
                abs(angle) <= self.planner_cfg.limits.yaw_goal_tolerance):
            v, w = feedback_vel
            if (abs(v) <= self.planner_cfg.limits.trans_stopped_vel
                    and abs(w) <= self.planner_cfg.limits.theta_stopped_vel):
                self.latch_yaw = True
                return True
        return False

    def _below_heading_error(self, pose: np.ndarray,
                             cutoff: np.ndarray) -> bool:
        """The reference's `isBelowErrorTheta`."""
        if len(cutoff) == 0:
            return False
        path_dir = plan_utils.path_heading(cutoff)
        err = normalize_angle(pose[2] - path_dir)
        return abs(err) <= self.planner_cfg.heading_yaw_error_threshold

    def is_goal_reached(self, pose: np.ndarray,
                        feedback_vel: tuple[float, float]) -> bool:
        """Termination query: both latches set -> consume them and force
        one more cycle."""
        if self.goal is None:
            return False
        if self.latch_xy and self.latch_yaw:
            self.latch_xy = False
            self.latch_yaw = False
            return False
        if self._is_position_reached(pose) and self._is_orientation_reached(
                pose, feedback_vel):
            self.state = DrivingState.REACHED_AND_IDLE
            return True
        return False

    # -- the hot path ------------------------------------------------------

    def compute_velocity_commands(self, pose: np.ndarray,
                                  feedback_vel: tuple[float, float]
                                  ) -> tuple[bool, tuple[float, float],
                                             CycleInfo]:
        """One control cycle, the span `planner.cycle` (`obs.span`): the
        plan's cutoff, truncation and the state machine (`planner.plan`),
        then the state's command (the Tracking state's: `planner.track`).
        Returns (ok, (v, w), info)."""
        with span("planner.cycle"):
            return self._cycle(pose, feedback_vel)

    def _cycle(self, pose, feedback_vel):
        t0 = time.perf_counter()
        with span("planner.plan"):
            pose = np.asarray(pose, float)
            if not self._initialized or self.global_plan is None:
                return False, (0.0, 0.0), None

            cut = plan_utils.cutoff_plan(self.global_plan, pose[:2])
            if len(cut) == 0:
                return False, (0.0, 0.0), None
            # the pruned plan stays the live global plan
            self.global_plan = cut
            cut = plan_utils.truncate_by_length(
                cut, self.planner_cfg.local_plan_length)

            position_reached = self._is_position_reached(pose)
            goal_reached = False
            below = False
            if position_reached:
                goal_reached = self._is_orientation_reached(pose,
                                                            feedback_vel)
            else:
                below = ((not self._can_rotate)
                         or self._below_heading_error(pose, cut))
            self.state = check_transition(
                self.state, position_reached=position_reached,
                goal_reached=goal_reached, below_heading_error=below)

        mpc_traj = None
        tracking_dbg = None
        ref_plan = np.zeros((0, cut.shape[1]))

        if self.state is DrivingState.REACHED_AND_IDLE:
            cmd = (0.0, 0.0)
        elif self.state is DrivingState.STOP_AND_ROTATE:
            # a family that cannot rotate stops; the stopped check then
            # completes the goal
            cmd = (rotate_command(pose[2], float(self.goal[2]),
                                  self.planner_cfg.rotate_p_gain)
                   if self._can_rotate else (0.0, 0.0))
        elif self.state is DrivingState.ROTATE_BEFORE_TRACKING:
            cmd = rotate_command(pose[2], plan_utils.path_heading(cut),
                                 self.planner_cfg.rotate_p_gain)
        else:  # TRACKING
            with span("planner.track"):
                cmd, ref_plan, mpc_traj, tracking_dbg = (
                    self._tracking_command(pose, feedback_vel, cut))

        info = CycleInfo(
            state=self.state, cmd=tuple(cmd), local_plan=cut,
            ref_plan=ref_plan, mpc_trajectory=mpc_traj,
            tracking=tracking_dbg, solve_time_s=time.perf_counter() - t0)
        if self.on_cycle is not None:
            self.on_cycle(info)
        return True, cmd, info
