"""Recovery supervision — the move_base recovery-ladder analog
(counterpart of `mpc_ros_tpu/planner/recovery.py`; plain Python on the
host around the port's `MPCPlanner`).

The reference delegates all failure recovery to its host: when
`computeVelocityCommands` returns false, move_base runs its recovery
behaviors (replan with the global planner, clear costmaps, RotateRecovery's
in-place spin) and aborts the goal when the ladder is exhausted
(SURVEY.md §5.3; mpc_ros/src/mpc_planner_ros.cpp:405-408
returns false exactly to trigger that external loop). This framework is
standalone, so the ladder lives here:

    NORMAL --k consecutive failures--> REPLAN (re-seed from the stored /
    freshly-requested global plan at the current pose) --still failing-->
    ROTATE (bounded in-place spin toward the path heading, probing the
    planner each cycle) --ladder exhausted--> ABORTED (zero command,
    operator reset required)

Replanning stands in for move_base's "global planner + costmap clearing"
behaviors: `replan_fn(pose)` may produce a fresh plan (user global
planner); without one the pristine plan from `set_plan` is re-issued,
which re-runs cutoff/seeding from the current pose. The rotate behavior
mirrors `rotate_recovery::RotateRecovery` (fixed angular speed, bounded
duration) but probes the planner every cycle instead of completing a
blind 2π.

Complements `planner.safety.SafetyMonitor`: the monitor validates commands
and fails safe (controlled stop); the supervisor actively tries to get
planning working again. `planner.node.PlannerNode` wires both.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Callable, Optional

import numpy as np

from . import plan_utils


class RecoveryState(enum.Enum):
    NORMAL = "normal"
    ROTATING = "rotating"
    ABORTED = "aborted"


@dataclasses.dataclass
class RecoveryConfig:
    # consecutive planner failures before the ladder engages (move_base's
    # max_planning_retries / planner_patience analog)
    failures_to_recover: int = 3
    # RotateRecovery analog: fixed in-place angular speed and a bounded
    # duration (expressed in control cycles so tests are clock-free)
    rotate_speed: float = 0.4          # [rad/s]
    rotate_cycles_max: int = 60        # ~6 s at 10 Hz
    # full ladder passes (replan -> rotate) before giving up, matching
    # move_base running its behavior list once then aborting
    max_rounds: int = 2


@dataclasses.dataclass
class RecoveryStats:
    failures: int = 0            # total failed planner cycles observed
    replans: int = 0             # recovery replans issued
    rotate_cycles: int = 0       # cycles spent in rotate recovery
    rounds: int = 0              # completed (replan -> rotate) passes
    aborts: int = 0              # times the ladder was exhausted
    last_reason: str = ""


class RecoverySupervisor:
    """Wraps an `MPCPlanner`'s per-cycle result with active recovery.

    Usage:

        sup = RecoverySupervisor(planner, period_s=0.1)
        sup.set_plan(plan, pose)               # instead of planner.set_plan
        ok, cmd = sup.on_cycle(ok, cmd, pose, feedback)
    """

    def __init__(self, planner, cfg: RecoveryConfig = RecoveryConfig(),
                 replan_fn: Optional[Callable] = None):
        self.planner = planner
        self.cfg = cfg
        # optional user global planner: pose (3,) -> plan (M, 3) or None
        self.replan_fn = replan_fn
        self.state = RecoveryState.NORMAL
        self.stats = RecoveryStats()
        self._plan: Optional[np.ndarray] = None
        self._consecutive = 0
        self._rotate_left = 0
        self._rotate_dir = 1.0
        self._round = 0
        # Ackermann-style families cannot spin in place: the rotate rung
        # degenerates to hold-and-retry (zero command, same cycle budget)
        self._can_rotate = True
        scfg = getattr(planner, "solver_cfg", None)
        if scfg is not None:
            try:
                from ..models.base import get_model

                self._can_rotate = get_model(scfg.model).can_rotate_in_place
            except Exception:
                pass

    # -- lifecycle -----------------------------------------------------------

    def set_plan(self, plan: np.ndarray, pose: np.ndarray,
                 feedback_vel: tuple[float, float] = (0.0, 0.0)) -> bool:
        """Store the pristine global plan and forward to the planner."""
        self._plan = np.asarray(plan, float).copy()
        self.reset()
        return self.planner.set_plan(plan, pose, feedback_vel)

    def reset(self) -> None:
        """Re-arm (new goal, or operator acknowledgment after an abort)."""
        self.state = RecoveryState.NORMAL
        self._consecutive = 0
        self._rotate_left = 0
        self._round = 0

    # -- the ladder ----------------------------------------------------------

    def on_cycle(self, ok: bool, cmd: tuple[float, float], pose, feedback
                 ) -> tuple[bool, tuple[float, float]]:
        """Supervise one planner cycle; returns the (ok, command) to apply."""
        pose = np.asarray(pose, float)
        if self.state is RecoveryState.ABORTED:
            return False, (0.0, 0.0)

        if self.state is RecoveryState.ROTATING:
            # the caller already ran the planner this cycle — its
            # (ok, cmd) IS the probe; re-invoking would double every solve
            # and planner-state mutation
            if ok:
                self._back_to_normal()
                return True, cmd
            self._rotate_left -= 1
            self.stats.rotate_cycles += 1
            if self._rotate_left <= 0:
                self._round += 1
                self.stats.rounds += 1
                if self._round >= self.cfg.max_rounds:
                    return self._abort("recovery ladder exhausted")
                return self._replan_then_rotate(pose, feedback)
            return True, self._rotate_cmd()

        # NORMAL
        if ok:
            self._consecutive = 0
            return True, cmd
        self._consecutive += 1
        self.stats.failures += 1
        if self._consecutive < self.cfg.failures_to_recover:
            # not yet the ladder's business; hold a stop command (the
            # SafetyMonitor downstream shapes the actual deceleration)
            return False, (0.0, 0.0)
        return self._replan_then_rotate(pose, feedback)

    # -- behaviors -----------------------------------------------------------

    def _replan_then_rotate(self, pose, feedback
                            ) -> tuple[bool, tuple[float, float]]:
        """Behavior 1: replan. If planning still fails, behavior 2: rotate."""
        plan = None
        if self.replan_fn is not None:
            plan = self.replan_fn(pose)
        if plan is None:
            plan = self._plan
        if plan is not None and len(plan) > 0:
            self.stats.replans += 1
            self.planner.set_plan(plan, pose)
            ok, cmd = self._probe(pose, feedback)
            if ok:
                self._back_to_normal()
                return True, cmd
        # rotate recovery: spin toward the path heading (if known); for a
        # family that cannot rotate in place this rung holds still and
        # keeps probing on the same cycle budget
        self.state = RecoveryState.ROTATING
        self._rotate_left = self.cfg.rotate_cycles_max
        self._rotate_dir = self._heading_dir(pose)
        self.stats.last_reason = "replan did not clear the failure"
        return True, self._rotate_cmd()

    def _rotate_cmd(self) -> tuple[float, float]:
        if not self._can_rotate:
            return (0.0, 0.0)
        return (0.0, self._rotate_dir * self.cfg.rotate_speed)

    def _probe(self, pose, feedback) -> tuple[bool, tuple[float, float]]:
        ok, cmd, _info = self.planner.compute_velocity_commands(
            pose, feedback)
        return bool(ok), cmd

    def _heading_dir(self, pose) -> float:
        plan = self.planner.global_plan
        if plan is None:
            plan = self._plan
        if plan is None or len(plan) == 0:
            return 1.0
        cut = plan_utils.cutoff_plan(np.asarray(plan, float), pose[:2])
        if len(cut) == 0:
            return 1.0
        from .fsm import normalize_angle

        err = normalize_angle(plan_utils.path_heading(cut) - float(pose[2]))
        return 1.0 if err >= 0.0 else -1.0

    def _back_to_normal(self) -> None:
        self.state = RecoveryState.NORMAL
        self._consecutive = 0
        self._rotate_left = 0
        self._round = 0

    def _abort(self, reason: str) -> tuple[bool, tuple[float, float]]:
        self.state = RecoveryState.ABORTED
        self.stats.aborts += 1
        self.stats.last_reason = reason
        return False, (0.0, 0.0)
