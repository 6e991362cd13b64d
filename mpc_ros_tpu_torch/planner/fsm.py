"""Driving state machine: Tracking / RotateBeforeTracking / StopAndRotate /
ReachedAndIdle (counterpart of `mpc_ros_tpu/planner/fsm.py`): a plain enum
and transition functions on the host, at the control rate."""

from __future__ import annotations

import enum

import numpy as np


class DrivingState(enum.Enum):
    TRACKING = "Tracking"
    ROTATE_BEFORE_TRACKING = "RotateBeforeTracking"
    STOP_AND_ROTATE = "StopAndRotate"
    REACHED_AND_IDLE = "ReachedAndIdle"


def normalize_angle(a: float) -> float:
    """Wrap to [-pi, pi) — the host twin of `ops.frames.normalize_angle`."""
    return float((a + np.pi) % (2.0 * np.pi) - np.pi)


def check_transition(state: DrivingState, *, position_reached: bool,
                     goal_reached: bool,
                     below_heading_error: bool) -> DrivingState:
    """The reference's `checkStates` priorities: goal -> ReachedAndIdle;
    position -> StopAndRotate; a heading error too large ->
    RotateBeforeTracking (unless already rotating or tracking); else
    Tracking."""
    if goal_reached:
        return DrivingState.REACHED_AND_IDLE
    if position_reached:
        return DrivingState.STOP_AND_ROTATE
    if not below_heading_error:
        if state in (DrivingState.ROTATE_BEFORE_TRACKING,
                     DrivingState.TRACKING):
            return state
        return DrivingState.ROTATE_BEFORE_TRACKING
    return DrivingState.TRACKING


def seed_state(*, position_reached: bool,
               below_heading_error: bool) -> DrivingState:
    """The initial state on a new plan (the reference's `setPlan`)."""
    if position_reached:
        return DrivingState.STOP_AND_ROTATE
    if not below_heading_error:
        return DrivingState.ROTATE_BEFORE_TRACKING
    return DrivingState.TRACKING


def rotate_command(current_yaw: float, target_yaw: float,
                   p_gain: float = 0.5) -> tuple[float, float]:
    """The rotate states' P control: (v, w) = (0, p_gain * wrapped(target -
    current))."""
    err = normalize_angle(target_yaw - current_yaw)
    return 0.0, p_gain * err
