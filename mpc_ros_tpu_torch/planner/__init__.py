from . import plan_utils
from .fsm import DrivingState, check_transition, rotate_command, seed_state
from .planner import CycleInfo, MPCPlanner
from .tracking import TrackingController, TrackingDebug
from .trajectory import TimedTrajectory, TrajectoryDebug, TrajectoryTracker

__all__ = [
    "DrivingState",
    "check_transition",
    "seed_state",
    "rotate_command",
    "MPCPlanner",
    "CycleInfo",
    "TrackingController",
    "TrackingDebug",
    "TimedTrajectory",
    "TrajectoryTracker",
    "TrajectoryDebug",
    "plan_utils",
]
