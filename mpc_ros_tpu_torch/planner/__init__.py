from . import plan_utils
from .baselines import (DWAConfig, DWAPlanner, PurePursuitConfig,
                        PurePursuitPlanner)
from .fsm import DrivingState, check_transition, rotate_command, seed_state
from .fleet import FleetCycleInfo, FleetPlanner
from .fleet_device import DeviceFleetPlanner
from .planner import CycleInfo, MPCPlanner
from .recovery import (RecoveryConfig, RecoveryState, RecoveryStats,
                       RecoverySupervisor)
from .safety import SafetyConfig, SafetyMonitor, SafetyStatus
from .tracking import TrackingController, TrackingDebug
from .trajectory import (FleetTrajectoryTracker, TimedTrajectory,
                         TrajectoryDebug, TrajectoryTracker)

__all__ = [
    "DrivingState",
    "check_transition",
    "seed_state",
    "rotate_command",
    "MPCPlanner",
    "CycleInfo",
    "TrackingController",
    "TrackingDebug",
    "SafetyMonitor",
    "SafetyConfig",
    "SafetyStatus",
    "RecoverySupervisor",
    "RecoveryConfig",
    "RecoveryState",
    "RecoveryStats",
    "FleetPlanner",
    "DeviceFleetPlanner",
    "FleetCycleInfo",
    "FleetTrajectoryTracker",
    "TimedTrajectory",
    "TrajectoryTracker",
    "TrajectoryDebug",
    "PurePursuitConfig",
    "PurePursuitPlanner",
    "DWAConfig",
    "DWAPlanner",
    "plan_utils",
]
