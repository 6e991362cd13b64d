from .checkpoint import (restore_checkpoint, save_checkpoint, serving_state,
                         sweep_state)
from .metrics import CostBreakdown, RunStats, cost_breakdown
from .timers import PhaseTimers, device_trace

__all__ = ["CostBreakdown", "RunStats", "cost_breakdown", "PhaseTimers",
           "device_trace", "save_checkpoint", "restore_checkpoint",
           "serving_state", "sweep_state"]
