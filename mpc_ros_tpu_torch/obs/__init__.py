from .checkpoint import (restore_checkpoint, save_checkpoint, serving_state,
                         sweep_state)
from .metrics import CostBreakdown, RunStats, cost_breakdown
from .timers import PhaseTimers, collect, device_trace, span

__all__ = ["CostBreakdown", "RunStats", "cost_breakdown", "PhaseTimers",
           "collect", "device_trace", "span", "save_checkpoint",
           "restore_checkpoint", "serving_state", "sweep_state"]
