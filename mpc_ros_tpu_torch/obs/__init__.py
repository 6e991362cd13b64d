from .metrics import CostBreakdown, RunStats, cost_breakdown
from .timers import PhaseTimers, device_trace

__all__ = ["CostBreakdown", "RunStats", "cost_breakdown", "PhaseTimers",
           "device_trace"]
