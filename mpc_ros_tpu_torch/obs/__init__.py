from .metrics import CostBreakdown, RunStats, cost_breakdown

__all__ = ["CostBreakdown", "RunStats", "cost_breakdown"]
