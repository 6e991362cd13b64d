from ..solver.batch_lane import batch_solve_lane
from .batch import analytic_u_init, make_random_scenarios
from .receding import RecedingTrace, receding_horizon_rollout

__all__ = ["analytic_u_init", "batch_solve_lane", "make_random_scenarios",
           "RecedingTrace", "receding_horizon_rollout"]
