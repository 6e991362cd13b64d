from ..solver.batch_lane import batch_solve_lane
from .batch import (Scenario, analytic_u_init, batch_solve,
                    batch_solve_swept, make_random_scenarios)
from .presort import (PresortedResult, difficulty_features,
                      fit_difficulty_model, predict_difficulty,
                      solve_presorted)
from .receding import RecedingTrace, receding_horizon_rollout
from .sweep import SweepResult, sample_weight_candidates, tuning_sweep

__all__ = ["Scenario", "analytic_u_init", "batch_solve", "batch_solve_lane",
           "batch_solve_swept", "make_random_scenarios",
           "PresortedResult", "difficulty_features", "fit_difficulty_model",
           "predict_difficulty", "solve_presorted", "RecedingTrace",
           "receding_horizon_rollout", "SweepResult",
           "sample_weight_candidates", "tuning_sweep"]
