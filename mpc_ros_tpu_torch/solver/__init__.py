from . import boxqp, ilqr, riccati
from .batch_lane import batch_solve_lane
from .ilqr import solve, solve_jit
from .types import SolveResult

__all__ = ["SolveResult", "solve", "solve_jit", "batch_solve_lane", "boxqp",
           "ilqr", "riccati"]
