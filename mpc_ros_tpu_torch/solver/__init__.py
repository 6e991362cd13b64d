from . import boxqp, ilqr
from .batch_lane import batch_solve_lane
from .types import SolveResult

__all__ = ["SolveResult", "batch_solve_lane", "boxqp", "ilqr"]
