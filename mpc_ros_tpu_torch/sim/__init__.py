from .logger import read_tracking_csv, write_tracking_csv
from .shapes import SHAPES, epitrochoid, get_shape, infinity, square
from .simulator import (BicyclePlant, ClosedLoopResult, UnicyclePlant,
                        make_plant, run_closed_loop)

__all__ = [
    "infinity",
    "epitrochoid",
    "square",
    "get_shape",
    "SHAPES",
    "UnicyclePlant",
    "BicyclePlant",
    "make_plant",
    "run_closed_loop",
    "ClosedLoopResult",
    "write_tracking_csv",
    "read_tracking_csv",
]
