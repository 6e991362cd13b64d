from . import frames, linspace, poly
from .poly import polyder_eval, polyeval, polyfit, vandermonde

__all__ = ["frames", "linspace", "poly", "polyder_eval", "polyeval",
           "polyfit", "vandermonde"]
