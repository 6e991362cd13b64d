from . import frames, poly
from .poly import polyder_eval, polyeval, polyfit, vandermonde

__all__ = ["frames", "poly", "polyder_eval", "polyeval", "polyfit",
           "vandermonde"]
