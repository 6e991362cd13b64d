from .poly import polyder_eval, polyeval

__all__ = ["polyder_eval", "polyeval"]
