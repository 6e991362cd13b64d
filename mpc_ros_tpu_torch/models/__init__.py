from . import base, bicycle, diff_drive
from .base import Model, get_model, register_model

__all__ = ["base", "bicycle", "diff_drive", "Model", "get_model",
           "register_model"]
