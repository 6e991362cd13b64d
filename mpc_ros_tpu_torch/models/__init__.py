from . import base, bicycle, costs, diff_drive
from .base import (Model, available_models, get_model, make_aug,
                   make_jacobians, model_from_step, register_model)

__all__ = ["base", "bicycle", "costs", "diff_drive", "Model",
           "available_models", "get_model", "make_aug", "make_jacobians",
           "model_from_step", "register_model"]
