"""Model registry — pluggable vehicle dynamics (counterpart of
`mpc_ros_tpu/models/base.py`).

A `Model` carries a family's step function and control box bounds under
the registry's uniform signatures:

  step(z, u, coeffs, dt, sign, p)    -> z'   z (..., 6), u (..., 2),
                                              coeffs (..., P)
  control_bounds(p, dtype, device)   -> (lb, ub), each (2,) or (2, B)

The registry holds "diff_drive" and "bicycle". The Jacobians and the
augmented-state wrappers are not ported yet (ROADMAP Queue 1, item 3).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict


@dataclasses.dataclass(frozen=True)
class Model:
    """One vehicle-dynamics family."""

    name: str
    step: Callable
    control_bounds: Callable


_REGISTRY: Dict[str, Model] = {}


def register_model(model: Model) -> Model:
    """Add a family to the registry; a name registers once (a silent
    replacement would reroute every solve through other dynamics)."""
    if model.name in _REGISTRY:
        raise ValueError(f"model {model.name!r} is already registered")
    _REGISTRY[model.name] = model
    return model


def get_model(name: str) -> Model:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown model {name!r}; registered: {sorted(_REGISTRY)}"
        ) from None
