"""Model registry — pluggable vehicle dynamics (counterpart of
`mpc_ros_tpu/models/base.py`).

A `Model` carries a family's step function, its Jacobians, the
augmented-state variants of the rate-cost formulation and the control box
bounds under the registry's uniform signatures, every one batch-
polymorphic (leading dims broadcast; an MPCParams leaf is a float, a 0-d
tensor or a tensor that broadcasts against z[..., 0]):

  step(z, u, coeffs, dt, sign, p)               -> z'   z (..., 6),
                                                         u (..., 2),
                                                         coeffs (..., P)
  step_jacobians(z, u, coeffs, dt, sign, p)     -> (A (..., 6, 6),
                                                    B (..., 6, 2))
  aug_step(s, u, coeffs, dt, sign, p)           -> s' = (step(z, u), u)
  aug_step_jacobians(s, u, coeffs, dt, sign, p) -> (A (..., 8, 8),
                                                    B (..., 8, 2))
  control_bounds(p, dtype, device)              -> (lb, ub), each (2,) or
                                                   (2, B)

The registry holds "diff_drive" and "bicycle" with closed-form Jacobians;
`model_from_step` builds a family from a step function alone, its
Jacobians by forward-mode autodiff (`torch.func.jacfwd` under
`torch.func.vmap`). Grid obstacle maps (`ObstacleMap`) are in
`models/obstacles.py`.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import torch

from ..ops.consts import const

Fn = Callable


def _yaw_rate_direct(v, u0, p):
    """Default heading-rate map: the first control is the yaw rate
    (differential drive: u0 = omega)."""
    return u0


@dataclasses.dataclass(frozen=True)
class Model:
    """One vehicle-dynamics family (see the module docstring for the
    signatures). `yaw_rate(v, u0, p)` maps (speed, first control) to the
    heading rate; `can_rotate_in_place` is False for Ackermann families."""

    name: str
    step: Fn
    step_jacobians: Fn
    aug_step: Fn
    aug_step_jacobians: Fn
    control_bounds: Fn
    control_names: tuple = ("omega", "accel")
    yaw_rate: Fn = _yaw_rate_direct
    can_rotate_in_place: bool = True

    def rollout(self, z0, us, coeffs, dt, sign, p):
        """Roll the plant forward: z0 (..., 6), us (..., T, 2) -> states
        (..., T+1, 6)."""
        z = z0
        zs = [z0]
        for t in range(us.shape[-2]):
            z = self.step(z, us[..., t, :], coeffs, dt, sign, p)
            zs.append(z)
        return torch.stack(zs, dim=-2)


def make_aug(step: Fn, step_jacobians: Fn, state_dim: int = 6,
             control_dim: int = 2):
    """Generic augmented-state (z, prev_u) wrappers from a plain step: the
    augmentation turns the actuator-rate costs into Markov stage costs."""

    def aug_step(s, u, coeffs, dt, sign, p):
        z_next = step(s[..., :state_dim], u, coeffs, dt, sign, p)
        return torch.cat([z_next, u.expand(z_next.shape[:-1] + u.shape[-1:])],
                         dim=-1)

    def aug_step_jacobians(s, u, coeffs, dt, sign, p):
        A, B = step_jacobians(s[..., :state_dim], u, coeffs, dt, sign, p)
        batch = A.shape[:-2]

        def zeros(*shape):
            return torch.zeros(batch + shape, dtype=A.dtype, device=A.device)

        A_aug = torch.cat([
            torch.cat([A, zeros(state_dim, control_dim)], dim=-1),
            zeros(control_dim, state_dim + control_dim)], dim=-2)
        eye = torch.eye(control_dim, dtype=A.dtype, device=A.device)
        B_aug = torch.cat([B, eye.expand(batch + eye.shape)], dim=-2)
        return A_aug, B_aug

    return aug_step, aug_step_jacobians


def _leaf_items(p):
    """(name, value) of every MPCParams leaf."""
    return [(f.name, getattr(p, f.name)) for f in dataclasses.fields(p)]


def lane_map(fn, batch, coeffs, dt, p, *lanes):
    """fn(coeffs, dt, p, *lane_args) on single-scenario inputs, mapped
    with `torch.func.vmap` over the flattened `batch` shape: each of
    `lanes` (batch + (...)), and coeffs (..., P), dt and every tensor leaf
    of p broadcast to `batch` first, so a per-lane value reaches its own
    lane. Outputs come back with `batch` in front."""
    from torch.func import vmap

    def flat(a, tail):
        return a.expand(batch + tail).reshape((-1,) + tail)

    coeffs_f = flat(coeffs, coeffs.shape[-1:])
    names, leaves, dims = [], [], []
    for name, v in [("dt", dt)] + _leaf_items(p):
        names.append(name)
        if isinstance(v, torch.Tensor) and v.dim() > 0:
            leaves.append(flat(v, ()))
            dims.append(0)
        else:
            leaves.append(v)
            dims.append(None)
    lanes_f = [flat(a, a.shape[len(batch):]) for a in lanes]
    p_type = type(p)

    def single(c, leaf_vals, *args):
        vals = dict(zip(names, leaf_vals))
        dt_ = vals.pop("dt")
        return fn(c, dt_, p_type(**vals), *args)

    out = vmap(single, in_dims=(0, tuple(dims)) + (0,) * len(lanes_f))(
        coeffs_f, tuple(leaves), *lanes_f)
    # under vmap a 0-d value times a Python float can promote to the
    # default float type: the outputs come back in the lanes' dtype
    dtype = lanes_f[0].dtype
    if isinstance(out, torch.Tensor):
        return out.reshape(batch + out.shape[1:]).to(dtype)
    return tuple(o.reshape(batch + o.shape[1:]).to(dtype) for o in out)


def make_jacobians(step: Fn) -> Fn:
    """Exact (A, B) Jacobians of a plain step function by forward-mode
    autodiff — the CppAD-capability replacement: a `step` written with
    torch ops gets exact Jacobians from `torch.func.jacfwd`.

    Returns a `step_jacobians(z, u, coeffs, dt, sign, p) -> (A, B)` that
    accepts leading batch dims on z/u; coeffs, dt and tensor MPCParams
    leaves broadcast against them and are mapped per scenario."""
    from torch.func import jacfwd

    def single(coeffs, dt, p, z, u, sign):
        return jacfwd(lambda zz, uu: step(zz, uu, coeffs, dt, sign, p),
                      argnums=(0, 1))(z, u)

    def step_jacobians(z, u, coeffs, dt, sign, p):
        batch = torch.broadcast_shapes(z.shape[:-1], u.shape[:-1])
        z = z.expand(batch + z.shape[-1:])
        u = u.expand(batch + u.shape[-1:])
        dt = const(dt, z.dtype, z.device)
        return lane_map(lambda c, d, pp, zz, uu: single(c, d, pp, zz, uu,
                                                        sign),
                        batch, coeffs, dt, p, z, u)

    return step_jacobians


def model_from_step(name: str, step: Fn, control_bounds: Fn,
                    control_names: tuple = ("omega", "accel"),
                    register: bool = True,
                    allow_override: bool = False) -> Model:
    """Build (and by default register) a complete Model from a step
    function alone: its Jacobians by autodiff (`make_jacobians`), the
    rate-cost augmentation by `make_aug`.

    `step(z, u, coeffs, dt, sign, p)` is written with torch ops on the last
    axis (`z[..., i]`, `torch.stack(..., dim=-1)`), so that it takes
    leading batch dims; `control_bounds(p, dtype, device)` returns
    (lb, ub) on `device`, each (2,) or (2, B). The family then solves
    through `solver.ilqr.solve` and `engine.batch_solve`."""
    step_jacobians = make_jacobians(step)
    aug_step, aug_step_jacobians = make_aug(step, step_jacobians)
    mdl = Model(
        name=name,
        step=step,
        step_jacobians=step_jacobians,
        aug_step=aug_step,
        aug_step_jacobians=aug_step_jacobians,
        control_bounds=control_bounds,
        control_names=tuple(control_names),
    )
    if register:
        register_model(mdl, allow_override=allow_override)
    return mdl


_REGISTRY: Dict[str, Model] = {}


def register_model(model: Model, allow_override: bool = False) -> Model:
    """Add a family to the registry. Overwriting a name is refused unless
    `allow_override`: a silent replacement of e.g. 'diff_drive' would
    reroute every solve (the kernel dispatch included, which is keyed on
    the name) through other dynamics."""
    if model.name in _REGISTRY and not allow_override:
        raise ValueError(
            f"model {model.name!r} is already registered; pass "
            f"allow_override=True to replace it deliberately")
    _REGISTRY[model.name] = model
    return model


def get_model(name: str) -> Model:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown model {name!r}; registered: {sorted(_REGISTRY)}"
        ) from None


def available_models() -> tuple:
    return tuple(sorted(_REGISTRY))
