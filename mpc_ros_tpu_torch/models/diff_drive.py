"""Differential-drive error-state kinematic model (counterpart of
`mpc_ros_tpu/models/diff_drive.py`).

    state z = (x, y, theta, v, cte, etheta), control u = (omega, accel)

    x'      = x + v cos(theta) dt
    y'      = y + v sin(theta) dt
    theta'  = theta + omega dt
    v'      = v + accel dt
    cte'    = (f(x) - y) + sign * v sin(etheta) dt   # f = reference poly
    etheta' = etheta + omega dt

cte' uses the fresh polynomial error f(x) - y rather than propagating
cte (reference quirk Q10), and `sign` is the cte/etheta coupling sign
(`SolverConfig.cte_vsin_sign`, quirk Q11). The closed-form Jacobians and
the augmented state s = (z, prev_u) of the rate-cost formulation come
with it; every function takes leading batch dims.
"""

from __future__ import annotations

import torch

from ..ops.consts import const
from ..ops.poly import polyder_eval, polyeval
from .base import Model, make_aug, register_model

# state / control indices
X, Y, THETA, V, CTE, ETHETA = range(6)
OMEGA, ACCEL = range(2)

STATE_DIM = 6
CONTROL_DIM = 2
# augmented state for the rate-cost formulation: (z, prev_u)
AUG_STATE_DIM = STATE_DIM + CONTROL_DIM


def step(z: torch.Tensor, u: torch.Tensor, coeffs: torch.Tensor, dt,
         cte_vsin_sign: float = 1.0) -> torch.Tensor:
    """One ZOH-Euler step. z (..., 6), u (..., 2), coeffs (..., P)."""
    x, y, theta, v, cte, etheta = (z[..., i] for i in range(6))
    omega = u[..., OMEGA]
    accel = u[..., ACCEL]
    f0 = polyeval(coeffs, x)
    return torch.stack([
        x + v * torch.cos(theta) * dt,
        y + v * torch.sin(theta) * dt,
        theta + omega * dt,
        v + accel * dt,
        (f0 - y) + cte_vsin_sign * v * torch.sin(etheta) * dt,
        etheta + omega * dt,
    ], dim=-1)


def step_jacobians(z: torch.Tensor, u: torch.Tensor, coeffs: torch.Tensor,
                   dt, cte_vsin_sign: float = 1.0):
    """Closed-form (A, B) = (d step/dz, d step/du): (..., 6, 6), (..., 6, 2).
    """
    x = z[..., X]
    theta = z[..., THETA]
    v = z[..., V]
    etheta = z[..., ETHETA]
    ct = torch.cos(theta)
    st = torch.sin(theta)
    ce = torch.cos(etheta)
    se = torch.sin(etheta)
    fp = polyder_eval(coeffs, x)
    dt = const(dt, z.dtype, z.device)
    shape = torch.broadcast_shapes(x.shape, fp.shape, dt.shape)
    zero = torch.zeros(shape, dtype=z.dtype, device=z.device)
    one = torch.ones_like(zero)
    sign = cte_vsin_sign

    def M(rows):
        return torch.stack([torch.stack([e.expand(shape) for e in r], dim=-1)
                            for r in rows], dim=-2)

    A = M([
        #      x       y      theta         v        cte     etheta
        [one, zero, -v * st * dt, ct * dt, zero, zero],          # x'
        [zero, one, v * ct * dt, st * dt, zero, zero],           # y'
        [zero, zero, one, zero, zero, zero],                     # theta'
        [zero, zero, zero, one, zero, zero],                     # v'
        [fp, -one, zero, sign * se * dt, zero, sign * v * ce * dt],  # cte'
        [zero, zero, zero, zero, zero, one],                     # etheta'
    ])
    B = M([
        [zero, zero],
        [zero, zero],
        [dt * one, zero],    # theta'  <- omega
        [zero, dt * one],    # v'      <- accel
        [zero, zero],
        [dt * one, zero],    # etheta' <- omega
    ])
    return A, B


def _step_p(z, u, c, dt, sign, p):
    return step(z, u, c, dt, sign)


def _step_jacobians_p(z, u, c, dt, sign, p):
    return step_jacobians(z, u, c, dt, sign)


# the augmented step s = (z, prev_u) -> (step(z, u), u) and its Jacobians,
# by the one generic augmentation (base.make_aug)
_aug_step_p, _aug_jacs_p = make_aug(_step_p, _step_jacobians_p)


def aug_step(s: torch.Tensor, u: torch.Tensor, coeffs: torch.Tensor, dt,
             cte_vsin_sign: float = 1.0) -> torch.Tensor:
    return _aug_step_p(s, u, coeffs, dt, cte_vsin_sign, None)


def aug_step_jacobians(s: torch.Tensor, u: torch.Tensor,
                       coeffs: torch.Tensor, dt, cte_vsin_sign: float = 1.0):
    """Closed-form Jacobians of `aug_step`: (..., 8, 8), (..., 8, 2)."""
    return _aug_jacs_p(s, u, coeffs, dt, cte_vsin_sign, None)


def control_bounds(p, dtype, device=None):
    """(lb, ub) for (omega, accel): (2,) for shared limits, (2, B) when
    either limit is a per-scenario (B,) leaf."""
    mw = const(p.max_angvel, dtype, device)
    mt = const(p.max_throttle, dtype, device)
    mw, mt = torch.broadcast_tensors(mw, mt)
    lb = torch.stack([-mw, -mt])
    return lb, -lb


MODEL = register_model(Model(
    name="diff_drive",
    step=_step_p,
    step_jacobians=_step_jacobians_p,
    aug_step=_aug_step_p,
    aug_step_jacobians=_aug_jacs_p,
    control_bounds=control_bounds,
    control_names=("omega", "accel"),
))


def rollout(z0: torch.Tensor, us: torch.Tensor, coeffs: torch.Tensor, dt,
            cte_vsin_sign: float = 1.0) -> torch.Tensor:
    """Roll the plant forward: z0 (..., 6), us (..., T, 2) -> (..., T+1, 6).
    The kinematic model is also the closed-loop simulator's plant."""
    return MODEL.rollout(z0, us, coeffs, dt, cte_vsin_sign, None)
