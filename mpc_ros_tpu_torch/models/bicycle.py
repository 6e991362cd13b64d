"""Kinematic bicycle (Ackermann-steered) error-state model (counterpart of
`mpc_ros_tpu/models/bicycle.py`).

    state z = (x, y, psi, v, cte, epsi), control u = (delta, accel)

    x'    = x + v cos(psi) dt
    y'    = y + v sin(psi) dt
    psi'  = psi + (v / lf) delta dt          # lf: CoG -> front-axle distance
    v'    = v + accel dt
    cte'  = (f(x) - y) + sign * v sin(epsi) dt
    epsi' = epsi + (v / lf) delta dt

The same 6-state layout and cost as the differential drive; only the
heading rows and the steering bound (`p.max_steer`) differ. `p.lf` and
`p.max_steer` are MPCParams leaves, scalar or per lane. The closed-form
Jacobians and the augmented-state wrappers come with it.
"""

from __future__ import annotations

import torch

from ..ops.consts import const
from ..ops.poly import polyder_eval, polyeval
from .base import Model, make_aug, register_model

X, Y, PSI, V, CTE, EPSI = range(6)
DELTA, ACCEL = range(2)


def step(z: torch.Tensor, u: torch.Tensor, coeffs: torch.Tensor, dt,
         sign: float, p) -> torch.Tensor:
    """One ZOH-Euler step. z (..., 6), u (..., 2), coeffs (..., P)."""
    x, y, psi, v, cte, epsi = (z[..., i] for i in range(6))
    delta = u[..., DELTA]
    accel = u[..., ACCEL]
    dt = const(dt, z.dtype, z.device)
    lf = const(p.lf, z.dtype, z.device)
    f0 = polyeval(coeffs, x)
    dpsi = v / lf * delta * dt
    return torch.stack([
        x + v * torch.cos(psi) * dt,
        y + v * torch.sin(psi) * dt,
        psi + dpsi,
        v + accel * dt,
        (f0 - y) + sign * v * torch.sin(epsi) * dt,
        epsi + dpsi,
    ], dim=-1)


def step_jacobians(z, u, coeffs, dt, sign, p):
    """Closed-form (A, B) = (d step/dz, d step/du): (..., 6, 6), (..., 6, 2).
    """
    x = z[..., X]
    psi = z[..., PSI]
    v = z[..., V]
    epsi = z[..., EPSI]
    delta = u[..., DELTA]
    cp = torch.cos(psi)
    sp = torch.sin(psi)
    ce = torch.cos(epsi)
    se = torch.sin(epsi)
    fp = polyder_eval(coeffs, x)
    dt = const(dt, z.dtype, z.device)
    lf = const(p.lf, z.dtype, z.device)
    k = dt / lf                    # psi' / epsi' sensitivity scale
    dk_dv = delta * k              # d(v / lf * delta * dt) / dv
    dk_dd = v * k                  # d(.) / d delta
    shape = torch.broadcast_shapes(x.shape, fp.shape, dk_dv.shape,
                                   dk_dd.shape)
    zero = torch.zeros(shape, dtype=z.dtype, device=z.device)
    one = torch.ones_like(zero)

    def M(rows):
        return torch.stack([torch.stack([e.expand(shape) for e in r], dim=-1)
                            for r in rows], dim=-2)

    A = M([
        #      x       y        psi          v         cte     epsi
        [one, zero, -v * sp * dt, cp * dt, zero, zero],             # x'
        [zero, one, v * cp * dt, sp * dt, zero, zero],              # y'
        [zero, zero, one, dk_dv, zero, zero],                       # psi'
        [zero, zero, zero, one, zero, zero],                        # v'
        [fp, -one, zero, sign * se * dt, zero, sign * v * ce * dt],  # cte'
        [zero, zero, zero, dk_dv, zero, one],                       # epsi'
    ])
    B = M([
        [zero, zero],
        [zero, zero],
        [dk_dd, zero],         # psi'  <- delta
        [zero, dt * one],      # v'    <- accel
        [zero, zero],
        [dk_dd, zero],         # epsi' <- delta
    ])
    return A, B


def control_bounds(p, dtype, device=None):
    """(lb, ub) for (delta, accel): (2,) for shared limits, (2, B) when
    either limit is a per-scenario (B,) leaf."""
    ms = const(p.max_steer, dtype, device)
    mt = const(p.max_throttle, dtype, device)
    ms, mt = torch.broadcast_tensors(ms, mt)
    lb = torch.stack([-ms, -mt])
    return lb, -lb


def _yaw_rate(v, delta, p):
    """Heading rate of the commanded kinematics: psi_dot = v delta / lf."""
    return v * delta / p.lf


aug_step, aug_step_jacobians = make_aug(step, step_jacobians)

MODEL = register_model(Model(
    name="bicycle",
    step=step,
    step_jacobians=step_jacobians,
    aug_step=aug_step,
    aug_step_jacobians=aug_step_jacobians,
    control_bounds=control_bounds,
    control_names=("delta", "accel"),
    yaw_rate=_yaw_rate,
    # Ackermann steering cannot rotate in place
    can_rotate_in_place=False,
))
