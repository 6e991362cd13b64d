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
`p.max_steer` are MPCParams leaves, scalar or per lane. The analytic
Jacobians come with the single-scenario solver (ROADMAP Queue 1, item 4).
"""

from __future__ import annotations

import torch

from ..ops.poly import polyeval
from .base import Model, register_model

DELTA, ACCEL = range(2)


def step(z: torch.Tensor, u: torch.Tensor, coeffs: torch.Tensor, dt,
         sign: float, p) -> torch.Tensor:
    """One ZOH-Euler step. z (..., 6), u (..., 2), coeffs (..., P)."""
    x, y, psi, v, cte, epsi = (z[..., i] for i in range(6))
    delta = u[..., DELTA]
    accel = u[..., ACCEL]
    dt = torch.as_tensor(dt, dtype=z.dtype, device=z.device)
    lf = torch.as_tensor(p.lf, dtype=z.dtype, device=z.device)
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


def control_bounds(p, dtype, device=None):
    """(lb, ub) for (delta, accel): (2,) for shared limits, (2, B) when
    either limit is a per-scenario (B,) leaf."""
    ms = torch.as_tensor(p.max_steer, dtype=dtype, device=device)
    mt = torch.as_tensor(p.max_throttle, dtype=dtype, device=device)
    ms, mt = torch.broadcast_tensors(ms, mt)
    lb = torch.stack([-ms, -mt])
    return lb, -lb


def _yaw_rate(v, delta, p):
    """Heading rate of the commanded kinematics: psi_dot = v delta / lf."""
    return v * delta / p.lf


MODEL = register_model(Model(
    name="bicycle",
    step=step,
    control_bounds=control_bounds,
))
