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
(`SolverConfig.cte_vsin_sign`, quirk Q11).
"""

from __future__ import annotations

import torch

from ..ops.poly import polyeval
from .base import Model, register_model

OMEGA, ACCEL = range(2)


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


def control_bounds(p, dtype, device=None):
    """(lb, ub) for (omega, accel): (2,) for shared limits, (2, B) when
    either limit is a per-scenario (B,) leaf."""
    mw = torch.as_tensor(p.max_angvel, dtype=dtype, device=device)
    mt = torch.as_tensor(p.max_throttle, dtype=dtype, device=device)
    mw, mt = torch.broadcast_tensors(mw, mt)
    lb = torch.stack([-mw, -mt])
    return lb, -lb


MODEL = register_model(Model(
    name="diff_drive",
    step=lambda z, u, c, dt, sign, p: step(z, u, c, dt, sign),
    control_bounds=control_bounds,
))
