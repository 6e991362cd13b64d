"""Golden CPU oracle: the reference NLP solved whole in float64 with scipy
(counterpart of `mpc_ros_tpu/solver/oracle.py`).

It rebuilds the NLP the reference handed to Ipopt
(`mpc_ros/src/mpc_planner.cpp:265-375` of the reference planner):

* decision vector [x(N), y(N), theta(N), v(N), cte(N), etheta(N),
  omega(N-1), a(N-1)],
* objective: the same `total_cost` the solvers minimize,
* 6N constraints: per block the initial row pinned to the measured state,
  then the N-1 dynamics defects,
* box bounds: states +-bound_value, the family's control box,
* cold start: zeros but the initial state.

SLSQP (active-set SQP, the default) or trust-constr (interior point, the
closer analog of Ipopt), in float64 on the CPU; the objective's gradient
is exact, from `torch.autograd` in float64, and the constraints' Jacobian
is assembled from the family's exact step Jacobians (the JAX package
takes both from jax).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..config import MPCParams, SolverConfig
from ..models.base import get_model
from ..models.costs import total_cost

_F64 = torch.float64


@dataclasses.dataclass
class OracleResult:
    us: np.ndarray        # (N-1, 2)
    zs: np.ndarray        # (N, 6)
    cost: float
    success: bool
    status: str
    kkt_violation: float  # max |dynamics defect| at the solution


def _build_funcs(coeffs: np.ndarray, p: MPCParams, N: int,
                 cte_vsin_sign: float = 1.0, extra_cost=None,
                 model: str = "diff_drive", refs=None):
    """Objective, its gradient, the constraints and their Jacobian on the
    flat reference-layout vector (numpy in, numpy out; float64 torch
    inside)."""
    mdl = get_model(model)
    p = p.astype(_F64)
    coeffs = torch.as_tensor(np.array(coeffs, np.float64))
    dt = torch.as_tensor(p.dt, dtype=_F64)
    if refs is not None:
        refs = torch.as_tensor(np.array(refs, np.float64))

    def unpack(v):
        zs = torch.stack([v[i * N:(i + 1) * N] for i in range(6)], dim=-1)
        us = torch.stack([v[6 * N:6 * N + (N - 1)], v[6 * N + (N - 1):]],
                         dim=-1)
        return zs, us

    def objective(v):
        zs, us = unpack(v)
        c = total_cost(zs, us, p, refs)
        if extra_cost is not None:
            c = c + extra_cost(zs, us)
        return c

    def constraints(v):
        zs, us = unpack(v)
        # per block the initial row, then the N-1 defects of that block
        # (fg[1 + block_start + {0, 1+i}] in FG_eval)
        preds = mdl.step(zs[:-1], us, coeffs, dt, cte_vsin_sign, p)
        defects = zs[1:] - preds                       # (N-1, 6)
        return torch.cat([torch.cat([zs[0, j:j + 1], defects[:, j]])
                          for j in range(6)])

    def t(v):
        return torch.as_tensor(v, dtype=_F64)

    def obj(v):
        return float(objective(t(v)))

    def grad(v):
        x = t(v).clone().requires_grad_(True)
        (g,) = torch.autograd.grad(objective(x), x)
        return g.numpy()

    def con(v):
        return constraints(t(v)).numpy()

    n_vars = 6 * N + 2 * (N - 1)
    rows = np.arange(N - 1)

    def jac(v):
        # the constraints' Jacobian assembled from the family's per-stage
        # (A, B) = d step / d(z, u): row j N + 1 + i of block j is
        # z[i+1, j] - step(z[i], u[i])[j]
        zs, us = unpack(t(v))
        A, Bm = mdl.step_jacobians(zs[:-1], us, coeffs, dt, cte_vsin_sign,
                                   p)
        A, Bm = A.numpy(), Bm.numpy()
        J = np.zeros((6 * N, n_vars))
        for j in range(6):
            J[j * N, j * N] = 1.0
            r = j * N + 1 + rows
            J[r, j * N + 1 + rows] = 1.0
            for k in range(6):
                J[r, k * N + rows] -= A[:, j, k]
            for m in range(2):
                J[r, 6 * N + m * (N - 1) + rows] -= Bm[:, j, m]
        return J

    return obj, grad, con, jac


def solve_oracle(z0: np.ndarray, coeffs: np.ndarray, p: MPCParams,
                 cfg: SolverConfig, method: str = "SLSQP",
                 u_init: Optional[np.ndarray] = None,
                 maxiter: int = 500, extra_cost=None,
                 refs: Optional[np.ndarray] = None) -> OracleResult:
    """Solve the whole reference NLP in float64 on the CPU.

    `extra_cost(zs, us) -> scalar` (float64 torch) joins the objective —
    obstacle penalties checked against the same NLP. `refs` (N, 3) =
    per-knot (ref_cte, ref_etheta, ref_vel) profiles."""
    from scipy import optimize

    N = cfg.n_steps
    n_vars = cfg.n_vars
    z0 = np.asarray(z0, np.float64)
    obj, grad, con, jac = _build_funcs(np.asarray(coeffs), p, N,
                                       cfg.cte_vsin_sign, extra_cost,
                                       cfg.model, refs)

    # cold start: zeros, the initial state written in
    v0 = np.zeros(n_vars)
    for j in range(6):
        v0[j * N] = z0[j]
    if u_init is not None:
        u_init = np.asarray(u_init, np.float64)
        v0[6 * N:6 * N + (N - 1)] = u_init[:, 0]
        v0[6 * N + (N - 1):] = u_init[:, 1]

    bv = float(p.bound_value)
    # the family's control box (asymmetric boxes honoured)
    u_lb, u_ub = get_model(cfg.model).control_bounds(p.astype(_F64), _F64)
    lb = np.concatenate([
        np.full(6 * N, -bv),
        np.full(N - 1, float(u_lb[0])), np.full(N - 1, float(u_lb[1])),
    ])
    ub = np.concatenate([
        np.full(6 * N, bv),
        np.full(N - 1, float(u_ub[0])), np.full(N - 1, float(u_ub[1])),
    ])

    # constraint targets: 0 but the initial rows pinned to the state
    g_target = np.zeros(6 * N)
    for j in range(6):
        g_target[j * N] = z0[j]

    def g_fun(v):
        return con(v) - g_target

    if method == "SLSQP":
        res = optimize.minimize(
            obj, v0, jac=grad, bounds=optimize.Bounds(lb, ub),
            constraints=[{"type": "eq", "fun": g_fun, "jac": jac}],
            method="SLSQP", options={"maxiter": maxiter, "ftol": 1e-14},
        )
    elif method == "trust-constr":
        res = optimize.minimize(
            obj, v0, jac=grad, bounds=optimize.Bounds(lb, ub),
            constraints=[optimize.NonlinearConstraint(g_fun, 0.0, 0.0,
                                                      jac=jac)],
            method="trust-constr",
            options={"maxiter": maxiter * 4, "gtol": 1e-12, "xtol": 1e-14},
        )
    else:
        raise ValueError(f"unknown oracle method: {method}")

    v = res.x
    zs = np.stack([v[i * N:(i + 1) * N] for i in range(6)], axis=-1)
    us = np.stack([v[6 * N:6 * N + (N - 1)], v[6 * N + (N - 1):]], axis=-1)
    kkt = float(np.max(np.abs(g_fun(v))))
    return OracleResult(
        us=us, zs=zs, cost=float(res.fun), success=bool(res.success),
        status=str(getattr(res, "message", "")), kkt_violation=kkt,
    )
