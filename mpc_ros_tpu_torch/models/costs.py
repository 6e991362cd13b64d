"""Path-tracking NMPC cost — the reference's FG_eval objective, with its
exact quadratic expansion, and the weight-scale-equivariant solver knobs
(counterpart of `mpc_ros_tpu/models/costs.py`):

    J = sum_{i<N}   w_cte (cte_i - ref_cte)^2 + w_etheta (etheta_i -
                    ref_etheta)^2 + w_vel (v_i - ref_vel)^2
      + sum_{i<N-1} w_angvel omega_i^2 + w_accel a_i^2
      + sum_{i<N-2} w_angvel_d (omega_{i+1} - omega_i)^2
                  + w_accel_d (a_{i+1} - a_i)^2

The cost is quadratic in (v, cte, etheta, u), so the expansion below is
exact. Over the augmented state s = (z, prev_u), stage i is state_cost(z_i)
+ control_cost(u_i) + [i >= 1] rate_cost(u_i - prev_u_i), and the terminal
state_cost(z_T), T = N - 1.

Every function takes leading batch dims; an MPCParams leaf is a float, a
0-d tensor or a per-scenario tensor shaped to broadcast against z[..., 0].
`ref3` (..., 3) replaces the scalar (ref_cte, ref_etheta, ref_vel)
setpoints per knot (trajectory tracking); None keeps the scalar objective.
"""

from __future__ import annotations

import torch

from ..ops.consts import const
from .diff_drive import AUG_STATE_DIM, CONTROL_DIM, CTE, ETHETA, STATE_DIM, V


def _ref3_cols(p, ref3):
    """The three tracked setpoints: scalars from `p`, or per-knot rows."""
    if ref3 is None:
        return p.ref_cte, p.ref_etheta, p.ref_vel
    return ref3[..., 0], ref3[..., 1], ref3[..., 2]


def _vec(entries, dtype, device):
    """A (..., len(entries)) tensor from scalars or tensors, zeros where an
    entry is None, the leading dims broadcast."""
    ts = [None if e is None else const(e, dtype, device) for e in entries]
    shape = torch.broadcast_shapes(*[t.shape for t in ts if t is not None])
    zero = torch.zeros(shape, dtype=dtype, device=device)
    return torch.stack([zero if t is None else t.expand(shape) for t in ts],
                       dim=-1)


def ref_state_vector(p, dtype, ref3=None, batch_shape=(), device=None):
    """(..., 6) setpoint vector: zeros except the tracked (v, cte, etheta)
    entries; with `ref3` it carries the per-knot rows."""
    rc, re, rv = _ref3_cols(p, ref3)
    row = [None] * STATE_DIM
    row[V], row[CTE], row[ETHETA] = rv, rc, re
    ref = _vec(row, dtype, device)
    return ref.expand(tuple(batch_shape) + ref.shape) if ref.dim() == 1 \
        else ref


def state_weights(p, dtype, device=None):
    """(wz, ref): the tracked-state weight and setpoint vectors, (..., 6),
    shared by the stage expansion and the solver's terminal expansion."""
    w = [None] * STATE_DIM
    w[V], w[CTE], w[ETHETA] = p.w_vel, p.w_cte, p.w_etheta
    r = [None] * STATE_DIM
    r[V], r[CTE], r[ETHETA] = p.ref_vel, p.ref_cte, p.ref_etheta
    return _vec(w, dtype, device), _vec(r, dtype, device)


def state_cost(z: torch.Tensor, p, ref3=None) -> torch.Tensor:
    """Per-knot tracking cost on (cte, etheta, v): z (..., 6) -> (...)."""
    rc, re, rv = _ref3_cols(p, ref3)
    return (p.w_cte * (z[..., CTE] - rc) ** 2
            + p.w_etheta * (z[..., ETHETA] - re) ** 2
            + p.w_vel * (z[..., V] - rv) ** 2)


def total_cost(zs: torch.Tensor, us: torch.Tensor, p,
               ref3=None) -> torch.Tensor:
    """Full objective of trajectories: zs (..., N, 6), us (..., N-1, 2) ->
    (...). The MPCParams leaves broadcast against zs[..., 0] (a per-lane
    leaf of a (B, N, 6) batch is (B, 1)); `ref3` (..., N, 3)."""
    J = torch.sum(state_cost(zs, p, ref3), dim=-1)
    J = J + torch.sum(p.w_angvel * us[..., 0] ** 2
                      + p.w_accel * us[..., 1] ** 2, dim=-1)
    du = us[..., 1:, :] - us[..., :-1, :]
    J = J + torch.sum(p.w_angvel_d * du[..., 0] ** 2
                      + p.w_accel_d * du[..., 1] ** 2, dim=-1)
    return J


def stage_cost_aug(s: torch.Tensor, u: torch.Tensor, rate_on, p,
                   ref3=None) -> torch.Tensor:
    """Stage cost on the augmented state s = (z, prev_u); `rate_on` masks
    the rate term off at stage 0 (where prev_u is a placeholder)."""
    z = s[..., :STATE_DIM]
    pu = s[..., STATE_DIM:]
    du = u - pu
    c = state_cost(z, p, ref3)
    c = c + p.w_angvel * u[..., 0] ** 2 + p.w_accel * u[..., 1] ** 2
    c = c + rate_on * (p.w_angvel_d * du[..., 0] ** 2
                       + p.w_accel_d * du[..., 1] ** 2)
    return c


def stage_expansion_aug(s: torch.Tensor, u: torch.Tensor, rate_on, p,
                        ref3=None):
    """Exact quadratic expansion of `stage_cost_aug` around (s, u):
    (l_s (..., 8), l_u (..., 2), l_ss (..., 8, 8), l_uu (..., 2, 2),
    l_us (..., 2, 8)), all closed-form (the cost is quadratic). `ref3`
    shifts the setpoints; only the gradient moves."""
    dtype, dev = s.dtype, s.device
    z = s[..., :STATE_DIM]
    pu = s[..., STATE_DIM:]
    du = u - pu

    wz, ref = state_weights(p, dtype, dev)
    if ref3 is not None:
        ref = ref_state_vector(p, dtype, ref3, device=dev)
    rate_on = const(rate_on, dtype, dev)
    wu = _vec([p.w_angvel, p.w_accel], dtype, dev)
    wd = rate_on[..., None] * _vec([p.w_angvel_d, p.w_accel_d], dtype, dev)

    # gradients
    g_z = 2.0 * wz * (z - ref)
    g_pu = -2.0 * wd * du
    g_z, g_pu = (g.expand(torch.broadcast_shapes(g_z.shape[:-1],
                                                 g_pu.shape[:-1])
                          + g.shape[-1:]) for g in (g_z, g_pu))
    l_s = torch.cat([g_z, g_pu], dim=-1)
    l_u = 2.0 * wu * u + 2.0 * wd * du

    # Hessians (constant, diagonal blocks)
    batch = torch.broadcast_shapes(l_s.shape[:-1], l_u.shape[:-1])
    wz2 = (2.0 * wz).expand(batch + (STATE_DIM,))
    wd2 = (2.0 * wd).expand(batch + (CONTROL_DIM,))
    l_ss = torch.diag_embed(torch.cat([wz2, wd2], dim=-1))
    l_uu = torch.diag_embed((2.0 * (wu + wd)).expand(batch + (CONTROL_DIM,)))
    l_us = torch.zeros(batch + (CONTROL_DIM, AUG_STATE_DIM), dtype=dtype,
                       device=dev)
    l_us[..., 0, STATE_DIM] = -2.0 * wd[..., 0]
    l_us[..., 1, STATE_DIM + 1] = -2.0 * wd[..., 1]
    return (l_s.expand(batch + (AUG_STATE_DIM,)),
            l_u.expand(batch + (CONTROL_DIM,)), l_ss, l_uu, l_us)

# the default MPCParams weight sum (100+100+100+100+50+10+10): the
# normalization anchor of the solver's weight-scale proxy
W_DEFAULT_SUM = 470.0


def weight_scale(p, dtype, device=None) -> torch.Tensor:
    """One-sided cost-magnitude proxy s = max(1, sum(weights)/470), 0-d or
    per-lane (B,) following the param leaves' shape. Scaling the solver's
    absolute knobs by s makes uniformly up-scaled problems solve with the
    c=1 iterates; down-scaled weights keep the absolute mu floor."""
    leaves = [const(w, dtype, device)
              for w in (p.w_cte, p.w_etheta, p.w_vel, p.w_angvel, p.w_accel,
                        p.w_angvel_d, p.w_accel_d)]
    s = leaves[0]
    for w in leaves[1:]:
        s = s + w
    s = s * (1.0 / W_DEFAULT_SUM)
    return torch.maximum(s, torch.ones((), dtype=dtype, device=device))


def scaled_solver_knobs(cfg, p, dtype, device=None,
                        has_obstacles: bool = False,
                        has_omaps: bool = False):
    """(mu_min, mu_max, inv_scale or None, cost_guard) as tensors of
    `dtype`: the mu bounds scaled by s = weight_scale(p), the
    pg-normalization reciprocal 1/s and the relative-cost guard floor s
    under `cfg.scale_adaptive`; the absolute knobs, None and 1 without
    it."""
    def t(x):
        return const(x, dtype, device)

    mu_min = t(cfg.mu_init_for(dtype, has_obstacles, has_omaps))
    mu_max = t(cfg.mu_max)
    if not cfg.scale_adaptive:
        return mu_min, mu_max, None, t(1.0)
    wscl = weight_scale(p, dtype, device)
    return mu_min * wscl, mu_max * wscl, 1.0 / wscl, wscl
