"""The weight-scale-equivariant solver knobs (counterpart of
`W_DEFAULT_SUM`, `weight_scale` and `scaled_solver_knobs` in
`mpc_ros_tpu/models/costs.py`). The rest of that module (the FG_eval cost
and its expansions) is ROADMAP Queue 1, item 3."""

from __future__ import annotations

import torch

# the default MPCParams weight sum (100+100+100+100+50+10+10): the
# normalization anchor of the solver's weight-scale proxy
W_DEFAULT_SUM = 470.0


def weight_scale(p, dtype, device=None) -> torch.Tensor:
    """One-sided cost-magnitude proxy s = max(1, sum(weights)/470), 0-d or
    per-lane (B,) following the param leaves' shape. Scaling the solver's
    absolute knobs by s makes uniformly up-scaled problems solve with the
    c=1 iterates; down-scaled weights keep the absolute mu floor."""
    leaves = [torch.as_tensor(w, dtype=dtype, device=device)
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
        return torch.as_tensor(x, dtype=dtype, device=device)

    mu_min = t(cfg.mu_init_for(dtype, has_obstacles, has_omaps))
    mu_max = t(cfg.mu_max)
    if not cfg.scale_adaptive:
        return mu_min, mu_max, None, t(1.0)
    wscl = weight_scale(p, dtype, device)
    return mu_min * wscl, mu_max * wscl, 1.0 / wscl, wscl
