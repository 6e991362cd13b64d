"""Batched receding-horizon serving: closed-loop MPC for B robots.

Counterpart of `mpc_ros_tpu/engine/receding.py`. Each cycle solves every
robot's NMPC problem warm-started from its previous solution (shifted by
one step), applies the first control, and advances each plant one period
with the same error-state kinematics the solver optimizes. The JAX
`lax.scan` over cycles is a Python loop here; on CUDA tensors every
cycle's solve runs on the card through `batch_solve_lane`'s dispatch (one
launch of the whole-solve kernel under "auto"). Per-robot Gaussian
obstacles (`blobs`) join every cycle's solve; the plant steps with the
configured family's kinematics (`get_model(cfg.model).step`), so bicycle
fleets serve as diff-drive ones do.

Each cycle is the span `serve.cycle` (`obs.span`), holding `serve.solve`,
`serve.plant_step` and `serve.warm_shift`; the stacking of the record
after the loop is `serve.stack`.
"""

from __future__ import annotations

import dataclasses

import torch

from ..config import SolverConfig
from ..models.base import get_model
from ..obs.timers import span
from ..solver.batch_lane import batch_solve_lane


@dataclasses.dataclass
class RecedingTrace:
    zs: torch.Tensor      # (n_cycles, B, 6) plant states per cycle
    us: torch.Tensor      # (n_cycles, B, 2) applied controls
    costs: torch.Tensor   # (n_cycles, B) solve costs
    iters: torch.Tensor   # (n_cycles, B) SQP iterations (warm-start signal)
    converged: torch.Tensor  # (n_cycles, B) convergence certificates


def receding_horizon_rollout(z0s: torch.Tensor, coeffs: torch.Tensor, p,
                             cfg: SolverConfig, n_cycles: int = 20,
                             blobs=None) -> RecedingTrace:
    """Run `n_cycles` closed-loop control cycles for B robots. z0s (B, 6)
    initial error states; coeffs (B, P) each robot's reference polynomial
    (robot frame, fixed over the run); `blobs` (a `GaussianObstacles` with
    (B, K) leaves) each robot's obstacles, in the same frame."""
    B = z0s.shape[0]
    T = cfg.n_controls
    dtype = z0s.dtype
    dt = torch.as_tensor(p.dt, dtype=dtype, device=z0s.device)
    sign = cfg.cte_vsin_sign
    mdl = get_model(cfg.model)
    zs = z0s
    warm = torch.zeros((B, T, 2), dtype=dtype, device=z0s.device)
    rec = []
    for _ in range(n_cycles):
        with span("serve.cycle"):
            with span("serve.solve"):
                res = batch_solve_lane(zs, coeffs, p, cfg, u_init=warm,
                                       blobs=blobs)
            u0 = res.us[:, 0, :]                        # (B, 2)
            with span("serve.plant_step"):
                zs_next = mdl.step(zs, u0, coeffs, dt, sign, p)
            with span("serve.warm_shift"):
                warm = torch.cat([res.us[:, 1:], res.us[:, -1:]], dim=1)
                rec.append((zs, u0, res.cost, res.n_iters, res.converged))
            zs = zs_next
    with span("serve.stack"):
        zs_t, us_t, costs_t, iters_t, conv_t = (torch.stack(r)
                                                for r in zip(*rec))
        return RecedingTrace(zs=zs_t, us=us_t, costs=costs_t,
                             iters=iters_t.to(torch.int32),
                             converged=conv_t)
