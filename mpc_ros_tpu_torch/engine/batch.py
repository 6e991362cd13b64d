"""Batched scenario solving over the registry-generic solver, scenario
generation and cold starts (counterpart of `mpc_ros_tpu/engine/batch.py`).

Two entry points run `solver.ilqr.solve`, which is batch-first:

* `batch_solve`       — shared MPCParams across the batch (serving);
* `batch_solve_swept` — per-scenario MPCParams, every leaf (B,)
  (Monte-Carlo tuning sweeps).

Any registered family runs here, `model_from_step` families included;
`solver.batch_lane.batch_solve_lane` is the throughput path of the two
lane-specialized families.
"""

from __future__ import annotations

import dataclasses

import torch

from ..models.base import get_model
from ..solver import ilqr
from ..solver.types import SolveResult


@dataclasses.dataclass
class Scenario:
    """One NMPC problem instance (every leaf batchable)."""

    z0: torch.Tensor      # (6,) initial state
    coeffs: torch.Tensor  # (P,) reference-polynomial coefficients


def batch_solve(z0s: torch.Tensor, coeffs: torch.Tensor, p, cfg,
                u_init=None, refs=None, blobs=None) -> SolveResult:
    """Solve B scenarios with shared params: z0s (B, 6), coeffs (B, P),
    on z0s's device. `u_init` (B, T, 2) warm-starts; `refs` (B, N, 3) are
    per-scenario setpoint profiles and `blobs` (a `GaussianObstacles`,
    leaves (B, K)) per-scenario obstacles; the two compose."""
    return ilqr.solve(z0s, coeffs, p, cfg, u_init=u_init, refs=refs,
                      blobs=blobs)


def batch_solve_swept(z0s: torch.Tensor, coeffs: torch.Tensor, ps,
                      cfg) -> SolveResult:
    """Solve B scenarios with per-scenario params (every MPCParams leaf
    (B,))."""
    return ilqr.solve(z0s, coeffs, ps, cfg)


def make_random_scenarios(generator: torch.Generator, batch: int,
                          dtype=torch.float32, pose_scale: float = 0.3,
                          curve_scale: float = 0.25):
    """Random tracking scenarios on the generator's device: perturbed
    initial error states + random cubic reference paths (robot frame).

    The distributions equal the JAX package's: coeffs ~ N(0, 1) * (0.1,
    0.2, curve_scale, 0.05), v0 ~ U(0, 0.8), cte = c0 + N * 0.3
    pose_scale, etheta = atan(c1) + N * 0.2. The draws come from `generator`,
    so they are distribution-equal to the JAX version, not bit-equal.
    Returns z0s (B, 6), coeffs (B, 4)."""
    B = batch
    kw = dict(dtype=dtype, device=generator.device, generator=generator)
    scale = torch.tensor([0.1, 0.2, curve_scale, 0.05], dtype=dtype,
                         device=generator.device)
    coeffs = torch.randn((B, 4), **kw) * scale
    v0 = torch.rand((B,), **kw) * 0.8
    cte = coeffs[:, 0] + torch.randn((B,), **kw) * (pose_scale * 0.3)
    etheta = torch.atan(coeffs[:, 1]) + torch.randn((B,), **kw) * 0.2
    zeros = torch.zeros_like(v0)
    z0s = torch.stack([zeros, zeros, zeros, v0, cte, etheta], dim=-1)
    return z0s, coeffs


def analytic_u_init(z0s, coeffs, p, cfg):
    """Analytic cold start (opt-in): a decaying proportional steer toward
    the path plus an accelerate-to-setpoint column,

        omega_k = clip(-1.2 etheta0 - 0.6 cte0, bounds) * exp(-0.15 k)
        accel_k = clip(ref_vel - v0, bounds)

    Returns (B, T, 2) for `batch_solve_lane(..., u_init=...)`."""
    dtype = z0s.dtype
    dev = z0s.device
    T = cfg.n_controls
    lb, ub = get_model(cfg.model).control_bounds(p, dtype, dev)
    # (2,) broadcasts over (B, T, 2); per-lane (2, B) bounds need the T
    # axis inserted: (B, 1, 2)
    lb2 = lb if lb.dim() == 1 else lb.T[:, None, :]
    ub2 = ub if ub.dim() == 1 else ub.T[:, None, :]
    w0 = -1.2 * z0s[:, 5] - 0.6 * z0s[:, 4]
    a0 = torch.as_tensor(p.ref_vel, dtype=dtype, device=dev) - z0s[:, 3]
    decay = torch.exp(torch.tensor(-0.15, dtype=dtype, device=dev)
                      * torch.arange(T, dtype=dtype, device=dev))
    u = torch.stack([w0[:, None] * decay[None, :],
                     a0[:, None].expand(z0s.shape[0], T)], dim=-1)
    return torch.clamp(u, lb2.expand(u.shape), ub2.expand(u.shape))
