"""Batched scenario generation and cold starts (counterpart of
`mpc_ros_tpu/engine/batch.py::make_random_scenarios` and
`analytic_u_init`)."""

from __future__ import annotations

import torch

from ..models.base import get_model


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
