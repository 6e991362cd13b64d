"""The scenario generator of the batch cells: a frozen copy of
`mpc_ros_tpu_torch.engine.batch.make_random_scenarios`, so that a change
to the program cannot change the benchmark's inputs.

Random tracking scenarios on the generator's device: perturbed initial
error states and random cubic reference paths in the robot frame,
coeffs ~ N(0, 1) * (0.1, 0.2, curve_scale, 0.05), v0 ~ U(0, 0.8),
cte = c0 + N * 0.3 pose_scale, etheta = atan(c1) + N * 0.2.
Returns z0s (B, 6), coeffs (B, 4).
"""

from __future__ import annotations

import torch


def make_random_scenarios(generator: torch.Generator, batch: int,
                          dtype=torch.float32, pose_scale: float = 0.3,
                          curve_scale: float = 0.25):
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
