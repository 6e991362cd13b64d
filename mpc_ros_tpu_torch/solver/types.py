"""Solver result types (counterpart of `mpc_ros_tpu/solver/types.py`)."""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class SolveResult:
    """Result of a batched NMPC solve, batch-major like the JAX package:

    * `us` (B, T, 2): optimal controls (omega, accel);
    * `zs` (B, N, 6): predicted state horizon;
    * `cost` (B,): objective value;
    * `converged` (B,) bool: the convergence certificate fired;
    * `n_iters` (B,) int32: SQP iterations taken;
    * `grad_norm` (B,): final projected-gradient max-norm;
    * `reg` (B,): final Levenberg regularization.
    """

    us: torch.Tensor
    zs: torch.Tensor
    cost: torch.Tensor
    converged: torch.Tensor
    n_iters: torch.Tensor
    grad_norm: torch.Tensor
    reg: torch.Tensor

    @property
    def control(self) -> torch.Tensor:
        """First control (omega0, accel0) of each scenario."""
        return self.us[..., 0, :]
