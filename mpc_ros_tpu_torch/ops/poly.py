"""Polynomial evaluation (ascending coefficients c0 + c1 x + c2 x^2 + ...).

Counterpart of `polyeval` / `polyder_eval` in `mpc_ros_tpu/ops/poly.py`:
Horner form, the same operation order.
"""

from __future__ import annotations

import torch


def _zeros_like_broadcast(coeffs: torch.Tensor, x) -> torch.Tensor:
    c0 = coeffs[..., 0]
    x = torch.as_tensor(x, dtype=c0.dtype, device=c0.device)
    return torch.zeros(torch.broadcast_shapes(c0.shape, x.shape),
                       dtype=c0.dtype, device=c0.device)


def polyeval(coeffs: torch.Tensor, x) -> torch.Tensor:
    """Evaluate sum_i coeffs[..., i] * x^i (Horner form).

    coeffs: (..., P); x: scalar or broadcastable to coeffs[..., 0]."""
    acc = _zeros_like_broadcast(coeffs, x)
    for i in range(coeffs.shape[-1] - 1, -1, -1):
        acc = acc * x + coeffs[..., i]
    return acc


def polyder_eval(coeffs: torch.Tensor, x) -> torch.Tensor:
    """Evaluate d/dx of the polynomial at x (Horner form on the
    derivative)."""
    acc = _zeros_like_broadcast(coeffs, x)
    for i in range(coeffs.shape[-1] - 1, 0, -1):
        acc = acc * x + i * coeffs[..., i]
    return acc
