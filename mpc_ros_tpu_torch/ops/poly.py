"""Polynomial fitting and evaluation (ascending coefficients c0 + c1 x +
c2 x^2 + ...).

Counterpart of `mpc_ros_tpu/ops/poly.py`: Horner evaluation in the same
operation order, and the least-squares fit by the Tikhonov-floored normal
equations.
"""

from __future__ import annotations

import torch

from .consts import const


def _zeros_like_broadcast(coeffs: torch.Tensor, x) -> torch.Tensor:
    c0 = coeffs[..., 0]
    x = const(x, c0.dtype, c0.device)
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


def vandermonde(x: torch.Tensor, order: int) -> torch.Tensor:
    """Vandermonde matrix (..., n, order+1) with ascending powers."""
    powers = torch.arange(order + 1, dtype=x.dtype, device=x.device)
    return x[..., :, None] ** powers


def polyfit(x: torch.Tensor, y: torch.Tensor, order: int,
            weights: torch.Tensor | None = None) -> torch.Tensor:
    """Least-squares polynomial fit, ascending coefficients (..., order+1),
    by the normal equations with a 1e-8 Tikhonov floor (which keeps padded
    or degenerate batches solvable). `weights` (..., n), 0 for padding rows
    and 1 for valid ones, masks a fit over a padded waypoint buffer; it
    applies once, on the A' side (A'WA c = A'Wy)."""
    A = vandermonde(x, order)                      # (..., n, P)
    Aw = A if weights is None else A * weights[..., :, None]
    AtA = torch.einsum("...ni,...nj->...ij", Aw, A)
    Aty = torch.einsum("...ni,...n->...i", Aw, y)
    AtA = AtA + 1e-8 * torch.eye(order + 1, dtype=x.dtype, device=x.device)
    return torch.linalg.solve(AtA, Aty[..., None])[..., 0]
