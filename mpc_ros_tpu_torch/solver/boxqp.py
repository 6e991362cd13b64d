"""Exact small box-constrained QP by active-set enumeration (counterpart of
`mpc_ros_tpu/solver/boxqp.py`).

The control dimension is 2 (omega, accel), so all 3^2 active-set
combinations (free / at lower / at upper per dimension) are solved in
closed form and the KKT-consistent one is selected: exact for a strictly
convex QP, branchless, and batched over any leading dims.

The selection is the JAX module's: each clamped dimension adds 1e-12 (in
every dtype) to a combination's KKT violation, and the first least
violation wins, so exact ties prefer the combination with more free
dimensions. The kernels' box QP (`kernels/tiles.py::boxqp`,
`csrc/tiles.cuh`) and the lane path's take the first KKT-consistent
combination instead; this one is the single-scenario solver's.
"""

from __future__ import annotations

import functools
import itertools

import torch

# all (dim0, dim1) combos; 0 = free, 1 = at lower, 2 = at upper
_COMBOS = list(itertools.product(range(3), repeat=2))


@functools.lru_cache(maxsize=None)
def _tables(dtype, device):
    """The (9, 2) free / at-lower / at-upper indicator tables, built once
    per (dtype, device): a table built per call is a copy from pageable
    host memory per stage and iteration, which syncs the stream (and
    cannot be captured in a CUDA graph)."""
    return tuple(torch.tensor([[1.0 if s == side else 0.0 for s in c]
                               for c in _COMBOS], dtype=dtype, device=device)
                 for side in range(3))


def inv2(M: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of (..., 2, 2) matrices (adjugate / det)."""
    a = M[..., 0, 0]
    b = M[..., 0, 1]
    c = M[..., 1, 0]
    d = M[..., 1, 1]
    det = a * d - b * c
    inv = torch.stack([torch.stack([d, -b], dim=-1),
                       torch.stack([-c, a], dim=-1)], dim=-2)
    return inv / det[..., None, None]


def solve_boxqp_2d(Q: torch.Tensor, q: torch.Tensor, lb: torch.Tensor,
                   ub: torch.Tensor):
    """min_d 0.5 d'Q d + q'd  s.t. lb <= d <= ub, Q (..., 2, 2) SPD, q, lb,
    ub (..., 2).

    Returns (d, free_mask, Minv), (..., 2), (..., 2), (..., 2, 2):
    `free_mask` flags the optimal active set's free dimensions and `Minv`
    is the inverse of the masked system, so that the gain rows of clamped
    dimensions come out zero: K = Minv @ (-(free * Qus))."""
    dtype, dev = Q.dtype, Q.device
    f, at_lo, at_hi = _tables(dtype, dev)           # (9, 2) each
    Qc = Q[..., None, :, :]                          # (..., 1, 2, 2)
    qc = q[..., None, :]
    lbc = lb[..., None, :]
    ubc = ub[..., None, :]
    d_clamp = at_lo * lbc + at_hi * ubc              # (..., 9, 2)

    # masked system: free rows keep Q on free columns; clamped rows become
    # identity rows pinning d to the bound value
    eye_c = torch.diag_embed(1.0 - f)                # (9, 2, 2)
    M = Qc * (f[:, :, None] * f[:, None, :]) + eye_c
    rhs = (f * (-(qc + torch.einsum("...ij,...cj->...ci", Q, d_clamp)))
           + (1.0 - f) * d_clamp)
    Minv = inv2(M)                                   # (..., 9, 2, 2)
    d = torch.einsum("...cij,...cj->...ci", Minv, rhs)
    lam = qc + torch.einsum("...ij,...cj->...ci", Q, d)

    # KKT violations: free dims inside the box; at-lower dims need lam >= 0,
    # at-upper dims lam <= 0
    zero = torch.zeros((), dtype=dtype, device=dev)
    viol = torch.sum(
        f * (torch.maximum(lbc - d, zero) + torch.maximum(d - ubc, zero))
        + at_lo * torch.maximum(-lam, zero)
        + at_hi * torch.maximum(lam, zero), dim=-1)
    # prefer more-free combos on exact ties: a tiny penalty per clamped dim
    viol = viol + 1e-12 * torch.sum(1.0 - f, dim=-1)
    best = torch.argmin(viol, dim=-1)                # the first least
    idx = best[..., None, None]
    d_b = torch.gather(d, -2, idx.expand(best.shape + (1, 2)))[..., 0, :]
    f_b = f[best]
    Minv_b = torch.gather(
        Minv, -3, idx[..., None].expand(best.shape + (1, 2, 2)))[..., 0, :, :]
    return d_b, f_b, Minv_b
