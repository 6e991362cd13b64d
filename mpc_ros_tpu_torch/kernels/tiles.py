"""Per-lane tile helpers: the plain PyTorch versions of the device
functions in `csrc/tiles.cuh`.

Counterparts of `_polyval_tile`, `_polyder_tile`, `_polyder2_tile`,
`_mtm`, `_mtv`, `_mv` and `_boxqp_tile` in
`mpc_ros_tpu/kernels/backward_pallas.py`, on batch-last `(..., B)`
tensors with the same operation order: Horner polynomials, per-lane small
matrix products, and the exact 2-D box QP by enumeration of the 9 clamp
combos (three reciprocals, first-wins ties by combo order, K assembled
once from the selected inverse entries).
"""

from __future__ import annotations

import itertools

import torch

COMBOS = list(itertools.product(range(3), repeat=2))


def polyval(c: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """f(x) = sum_i c[i] x^i; c (P, ...), x (...)."""
    P = c.shape[0]
    acc = c[P - 1]
    for i in range(P - 2, -1, -1):
        acc = c[i] + x * acc
    return acc.expand(x.shape)


def polyder(c: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """f'(x) (zero for constant polynomials)."""
    P = c.shape[0]
    if P == 1:
        return torch.zeros_like(x)
    acc = (P - 1.0) * c[P - 1]
    for i in range(P - 2, 0, -1):
        acc = float(i) * c[i] + x * acc
    return acc.expand(x.shape)


def polyder2(c: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """f''(x) (zero up to linear polynomials)."""
    P = c.shape[0]
    if P <= 2:
        return torch.zeros_like(x)
    acc = float((P - 1) * (P - 2)) * c[P - 1]
    for i in range(P - 2, 1, -1):
        acc = float(i * (i - 1)) * c[i] + x * acc
    return acc.expand(x.shape)


def mtm(X, Y, r: int, k: int, c: int) -> torch.Tensor:
    """Z[i,j] = sum_m X[m,i] Y[m,j]; X (k,r,...), Y (k,c,...) -> (r,c,...)."""
    rows = []
    for i in range(r):
        acc = X[0, i][None] * Y[0]
        for m in range(1, k):
            acc = acc + X[m, i][None] * Y[m]
        rows.append(acc)
    return torch.stack(rows)


def mtv(X, v, r: int, k: int) -> torch.Tensor:
    """y[i] = sum_m X[m,i] v[m]; X (k,r,...), v (k,...) -> (r,...)."""
    return torch.stack(
        [sum(X[m, i] * v[m] for m in range(k)) for i in range(r)])


def mv(X, v, r: int, k: int) -> torch.Tensor:
    """y[i] = sum_m X[i,m] v[m]; X (r,k,...), v (k,...) -> (r,...)."""
    return torch.stack(
        [sum(X[i, m] * v[m] for m in range(k)) for i in range(r)])


def boxqp(Quu, Qu, lbd, ubd, Qus):
    """Exact 2-D box QP per lane: min 0.5 d'Quu d + Qu'd, lbd <= d <= ubd.

    Quu (2,2,...), Qu (2,...), lbd/ubd (2,...), Qus (2,8,...) ->
    k (2,...) the step and K (2,8,...) the feedback gain, with K rows of
    clamped controls zero."""
    a, b = Quu[0, 0], Quu[0, 1]
    c, d = Quu[1, 0], Quu[1, 1]
    det = a * d - b * c
    rdet = 1.0 / det
    ra = 1.0 / a
    rd = 1.0 / d
    i00, i01 = d * rdet, -b * rdet
    i10, i11 = -c * rdet, a * rdet
    targ0 = {1: lbd[0], 2: ubd[0]}
    targ1 = {1: lbd[1], 2: ubd[1]}

    def pos(x):
        return torch.clamp(x, min=0.0)

    def lam_viol(lam, side):
        return pos(-lam if side == 1 else lam)

    cand_d = []
    cand_viol = []
    for c0, c1 in COMBOS:
        if c0 == 0 and c1 == 0:
            d0 = -(i00 * Qu[0] + i01 * Qu[1])
            d1 = -(i10 * Qu[0] + i11 * Qu[1])
            viol = (pos(lbd[0] - d0) + pos(d0 - ubd[0])
                    + pos(lbd[1] - d1) + pos(d1 - ubd[1]))
        elif c0 == 0:                      # u1 clamped, u0 free
            d1 = targ1[c1]
            d0 = -(Qu[0] + b * d1) * ra
            lam1 = Qu[1] + c * d0 + d * d1
            viol = (pos(lbd[0] - d0) + pos(d0 - ubd[0])
                    + lam_viol(lam1, c1) + 1e-12)
        elif c1 == 0:                      # u0 clamped, u1 free
            d0 = targ0[c0]
            d1 = -(Qu[1] + c * d0) * rd
            lam0 = Qu[0] + a * d0 + b * d1
            viol = (pos(lbd[1] - d1) + pos(d1 - ubd[1])
                    + lam_viol(lam0, c0) + 1e-12)
        else:                              # both clamped
            d0 = targ0[c0]
            d1 = targ1[c1]
            lam0 = Qu[0] + a * d0 + b * d1
            lam1 = Qu[1] + c * d0 + d * d1
            viol = lam_viol(lam0, c0) + lam_viol(lam1, c1) + 2e-12
        cand_d.append((d0, d1))
        cand_viol.append(viol)

    best_viol = cand_viol[0]
    for v in cand_viol[1:]:
        best_viol = torch.minimum(best_viol, v)

    zeros = torch.zeros_like(best_viol)
    picked, k0, k1 = zeros, zeros, zeros
    j00, j01, j10, j11 = zeros, zeros, zeros, zeros
    for idx, (c0, c1) in enumerate(COMBOS):
        sel = ((cand_viol[idx] <= best_viol) & (picked < 0.5)).to(a.dtype)
        picked = picked + sel
        d0, d1 = cand_d[idx]
        k0 = k0 + sel * d0
        k1 = k1 + sel * d1
        if c0 == 0 and c1 == 0:
            j00 = j00 + sel * i00
            j01 = j01 + sel * i01
            j10 = j10 + sel * i10
            j11 = j11 + sel * i11
        elif c0 == 0:                      # only u0 free: row0 = -Qus[0]/a
            j00 = j00 + sel * ra
        elif c1 == 0:                      # only u1 free: row1 = -Qus[1]/d
            j11 = j11 + sel * rd
    k = torch.stack([k0, k1])
    K = torch.stack([
        -(j00[None] * Qus[0] + j01[None] * Qus[1]),
        -(j10[None] * Qus[0] + j11[None] * Qus[1]),
    ])
    return k, K
