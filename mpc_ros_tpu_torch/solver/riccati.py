"""Horizon-parallel Riccati factorization by an associative scan
(counterpart of `mpc_ros_tpu/solver/riccati.py`).

The sequential Riccati recursion of `ilqr.backward_pass` is O(T) deep.
This module factorizes the same value recursion in O(log T) depth by
composing value-propagation maps with an associative operator (after
Sarkka & Garcia-Fernandez, "Temporal Parallelization of Bayesian
Smoothers", IEEE TAC 2021, applied to LQT).

Math. Completing the square in u removes the cross and linear control
terms of each stage, after which the stage is the 5-tuple element
e_k = (A^, b^, C, eta = -r^, J = X^) with the associative combination
(value convention V(x) = 1/2 x'Jx - eta'x)

    A = A2 (I + C1 J2)^-1 A1
    b = A2 (I + C1 J2)^-1 (b1 + C1 eta2) + b2
    C = A2 (I + C1 J2)^-1 C1 A2' + C2
    eta = A1' (I + J2 C1)^-1 (eta2 - J2 b1) + eta1
    J = A1' (I + J2 C1)^-1 J2 A1 + J1

and a reverse associative scan (`ops.scan.associative_scan`) yields every
value function at once; the gains follow stage by stage from the usual
Q expansion.

Layout. Every function takes any leading batch dims in front of the time
axis: A (..., T, n, n), l_s (..., T, n), V_s (..., n), V_ss (..., n, n),
where the JAX module takes one problem and is vmapped. The box-constrained
pass (`parallel_gains_boxed`) runs its active-set loop batch-first: a lane
whose clamp pattern is stable keeps its carry (as `jax.vmap` of its
`while_loop` does), and the loop reads "every lane stable" on the host
once per sweep.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..obs.timers import span
from ..ops.scan import associative_scan
from .boxqp import inv2, solve_boxqp_2d

# host reads of the active-set loop's exit condition (each the span
# `sync.riccati`) and sweeps run (every lane's sweep counted once per
# batch), summed over calls
host_reads = 0
sweeps = 0


class LQRElement(NamedTuple):
    A: torch.Tensor    # (..., n, n)
    b: torch.Tensor    # (..., n)
    C: torch.Tensor    # (..., n, n)
    eta: torch.Tensor  # (..., n)
    J: torch.Tensor    # (..., n, n)


def _T(M):
    return M.transpose(-1, -2)


def _mv(M, v):
    return torch.einsum("...ij,...j->...i", M, v)


def combine(e2: LQRElement, e1: LQRElement) -> LQRElement:
    """Associative combination of value-propagation elements. Note the
    argument order: the reverse scan calls the operator with the later
    element first; e1 spans the earlier interval."""
    n = e1.A.shape[-1]
    eye = torch.eye(n, dtype=e1.A.dtype, device=e1.A.device)
    # D = (I + C1 J2)^-1; E = (I + J2 C1)^-1 = D' for symmetric C1, J2
    M = eye + e1.C @ e2.J
    D = torch.linalg.solve(M, eye.expand(M.shape))
    A2D = e2.A @ D
    A = A2D @ e1.A
    b = _mv(A2D, e1.b + _mv(e1.C, e2.eta)) + e2.b
    C = A2D @ e1.C @ _T(e2.A) + e2.C
    E = _T(D)
    A1tE = _T(e1.A) @ E
    eta = _mv(A1tE, e2.eta - _mv(e2.J, e1.b)) + e1.eta
    J = A1tE @ e2.J @ e1.A + e1.J
    J = 0.5 * (J + _T(J))
    C = 0.5 * (C + _T(C))
    return LQRElement(A=A, b=b, C=C, eta=eta, J=J)


def reverse_scan(elems: LQRElement) -> LQRElement:
    """Every suffix combination of the elements, the time axis the one
    before the matrix dims."""
    return associative_scan(combine, elems, reverse=True,
                            dim=elems.A.dim() - 3)


def make_elements(A, B, l_s, l_u, l_ss, l_uu, l_us, V_s, V_ss,
                  ridge: float = 1e-9, free=None, d_c=None) -> LQRElement:
    """Per-stage elements, T + 1 of them along the time axis (the last is
    the terminal). A (..., T, n, n), B (..., T, n, m), l_ss (..., T, n, n),
    l_uu (..., T, m, m), l_us (..., T, m, n), l_s (..., T, n), l_u
    (..., T, m); V_s (..., n), V_ss (..., n, n) the terminal expansion.

    `ridge` keeps the closed-form 2x2 inverse finite on a singular control
    Hessian. With `free` (..., T, m), a 0/1 mask, and `d_c` (..., T, m),
    the fixed du of the clamped dims (zero on free dims), each stage is
    rebuilt with the clamped controls held at their bound offsets (affine
    dynamics and cost terms) and the square completed over the free dims
    only: the per-stage elimination of the control-limited sequential
    pass, as scan elements."""
    m = B.shape[-1]
    n = B.shape[-2]
    assert m == 2, "inv2 fast path expects control dim 2"
    eye_m = torch.eye(m, dtype=l_uu.dtype, device=l_uu.device)
    if free is not None:
        # du = du_F + d_c with du_C fixed: the constant folds into the
        # linear terms, the quadratic restricts to the free block (clamped
        # rows and cols of R become identity so inv2 stays finite), the
        # clamped B cols are zeroed
        l_s = l_s + torch.einsum("...mn,...m->...n", l_us, d_c)
        l_u = free * (l_u + torch.einsum("...mk,...k->...m", l_uu, d_c))
        l_us = free[..., :, None] * l_us
        l_uu = (free[..., :, None] * free[..., None, :] * l_uu
                + (1.0 - free)[..., :, None] * eye_m)
        b0 = torch.einsum("...nm,...m->...n", B, d_c)
        B = B * free[..., None, :]
    else:
        b0 = 0.0
    Rinv = inv2(l_uu + ridge * eye_m)                  # (..., T, m, m)
    BRinv = B @ Rinv                                   # (..., T, n, m)
    A_hat = A - BRinv @ l_us
    b_hat = b0 - torch.einsum("...nm,...m->...n", BRinv, l_u)
    C = BRinv @ _T(B)
    X_hat = l_ss - _T(l_us) @ Rinv @ l_us
    r_hat = l_s - torch.einsum("...mn,...mk,...k->...n", l_us, Rinv, l_u)
    lead = A.shape[:-3]
    z = dict(dtype=A.dtype, device=A.device)
    term = (torch.zeros(lead + (1, n, n), **z),
            torch.zeros(lead + (1, n), **z),
            torch.zeros(lead + (1, n, n), **z),
            -V_s[..., None, :], V_ss[..., None, :, :])
    leaf = (A_hat, b_hat, C, -r_hat, X_hat)
    d = A.dim() - 3
    return LQRElement(*(torch.cat([x, y.expand(x.shape[:d] + y.shape[d:])],
                                  dim=d) for x, y in zip(leaf, term)))


def parallel_value_functions(A, B, l_s, l_u, l_ss, l_uu, l_us, V_s, V_ss):
    """All value functions (P_k, p_k), k = 0..T, in O(log T) depth."""
    acc = reverse_scan(make_elements(A, B, l_s, l_u, l_ss, l_uu, l_us, V_s,
                                     V_ss))
    return acc.J, -acc.eta


def _gains_from(P_next, p_next, A, B, l_u, l_uu, l_us):
    Bt = _T(B)
    Q_u = l_u + _mv(Bt, p_next)
    Q_uu = l_uu + Bt @ P_next @ B
    Q_us = l_us + Bt @ P_next @ A
    return Q_u, Q_uu, Q_us


def parallel_gains(A, B, l_s, l_u, l_ss, l_uu, l_us, V_s, V_ss,
                   scan=reverse_scan):
    """Unconstrained LQR gains for every stage, computed in parallel.
    Returns (ks (..., T, m), Ks (..., T, m, n), Ps, ps): the sequential
    backward pass with inactive box bounds and mu = 0. `scan` runs the
    reverse scan (`parallel.sharded` passes its time-sharded one)."""
    acc = scan(make_elements(A, B, l_s, l_u, l_ss, l_uu, l_us, V_s, V_ss))
    Ps, ps = acc.J, -acc.eta
    d = A.dim() - 3
    P_next = Ps.narrow(d, 1, Ps.shape[d] - 1)
    p_next = ps.narrow(d, 1, ps.shape[d] - 1)
    Q_u, Q_uu, Q_us = _gains_from(P_next, p_next, A, B, l_u, l_uu, l_us)
    eye = torch.eye(2, dtype=Q_uu.dtype, device=Q_uu.device)
    Quu_inv = inv2(0.5 * (Q_uu + _T(Q_uu)) + 1e-9 * eye)
    ks = -_mv(Quu_inv, Q_u)
    Ks = -(Quu_inv @ Q_us)
    return ks, Ks, Ps, ps


def parallel_gains_boxed(A, B, l_s, l_u, l_ss, l_uu, l_us, V_s, V_ss,
                         lb_du, ub_du, mu=0.0, n_sweeps: int = 8,
                         scan=reverse_scan):
    """The exact control-limited horizon-parallel backward pass.

    Active-set iteration around the associative scan: guess each stage's
    clamp pattern (sweep 0: all free, the unconstrained scan), rebuild the
    elements with the clamped control dims eliminated
    (`make_elements(free=..., d_c=...)`), rescan, re-solve every stage's
    2-dim box QP against the new value functions, and repeat until the
    pattern (free mask and which bound) is stable, at most `n_sweeps`
    times. At a fixed point the value functions equal the sequential
    control-limited pass's. `mu` (0-d or (...,) per lane) regularizes each
    stage's box QP as `ilqr.backward_pass` does and is folded into l_uu
    for the value recursion.

    Batch-first: a lane whose pattern is stable keeps its carry, and each
    sweep after the first runs on the lanes still changing only (gathered,
    then scattered back), so a few lanes that need every sweep do not make
    the whole batch pay for them. Reading which lanes still change is the
    loop's one host read per sweep.

    lb_du, ub_du: (..., T, m) box bounds on the step du = u - u_bar.
    Returns (ks, Ks, Q_u, Q_uu, free): feedforwards with clamped dims at
    their bound offsets, gains with zero clamped rows, and the final Q
    expansion."""
    global host_reads, sweeps
    m, n = B.shape[-1], A.shape[-1]
    T = A.shape[-3]
    dtype, dev = A.dtype, A.device
    lead = A.shape[:-3]
    Bf = int(torch.Size(lead).numel())

    def rows(x, k):
        """x with the lead dims flattened into one batch dim (k trailing
        dims kept)."""
        x = torch.as_tensor(x, dtype=dtype, device=dev)
        return x.expand(lead + x.shape[x.dim() - k:]).reshape(
            (Bf,) + x.shape[x.dim() - k:])

    ins = [rows(x, k) for x, k in ((A, 3), (B, 3), (l_s, 2), (l_u, 2),
                                   (l_ss, 3), (l_uu, 3), (l_us, 3), (V_s, 1),
                                   (V_ss, 2), (lb_du, 2), (ub_du, 2))]
    mu_f = rows(mu, 0)
    eye_m = torch.eye(m, dtype=dtype, device=dev)

    def sweep(idx, free, d_c):
        if idx is None:
            A_, B_, ls, lu, lss, luu, lus, Vs, Vss, lb, ub = ins
            mu_q = mu_f[:, None, None, None]
        else:
            A_, B_, ls, lu, lss, luu, lus, Vs, Vss, lb, ub = (
                x.index_select(0, idx) for x in ins)
            mu_q = mu_f.index_select(0, idx)[:, None, None, None]
        acc = scan(make_elements(A_, B_, ls, lu, lss, luu + mu_q * eye_m, lus,
                                 Vs, Vss, free=free, d_c=d_c))
        P_next = acc.J[:, 1:]
        p_next = -acc.eta[:, 1:]
        # the Q expansion with the original stage quantities: the box QP
        # sees the true problem, only the value functions carry the
        # elimination
        Q_u, Q_uu, Q_us = _gains_from(P_next, p_next, A_, B_, lu, luu, lus)
        Q_uu = 0.5 * (Q_uu + _T(Q_uu))
        k, f, Minv = solve_boxqp_2d(Q_uu + mu_q * eye_m, Q_u, lb, ub)
        K = Minv @ (-(f[..., :, None] * Q_us))
        return k, K, Q_u, Q_uu, f

    z = dict(dtype=dtype, device=dev)
    free = torch.ones((Bf, T, m), **z)
    d_c = torch.zeros((Bf, T, m), **z)
    ks = torch.zeros((Bf, T, m), **z)
    Ks = torch.zeros((Bf, T, m, n), **z)
    Q_u = torch.zeros((Bf, T, m), **z)
    Q_uu = torch.zeros((Bf, T, m, m), **z)
    idx = None                        # None: every lane runs
    for _ in range(n_sweeps):
        sweeps += 1
        f_old = free if idx is None else free.index_select(0, idx)
        dc_old = d_c if idx is None else d_c.index_select(0, idx)
        ks_n, Ks_n, Q_u_n, Q_uu_n, free_n = sweep(idx, f_old, dc_old)
        d_c_n = (1.0 - free_n) * ks_n
        # stability includes which bound (a lo -> hi flip keeps free at 0
        # but moves d_c)
        ch = (torch.any(free_n != f_old, dim=(1, 2))
              | torch.any(d_c_n != dc_old, dim=(1, 2)))
        if idx is None:
            free, d_c, ks, Ks, Q_u, Q_uu = (free_n, d_c_n, ks_n, Ks_n,
                                            Q_u_n, Q_uu_n)
            idx = torch.arange(Bf, device=dev)
        else:
            for dst, src in ((free, free_n), (d_c, d_c_n), (ks, ks_n),
                             (Ks, Ks_n), (Q_u, Q_u_n), (Q_uu, Q_uu_n)):
                dst.index_copy_(0, idx, src)
        host_reads += 1
        with span("sync.riccati"):
            idx = idx[ch]
        if idx.numel() == 0:
            break

    def out(x, k):
        return x.reshape(lead + x.shape[x.dim() - k:])

    return (out(ks, 2), out(Ks, 3), out(Q_u, 2), out(Q_uu, 3),
            out(free, 2))
