"""The Riccati backward scan with inline linearization in one kernel: the
hand-written Hopper kernel (`csrc/backward_fused.cu`) and its plain
PyTorch version.

Counterpart of `mpc_ros_tpu/kernels/backward_fused_pallas.py` (`_kernel`,
launched by `backward_fused_pallas`), the backward half of the legacy
two-kernel route (`SolverConfig.backward="pallas"`): Gauss-Newton only,
diff-drive only. Each stage's Jacobians and cost quadratics are computed
from the raw trajectory slice, the A/B products follow the dynamics'
sparsity, and each stage solves the exact 2-D box QP.

Inputs are batch-last: ss (T+1, 8, B), us (T, 2, B), coeffs (P, B),
params (12, B) from `pack.pack_params`, V_s (8, B), V_ss (8, 8, B), lb/ub
(2, B), mu (B,). Outputs: ks (T, 2, B), Ks (T, 2, 8, B), dV1, dV2, pg
(B,). pg is the plain (not weight-scale normalized) projected gradient.

`backward_fused` sends CPU tensors to `backward_fused_plain` and CUDA
tensors to `backward_fused_cuda`, which launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from . import tiles
from .pack import (N_PAR, P_DT, P_RCTE, P_RETH, P_RVEL, P_WACC, P_WANG,
                   P_WCTE, P_WDACC, P_WDANG, P_WETH, P_WVEL)

_N = 8
_M = 2

# launches of the CUDA kernel by `backward_fused_cuda` (and nowhere else)
launches = 0


def _check_inputs(ss, us, coeffs, params, V_s, V_ss, lb, ub, mu):
    T = us.shape[0]
    B = us.shape[-1]
    want = {"ss": (ss, (T + 1, _N, B)), "us": (us, (T, _M, B)),
            "params": (params, (N_PAR, B)), "V_s": (V_s, (_N, B)),
            "V_ss": (V_ss, (_N, _N, B)), "lb": (lb, (_M, B)),
            "ub": (ub, (_M, B)), "mu": (mu, (B,))}
    for name, (a, shape) in want.items():
        if tuple(a.shape) != shape:
            raise ValueError(f"{name}: expected shape {shape}, got "
                             f"{tuple(a.shape)}")
    if coeffs.dim() != 2 or coeffs.shape[1] != B or coeffs.shape[0] < 1:
        raise ValueError(f"coeffs: expected (P, {B}), got "
                         f"{tuple(coeffs.shape)}")
    return T, B


# --------------------------------------------------------------- plain


def backward_fused_plain(ss, us, coeffs, params, sign, V_s, V_ss, lb, ub,
                         mu):
    """The plain PyTorch version of the kernel: `_kernel` of
    `backward_fused_pallas.py` transcribed onto (B,)-vectors with the whole
    batch as one tile, in the same operation order."""
    T, B = _check_inputs(ss, us, coeffs, params, V_s, V_ss, lb, ub, mu)
    dtype = ss.dtype
    par = params
    cf = coeffs
    dt = par[P_DT]
    wv2 = 2.0 * par[P_WVEL]
    wc2 = 2.0 * par[P_WCTE]
    we2 = 2.0 * par[P_WETH]
    ww2 = 2.0 * par[P_WANG]
    wa2 = 2.0 * par[P_WACC]
    zeros = torch.zeros((B,), dtype=dtype, device=ss.device)

    Vs, Vss = V_s, V_ss
    dv1 = dv2 = pg = zeros
    ks = [None] * T
    Ks = [None] * T
    for t in range(T - 1, -1, -1):
        s_t = ss[t]
        u_t = us[t]
        rate = 1.0 if t >= 1 else 0.0
        x, th, v, cte, eth = s_t[0], s_t[2], s_t[3], s_t[4], s_t[5]
        pu0, pu1 = s_t[6], s_t[7]
        ct, st = torch.cos(th), torch.sin(th)
        ce, se = torch.cos(eth), torch.sin(eth)
        fp = tiles.polyder(cf, x)
        # Jacobian structure: A has 15/64 nonzeros, B 5/16; every A/B
        # product below is expanded against that sparsity
        a02 = -v * st * dt
        a03 = ct * dt
        a12 = v * ct * dt
        a13 = st * dt
        a40 = fp
        a43 = sign * se * dt
        a45 = sign * v * ce * dt

        def At_vec(y):
            """A^T contraction over y's first axis: y (8, ...) -> (8, ...);
            rows 4, 6 and 7 are zero."""
            z = torch.zeros_like(y[0])
            return torch.stack([
                y[0] + a40 * y[4],
                y[1] - y[4],
                a02 * y[0] + a12 * y[1] + y[2],
                a03 * y[0] + a13 * y[1] + y[3] + a43 * y[4],
                z,
                a45 * y[4] + y[5],
                z,
                z,
            ])

        def Bt_vec(y):
            """B^T y for y (8, ...) -> (2, ...)."""
            return torch.stack([
                dt * (y[2] + y[5]) + y[6],
                dt * y[3] + y[7],
            ])

        wdw2 = 2.0 * rate * par[P_WDANG]
        wda2 = 2.0 * rate * par[P_WDACC]
        du0 = u_t[0] - pu0
        du1 = u_t[1] - pu1
        ls = torch.stack([
            zeros, zeros, zeros,
            wv2 * (v - par[P_RVEL]),
            wc2 * (cte - par[P_RCTE]),
            we2 * (eth - par[P_RETH]),
            -wdw2 * du0,
            -wda2 * du1,
        ])
        lu = torch.stack([
            ww2 * u_t[0] + wdw2 * du0,
            wa2 * u_t[1] + wda2 * du1,
        ])
        lss_diag = [zeros, zeros, zeros, wv2, wc2, we2, wdw2, wda2]
        luu00 = ww2 + wdw2
        luu11 = wa2 + wda2

        Qs = ls + At_vec(Vs)
        Qu = lu + Bt_vec(Vs)
        # VA = Vss @ A by A's column structure; rows stay dense
        VA = torch.stack([
            Vss[:, 0] + a40 * Vss[:, 4],
            Vss[:, 1] - Vss[:, 4],
            a02 * Vss[:, 0] + a12 * Vss[:, 1] + Vss[:, 2],
            a03 * Vss[:, 0] + a13 * Vss[:, 1] + Vss[:, 3] + a43 * Vss[:, 4],
            torch.zeros_like(Vss[:, 0]),
            a45 * Vss[:, 4] + Vss[:, 5],
            torch.zeros_like(Vss[:, 0]),
            torch.zeros_like(Vss[:, 0]),
        ], dim=1)                              # (8, 8, B), rows m, cols j
        AtVA = At_vec(VA)
        Qss = torch.stack([
            torch.stack([AtVA[i, j] + (lss_diag[i] if i == j else zeros)
                         for j in range(_N)]) for i in range(_N)
        ])
        BtVA = Bt_vec(VA)                      # (2, 8, B)
        # l_us couples u only with the previous-control slots (cols 6, 7)
        Qus = torch.stack([
            torch.stack([BtVA[0, j] + (-wdw2 if j == 6 else zeros)
                         for j in range(_N)]),
            torch.stack([BtVA[1, j] + (-wda2 if j == 7 else zeros)
                         for j in range(_N)]),
        ])
        VB0 = dt * (Vss[:, 2] + Vss[:, 5]) + Vss[:, 6]
        VB1 = dt * Vss[:, 3] + Vss[:, 7]
        BtVB = Bt_vec(torch.stack([VB0, VB1], dim=1))     # (2, 2, B)
        # Quu symmetrized through the off-diagonal mean only
        offd = 0.5 * (BtVB[0, 1] + BtVB[1, 0])
        Quu = torch.stack([
            torch.stack([BtVB[0, 0] + luu00, offd]),
            torch.stack([offd, BtVB[1, 1] + luu11]),
        ])
        Quu_reg = torch.stack([
            torch.stack([Quu[0, 0] + mu, Quu[0, 1]]),
            torch.stack([Quu[1, 0], Quu[1, 1] + mu]),
        ])

        k, K = tiles.boxqp(Quu_reg, Qu, lb - u_t, ub - u_t, Qus)

        Quu_k = tiles.mv(Quu, k, _M, _M)
        # Vs_n = Qs + K'(Quu k + Qu) + Qus' k (one folded matvec)
        ku = torch.stack([Quu_k[0] + Qu[0], Quu_k[1] + Qu[1]])
        Vs_n = Qs + tiles.mtv(K, ku, _N, _M) + tiles.mtv(Qus, k, _N, _M)
        KtQuu = tiles.mtm(K, Quu, _N, _M, _M)
        # Vss_n = Qss + K'Quu K + K'Qus + (K'Qus)': the upper triangle,
        # mirrored
        vrows = [[None] * _N for _ in range(_N)]
        for i2 in range(_N):
            for j2 in range(i2, _N):
                e = (Qss[i2, j2]
                     + KtQuu[i2, 0] * K[0, j2] + KtQuu[i2, 1] * K[1, j2]
                     + K[0, i2] * Qus[0, j2] + K[1, i2] * Qus[1, j2]
                     + K[0, j2] * Qus[0, i2] + K[1, j2] * Qus[1, i2])
                vrows[i2][j2] = e
                vrows[j2][i2] = e
        Vss = torch.stack([torch.stack(r) for r in vrows])
        Vs = Vs_n

        ks[t] = k
        Ks[t] = K
        dv1 = dv1 + (k[0] * Qu[0] + k[1] * Qu[1])
        dv2 = dv2 + 0.5 * (k[0] * Quu_k[0] + k[1] * Quu_k[1])
        pg_t = torch.maximum(
            torch.abs(u_t[0] - torch.clamp(u_t[0] - Qu[0], lb[0], ub[0])),
            torch.abs(u_t[1] - torch.clamp(u_t[1] - Qu[1], lb[1], ub[1])))
        pg = torch.maximum(pg, pg_t)
    return torch.stack(ks), torch.stack(Ks), dv1, dv2, pg


# ---------------------------------------------------------------- CUDA


def backward_fused_cuda(ss, us, coeffs, params, sign, V_s, V_ss, lb, ub,
                        mu):
    """Launch the hand-written kernel (`csrc/backward_fused.cu`) on CUDA
    float32 tensors; raises on anything else. Allocates every output;
    launches on the current stream and does not synchronize."""
    global launches
    args = (ss, us, coeffs, params, V_s, V_ss, lb, ub, mu)
    for a in args:
        if not a.is_cuda:
            raise ValueError("backward_fused_cuda needs CUDA tensors, got "
                             f"one on {a.device}")
        if a.dtype != torch.float32:
            raise ValueError("backward_fused_cuda computes in float32, got "
                             f"{a.dtype}")
        if a.device != ss.device:
            raise ValueError("backward_fused_cuda inputs must share a "
                             "device")
    T, B = _check_inputs(*args)
    P = coeffs.shape[0]
    if P > 8:
        raise ValueError(f"the kernel takes polynomials up to order 7 "
                         f"(P <= 8), got P={P}")
    if T < 1:
        raise ValueError(f"the kernel takes T >= 1, got T={T}")
    args = [a.contiguous() for a in args]
    from . import _build

    launch = _build.load("backward_fused")
    dev = ss.device

    def empty(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    outs = [empty(T, _M, B), empty(T, _M, _N, B), empty(B), empty(B),
            empty(B)]
    ptr = [ctypes.c_void_p(a.data_ptr()) for a in args + outs]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = launch(*ptr, ctypes.c_int(P), ctypes.c_int(B),
                     ctypes.c_int(T), ctypes.c_float(sign),
                     ctypes.c_void_p(stream))
    _build.check(launch, err, "backward_fused")
    launches += 1
    return tuple(outs)


def backward_fused(ss, us, coeffs, params, sign, V_s, V_ss, lb, ub, mu):
    """The fused backward scan: CPU tensors run `backward_fused_plain`,
    CUDA tensors the kernel (float32 only; anything else raises)."""
    fn = backward_fused_cuda if ss.is_cuda else backward_fused_plain
    return fn(ss, us, coeffs, params, sign, V_s, V_ss, lb, ub, mu)
