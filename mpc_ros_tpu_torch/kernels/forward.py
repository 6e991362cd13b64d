"""The fused multi-alpha line search in one kernel: the hand-written Hopper
kernel (`csrc/forward.cu`) and its plain PyTorch version.

Counterpart of `mpc_ros_tpu/kernels/forward_pallas.py` (`_kernel`,
launched by `forward_pallas`), the forward half of the legacy two-kernel
route (`SolverConfig.backward="pallas"`). One call does, per scenario:
closed-loop rollouts for every step size alpha = 0.5^j (j < n_alpha)
with the FG_eval cost; acceptance of the first (largest) alpha that
lowers the cost; and the re-roll of the winner, written through the mask
upd = accepted * act with the multiply blend upd*new + (1-upd)*old, so
rejected and inactive lanes pass their trajectory through. K arrives as
an input, so the feedback sums all 8 columns; trigonometry is exact.

Inputs are batch-last: ss (T+1, 8, B), us (T, 2, B), ks (T, 2, B), Ks
(T, 2, 8, B), coeffs (P, B), params (12, B), lb/ub (2, B), cost (B,),
act (B,) in {0, 1}. Outputs: ss (T+1, 8, B), us (T, 2, B), cost (B,),
accepted (B,) in {0, 1}.

`forward` sends CPU tensors to `forward_plain` and CUDA tensors to
`forward_cuda`, which launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from . import tiles
from .pack import (N_PAR, P_DT, P_RCTE, P_RETH, P_RVEL, P_WACC, P_WANG,
                   P_WCTE, P_WDACC, P_WDANG, P_WETH, P_WVEL)

_N = 8
_M = 2
MAX_ALPHA = 8

# launches of the CUDA kernel by `forward_cuda` (and nowhere else)
launches = 0


def _check_inputs(ss, us, ks, Ks, coeffs, params, lb, ub, cost, act,
                  n_alpha):
    T = us.shape[0]
    B = us.shape[-1]
    want = {"ss": (ss, (T + 1, _N, B)), "us": (us, (T, _M, B)),
            "ks": (ks, (T, _M, B)), "Ks": (Ks, (T, _M, _N, B)),
            "params": (params, (N_PAR, B)), "lb": (lb, (_M, B)),
            "ub": (ub, (_M, B)), "cost": (cost, (B,)), "act": (act, (B,))}
    for name, (a, shape) in want.items():
        if tuple(a.shape) != shape:
            raise ValueError(f"{name}: expected shape {shape}, got "
                             f"{tuple(a.shape)}")
    if coeffs.dim() != 2 or coeffs.shape[1] != B or coeffs.shape[0] < 1:
        raise ValueError(f"coeffs: expected (P, {B}), got "
                         f"{tuple(coeffs.shape)}")
    if not 1 <= int(n_alpha) <= MAX_ALPHA:
        raise ValueError(f"n_alpha must be in 1..{MAX_ALPHA}, got {n_alpha}")
    return T, B


# --------------------------------------------------------------- plain


def forward_plain(ss, us, ks, Ks, coeffs, params, sign, lb, ub, cost, act,
                  n_alpha: int = 8):
    """The plain PyTorch version of the kernel: `_kernel` of
    `forward_pallas.py` transcribed onto (B,)-vectors with the n_alpha
    candidates stacked (n_alpha, B), in the same operation order."""
    T, B = _check_inputs(ss, us, ks, Ks, coeffs, params, lb, ub, cost, act,
                         n_alpha)
    dtype = ss.dtype
    par = params
    cf = coeffs
    dt = par[P_DT]
    alphas = torch.tensor([0.5 ** j for j in range(n_alpha)], dtype=dtype,
                          device=ss.device)[:, None]

    def stage_cost(s, u0, u1, rate):
        du0 = u0 - s[6]
        du1 = u1 - s[7]
        return (par[P_WCTE] * (s[4] - par[P_RCTE]) ** 2
                + par[P_WETH] * (s[5] - par[P_RETH]) ** 2
                + par[P_WVEL] * (s[3] - par[P_RVEL]) ** 2
                + par[P_WANG] * u0 ** 2 + par[P_WACC] * u1 ** 2
                + rate * (par[P_WDANG] * du0 ** 2 + par[P_WDACC] * du1 ** 2))

    def term_cost(s):
        return (par[P_WCTE] * (s[4] - par[P_RCTE]) ** 2
                + par[P_WETH] * (s[5] - par[P_RETH]) ** 2
                + par[P_WVEL] * (s[3] - par[P_RVEL]) ** 2)

    def feedback(s, s_b, u_b, alpha, k, K):
        # K is an input here: the full 8-column sum (no structural zero)
        ds = [s[j] - s_b[j] for j in range(_N)]
        u0 = u_b[0] + alpha * k[0] + sum(K[0, j] * ds[j] for j in range(_N))
        u1 = u_b[1] + alpha * k[1] + sum(K[1, j] * ds[j] for j in range(_N))
        return (torch.clamp(u0, lb[0], ub[0]), torch.clamp(u1, lb[1], ub[1]))

    def dyn(s, u0, u1):
        x, y, th, v, cte, eth = s[:6]
        f0 = tiles.polyval(cf, x)
        return [x + v * torch.cos(th) * dt,
                y + v * torch.sin(th) * dt,
                th + u0 * dt,
                v + u1 * dt,
                (f0 - y) + sign * v * torch.sin(eth) * dt,
                eth + u0 * dt,
                u0,
                u1]

    s0 = ss[0]
    # the n_alpha running states, stacked (n_alpha, B) per row
    S = [s0[i].expand(n_alpha, B) for i in range(_N)]
    accs = torch.zeros((n_alpha, B), dtype=dtype, device=ss.device)
    for t in range(T):
        rate = 1.0 if t >= 1 else 0.0
        u0, u1 = feedback(S, ss[t], us[t], alphas, ks[t], Ks[t])
        accs = accs + stage_cost(S, u0, u1, rate)
        S = dyn(S, u0, u1)
    costs = accs + term_cost(S)

    # acceptance: the first (largest) alpha with a cost decrease
    zeros = torch.zeros((B,), dtype=dtype, device=ss.device)
    picked = alpha_sel = zeros
    cost_sel = cost
    for a in range(n_alpha):
        improved = (costs[a] < cost).to(dtype)
        take = improved * (1.0 - torch.clamp(picked, max=1.0))
        picked = picked + take
        alpha_sel = alpha_sel + take * (0.5 ** a)
        cost_sel = torch.where(take > 0.5, costs[a], cost_sel)
    accepted = torch.clamp(picked, max=1.0)
    upd = accepted * act                      # only active lanes move

    # re-roll the selected alpha per lane, writing through the mask
    ss_out = [s0]
    us_out = []
    s_a = list(s0)
    for t in range(T):
        u0, u1 = feedback(s_a, ss[t], us[t], alpha_sel, ks[t], Ks[t])
        s_a = dyn(s_a, u0, u1)
        us_out.append(upd[None, :] * torch.stack([u0, u1])
                      + (1.0 - upd)[None, :] * us[t])
        ss_out.append(upd[None, :] * torch.stack(s_a)
                      + (1.0 - upd)[None, :] * ss[t + 1])
    cost_new = torch.where(upd > 0.5, cost_sel, cost)
    return torch.stack(ss_out), torch.stack(us_out), cost_new, accepted


# ---------------------------------------------------------------- CUDA


def forward_cuda(ss, us, ks, Ks, coeffs, params, sign, lb, ub, cost, act,
                 n_alpha: int = 8):
    """Launch the hand-written kernel (`csrc/forward.cu`, template on
    n_alpha) on CUDA float32 tensors; raises on anything else. Allocates
    every output; launches on the current stream and does not
    synchronize."""
    global launches
    args = (ss, us, ks, Ks, coeffs, params, lb, ub, cost, act)
    for a in args:
        if not a.is_cuda:
            raise ValueError("forward_cuda needs CUDA tensors, got one on "
                             f"{a.device}")
        if a.dtype != torch.float32:
            raise ValueError(f"forward_cuda computes in float32, got "
                             f"{a.dtype}")
        if a.device != ss.device:
            raise ValueError("forward_cuda inputs must share a device")
    T, B = _check_inputs(*args, n_alpha)
    P = coeffs.shape[0]
    if P > 8:
        raise ValueError(f"the kernel takes polynomials up to order 7 "
                         f"(P <= 8), got P={P}")
    if T < 1:
        raise ValueError(f"the kernel takes T >= 1, got T={T}")
    args = [a.contiguous() for a in args]
    from . import _build

    launch = _build.load("forward", (int(n_alpha),))
    dev = ss.device

    def empty(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    outs = [empty(T + 1, _N, B), empty(T, _M, B), empty(B), empty(B)]
    ptr = [ctypes.c_void_p(a.data_ptr()) for a in args + outs]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = launch(*ptr, ctypes.c_int(P), ctypes.c_int(B),
                     ctypes.c_int(T), ctypes.c_float(sign),
                     ctypes.c_int(int(n_alpha)), ctypes.c_void_p(stream))
    _build.check(launch, err, "forward")
    launches += 1
    return tuple(outs)


def forward(ss, us, ks, Ks, coeffs, params, sign, lb, ub, cost, act,
            n_alpha: int = 8):
    """The fused line search: CPU tensors run `forward_plain`, CUDA
    tensors the kernel (float32 only; anything else raises)."""
    fn = forward_cuda if ss.is_cuda else forward_plain
    return fn(ss, us, ks, Ks, coeffs, params, sign, lb, ub, cost, act,
              n_alpha)
