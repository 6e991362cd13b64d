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

The kernel writes each lane's likely output during its candidate pass and
runs a second pass only on the lanes where that is not the answer (the
note of `csrc/forward.cu`). `second_pass_plain` computes, from the plain
version's candidates, which pass each lane takes (the kernel's optional
`second` output); `rollouts_finite` is the bound that lets a lane skip it;
`design_bytes` counts the bytes that design moves.
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


def _model(coeffs, params, sign, lb, ub):
    """The cost and dynamics of `_kernel`, on stacked (..., B) rows:
    (stage_cost, term_cost, feedback, dyn)."""
    par = params
    cf = coeffs
    dt = par[P_DT]

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

    return stage_cost, term_cost, feedback, dyn


def alphas(n_alpha: int, like):
    """The step sizes 0.5^j, j < n_alpha, as an (n_alpha, 1) column."""
    return torch.tensor([0.5 ** j for j in range(n_alpha)], dtype=like.dtype,
                        device=like.device)[:, None]


def candidates(model, ss, us, ks, Ks, n_alpha: int):
    """The costs (n_alpha, B) of `_kernel`'s n_alpha candidate rollouts
    from ss[0], advancing together over t."""
    stage_cost, term_cost, feedback, dyn = model
    T, B = us.shape[0], us.shape[-1]
    alpha = alphas(n_alpha, ss)
    # the n_alpha running states, stacked (n_alpha, B) per row
    S = [ss[0][i].expand(n_alpha, B) for i in range(_N)]
    accs = torch.zeros((n_alpha, B), dtype=ss.dtype, device=ss.device)
    for t in range(T):
        rate = 1.0 if t >= 1 else 0.0
        u0, u1 = feedback(S, ss[t], us[t], alpha, ks[t], Ks[t])
        accs = accs + stage_cost(S, u0, u1, rate)
        S = dyn(S, u0, u1)
    return accs + term_cost(S)


def acceptance(costs, cost):
    """The first (largest) alpha with a cost decrease, per lane:
    (accepted, alpha_sel, cost_sel, winner), winner = n_alpha where none
    wins."""
    n_alpha, B = costs.shape
    zeros = torch.zeros((B,), dtype=costs.dtype, device=costs.device)
    picked = alpha_sel = zeros
    cost_sel = cost
    winner = torch.full((B,), n_alpha, dtype=torch.int64,
                        device=costs.device)
    for a in range(n_alpha):
        improved = (costs[a] < cost).to(costs.dtype)
        take = improved * (1.0 - torch.clamp(picked, max=1.0))
        picked = picked + take
        alpha_sel = alpha_sel + take * (0.5 ** a)
        cost_sel = torch.where(take > 0.5, costs[a], cost_sel)
        winner = torch.where(take > 0.5, a, winner)
    return torch.clamp(picked, max=1.0), alpha_sel, cost_sel, winner


def forward_plain(ss, us, ks, Ks, coeffs, params, sign, lb, ub, cost, act,
                  n_alpha: int = 8):
    """The plain PyTorch version of the kernel: `_kernel` of
    `forward_pallas.py` transcribed onto (B,)-vectors with the n_alpha
    candidates stacked (n_alpha, B), in the same operation order."""
    T, _ = _check_inputs(ss, us, ks, Ks, coeffs, params, lb, ub, cost, act,
                         n_alpha)
    model = _model(coeffs, params, sign, lb, ub)
    _, _, feedback, dyn = model
    costs = candidates(model, ss, us, ks, Ks, n_alpha)
    accepted, alpha_sel, cost_sel, _ = acceptance(costs, cost)
    upd = accepted * act                      # only active lanes move
    s0 = ss[0]

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


# ------------------------------------------------- the kernel's design

# the second pass a lane takes (the kernel's `second` output, low two
# bits; the winning candidate, or n_alpha, is added times 4)
SP_NONE, SP_REROLL, SP_REWRITE = 0, 1, 2
# every rollout of a lane whose bound stays below this is finite
FINITE = 1e30


def rollouts_finite(ss, us, ks, Ks, coeffs, params, sign, lb, ub):
    """(B,) bool: the kernel's bound, in its operation order, that every
    rollout of a lane at any alpha in [0, 1] is finite (the note of
    `csrc/forward.cu`, case (b)). False wherever an input it reads is NaN
    or infinite."""
    T = us.shape[0]

    def amax(x):
        return x.abs().reshape(-1, x.shape[-1]).amax(dim=0)

    m = amax(ss)
    w = torch.maximum(amax(us), amax(ks))
    g = amax(Ks)
    U = torch.maximum(torch.maximum(lb[0].abs(), lb[1].abs()),
                      torch.maximum(ub[0].abs(), ub[1].abs()))
    D = params[P_DT].abs()
    P = coeffs.shape[0]
    C = amax(coeffs)
    V = m + T * U * D
    X = m + T * D * V
    X1 = torch.clamp(X, min=1.0)
    F = C * float(P)
    for _ in range(1, P):
        F = F * X1
    S = torch.maximum(torch.maximum(V, X),
                      torch.maximum(F + X + abs(sign) * V * D, U))
    Q = 2.0 * w + 8.0 * g * (S + m)
    return (S <= FINITE) & (Q <= FINITE)


def second_pass_plain(ss, us, ks, Ks, coeffs, params, sign, lb, ub, cost,
                      act, n_alpha: int = 8):
    """(B,) int8: the second pass each lane takes in the kernel's design
    (SP_NONE, SP_REROLL, SP_REWRITE) plus 4 * the winning candidate, from
    the plain version's candidate rollouts: what the kernel's `second`
    output holds where both sides pick the same candidate."""
    _check_inputs(ss, us, ks, Ks, coeffs, params, lb, ub, cost, act, n_alpha)
    model = _model(coeffs, params, sign, lb, ub)
    costs = candidates(model, ss, us, ks, Ks, n_alpha)
    accepted, alpha_sel, _, winner = acceptance(costs, cost)
    finite = rollouts_finite(ss, us, ks, Ks, coeffs, params, sign, lb, ub)
    on, off = act == 1.0, act == 0.0
    kind = torch.where(
        on, torch.where(accepted == 1.0,
                        torch.where(alpha_sel == 1.0, SP_NONE, SP_REROLL),
                        torch.where(finite, SP_REWRITE, SP_REROLL)),
        torch.where(off & finite, SP_NONE, SP_REROLL))
    return (kind + 4 * winner).to(torch.int8)


def design_bytes(T: int, P: int, reroll_share: float = 0.0,
                 rewrite_share: float = 0.0) -> float:
    """Bytes per scenario that the kernel's design moves through device
    memory, with `reroll_share` and `rewrite_share` the shares of the
    batch's 32-byte sectors (8 lanes) that the second pass's re-roll and
    pass-through rewrite touch. The candidate pass reads each input once
    and writes each output once (the bound's count: 1,142 floats at T =
    29, P = 4); a re-roll reads the knots again (ss, us, ks and Ks: 28 T +
    8 floats) and writes rows 1..T of ss and the T rows of us (10 T); a
    rewrite reads and writes the rows of ss and us (10 T + 8, 10 T)."""
    reads = 8 * (T + 1) + 20 * T + P + N_PAR + 4 + 2
    writes = 8 * (T + 1) + 2 * T + 2
    second = (reroll_share * (38 * T + 8)
              + rewrite_share * (20 * T + 8))
    return 4.0 * (reads + writes + second)


def second_pass_counts(second) -> dict:
    """Lanes and 32-byte sectors (8 lanes) of a batch that took each
    second pass, from the kernel's `second` output or
    `second_pass_plain`."""
    kind = (second.to(torch.int64) % 4).reshape(-1)
    out = {}
    for name, k in (("reroll", SP_REROLL), ("rewrite", SP_REWRITE)):
        hit = kind == k
        n = hit.numel()
        sectors = torch.nn.functional.pad(hit, (0, -n % 8)).reshape(-1, 8)
        out[f"{name}_lanes"] = int(hit.sum())
        out[f"{name}_sectors"] = int(sectors.any(dim=1).sum())
        out[f"{name}_sector_share"] = (out[f"{name}_sectors"]
                                       / sectors.shape[0])
    return out


# ---------------------------------------------------------------- CUDA


def forward_cuda(ss, us, ks, Ks, coeffs, params, sign, lb, ub, cost, act,
                 n_alpha: int = 8, second=None):
    """Launch the hand-written kernel (`csrc/forward.cu`, template on
    n_alpha) on CUDA float32 tensors; raises on anything else. Allocates
    every output; launches on the current stream and does not
    synchronize. `second`, an optional (B,) int8 CUDA tensor, receives the
    second pass each lane took plus 4 * its winning candidate (what
    `second_pass_plain` computes); never passed on the main path."""
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
    # rows are addressed by 32-bit offsets; Ks has the most rows
    if 2 * _M * _N * T * B >= 2 ** 31:
        raise ValueError(f"the kernel takes 16 T B < 2^31, got T={T}, B={B}")
    if second is not None and (
            not second.is_cuda or second.dtype != torch.int8
            or tuple(second.shape) != (B,) or not second.is_contiguous()
            or second.device != ss.device):
        raise ValueError("second: expected a contiguous (B,) int8 tensor "
                         "on the inputs' device")
    args = [a.contiguous() for a in args]
    from . import _build

    launch = _build.load("forward", (int(n_alpha),))
    dev = ss.device

    def empty(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    outs = [empty(T + 1, _N, B), empty(T, _M, B), empty(B), empty(B)]
    ptr = [ctypes.c_void_p(a.data_ptr()) for a in args + outs]
    ptr.append(ctypes.c_void_p(None if second is None
                               else second.data_ptr()))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = launch(*ptr, ctypes.c_int(P), ctypes.c_int(B),
                     ctypes.c_int(T), ctypes.c_float(sign),
                     ctypes.c_int(int(n_alpha)), ctypes.c_void_p(stream))
    _build.check(launch, err, "forward")
    launches += 1
    return tuple(outs)


def occupancy(n_alpha: int) -> dict:
    """What the kernel's build for n_alpha occupies on the current CUDA
    device: registers and local memory per thread, the knot ring's shared
    memory per block, and resident blocks per SM
    (`cudaOccupancyMaxActiveBlocksPerMultiprocessor`)."""
    from . import _build

    launch = _build.load("forward", (int(n_alpha),))
    out = (ctypes.c_int * 4)()
    fn = launch.lib.mpc_forward_occupancy
    fn.argtypes = [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    _build.check(launch, fn(out), "forward occupancy")
    return dict(zip(("registers", "local_bytes", "smem_bytes_per_block",
                     "blocks_per_sm"), out))


def forward(ss, us, ks, Ks, coeffs, params, sign, lb, ub, cost, act,
            n_alpha: int = 8):
    """The fused line search: CPU tensors run `forward_plain`, CUDA
    tensors the kernel (float32 only; anything else raises)."""
    fn = forward_cuda if ss.is_cuda else forward_plain
    return fn(ss, us, ks, Ks, coeffs, params, sign, lb, ub, cost, act,
              n_alpha)
