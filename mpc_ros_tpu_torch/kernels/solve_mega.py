"""The whole batched SQP solve in one kernel: the hand-written Hopper
kernel (`csrc/solve_mega.cu`) and its plain PyTorch version.

Counterpart of `mpc_ros_tpu/kernels/solve_pallas.py` (`_kernel`, launched
by `solve_pallas` and scheduled by `solve_pallas_scheduled`). One call
runs the complete control-limited SQP loop for every scenario: the
initial rollout, then per iteration the inline-linearized Riccati
backward scan with gated DDP terms and an exact 2-D box QP per stage,
`n_ls` parallel line-search rollouts (alpha = 0.5^j, the first — largest
— alpha that lowers the cost wins), the winner's re-roll, and the
per-lane mu / convergence / stall bookkeeping. The kernel's re-roll
replays the controls its line search recorded for the winner, on the
lanes whose step is accepted, where every row its backward read or wrote
is finite (`replay_check`), and recomputes and blends as the TPU kernel
does on the other running lanes; the plain version always recomputes,
u_b + alpha_sel k + K ds, blended into every lane. The two give the same
controls bit for bit (tests/test_torch_reroll.py), NaN and inf included
(`design=True`, tests/test_torch_k1_nonfinite.py).

Inputs are batch-last: zT (6, B), cT (P, B), params (12, B) from
`pack.pack_params`, lb/ub (2, B), u0 (T, 2, B); optionally the resume
state (done, conv, mu, gnorm), each (B,), the blobs (cx, cy, gamma, w),
each (K, B) (`GaussianObstacles.lane()`), and per-knot setpoints `refs`
(T+1, 3, B) of (ref_cte, ref_etheta, ref_vel). Outputs are
(ss (T+1, 8, B), us (T, 2, B), cost, conv, iters, gnorm, mu, done), each
of the last six (B,). An optional `diag` (n_ls + 2, B) receives each lane's
last line search (`check_diag`); the main path never passes it.

The port covers the whole kernel: the diff-drive and bicycle families,
ddp on or off, fast or exact trig, `scale_adaptive` on or off, per-lane
parameters, resume state, the per-tile exit of `done_frac < 1`, Gaussian
blobs and per-knot setpoints; `solve_mega_scheduled` runs it under the
single, sorted and compact schedules.

`solve_mega` sends CPU tensors to `solve_mega_plain` and CUDA tensors to
`solve_mega_cuda`, which launches the kernel or raises: one thread per
lane, or for a batch of many lanes per resident thread whose tiles wait
long on their slowest lanes a persistent grid whose threads take the next
lane when theirs is done (`refill_slots`, `grid_pays`), with the same
outputs bit for bit. Under the per-tile exit each launch starts its blocks
at another tile (`tile_shift`), with the same outputs bit for bit.

Spans (`obs.span`): `solve_mega_cuda` is `k1.dispatch`, holding
`k1.prepare` (the checks, the knobs, the contiguous inputs, the build's
lookup) and `k1.launch` (the outputs' and scratch's allocation and the
launcher's call); a schedule's host work between and after its passes
(sorts, gathers, scatters) is `k1.schedule`; the compact schedule's pass 2
is `k1.tail`.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math

import torch

from ..obs.timers import span
from . import tiles
from .pack import (N_PAR, P_DT, P_LF, P_RCTE, P_RETH, P_RVEL, P_WACC,
                   P_WANG, P_WCTE, P_WDACC, P_WDANG, P_WETH, P_WVEL)

_N = 8
_M = 2

# The batch tile: the lanes whose done count decides a `done_frac < 1`
# exit together. It is the kernel's block (`kTile` in csrc/solve_mega.cu,
# one thread per lane), and the plain version and the schedules tile the
# batch the same way, so the CPU and the card compute the same schedule.
# The JAX package picks sub * 128 lanes per Pallas program (`_pick_sub`,
# sub in {8, 4, 2, 1}) to fill (8, 128) vregs within a 10 MiB VMEM budget;
# neither constraint exists on Hopper, where a 128-thread block keeps
# enough blocks in flight at any batch. The two agree where `_pick_sub`
# returns sub = 1 (B an odd multiple of 128).
TILE = 128

# calls of `solve_mega_cuda` (and nowhere else) that launched the kernel:
# one kernel one thread per lane, on the persistent grid a memset of its
# int buffer and two kernels (`solve_mega_kernel`, `solve_mega_retile`)
launches = 0
# What the schedules ran, counted by the schedule code itself: solve
# passes (kernel launches on CUDA tensors, plain runs on CPU tensors), the
# lanes handed to compact pass 2, the lanes that needed pass 2 in the
# last compact call (a 0-d tensor, read after the call; more than
# `tail_lanes` added means stragglers kept their pass-1 iterate), and the
# tail's lanes that needed it, summed over every compact call
# (`need_lanes`: 0-d tensors added on the device without a host read, one
# per device and stream, so that no add reads another device's tensor or
# another stream's unordered work; `need_total()` sums them, and
# `need_total() / tail_lanes` is the share of the tail that did work).
passes = 0
tail_lanes = 0
last_need = None
need_lanes = {}
# What the last launch's persistent grid did (`refill_slots`), each a 0-d
# int32 tensor on the card read after the call, or 0 when the launch ran
# one lane per thread: the lanes a thread took after its first, and the
# tiles solved again for a lane that blends after it is done.
refilled_lanes = 0
retiled_tiles = 0

# The persistent grid engages at this many lanes per resident thread or
# more (`refill_slots`), and where the tiles of the last call of the same
# shape waited long on their slowest lanes (`grid_pays`). On an H100 a
# trip of the grid (one iteration of each thread's lane) costs ~1.5x an
# iteration one thread per lane, and a lane takes one trip more than its
# iterations, while one thread per lane a tile runs to its slowest lane:
# the grid pays where the mean of the tiles' most iterations is at least
# GRID_PACE x (the mean iterations + 1). At the benchmark's weights a cold
# batch of 524,288 reads 1.74 (the grid 15% faster); the same batch
# warm-started 1.19 and a cold one at MPCParams()'s weights 1.10 (the grid
# 12-18% slower).
REFILL_LANES_PER_SLOT = 8
GRID_PACE = 1.5

# Launches of the per-tile exit so far (`tile_shift`). The card starts a
# launch's blocks in index order, so a lockstep launch drains on the tiles
# it starts last; with the batch's last tiles always last, how long the
# drain takes is set by the batch's layout: at N=48 and B=131,072 (H100)
# pass 1 of the compact schedule moved by 1.2% (sd) between whole-tile
# rotations of one batch, more than its work moved between batches. Each
# launch starts at another tile, so that a batch solved again and again
# drains on other tiles each time, with the same outputs bit for bit.
tile_launches = 0

MODELS = ("diff_drive", "bicycle")


@dataclasses.dataclass(frozen=True)
class Knobs:
    """The solver constants the kernel is specialized or parameterized
    on, resolved from a SolverConfig for one compute dtype exactly as
    `solve_pallas` resolves them."""

    T: int
    n_ls: int
    max_iters: int
    sign: float
    tol_grad: float
    tol_cost_eff: float
    mu_min: float
    mu_max: float
    mu_factor: float
    ddp: bool
    ddp_gate: float
    fast_trig: bool
    adaptive: bool
    n_done_needed: int
    # Gaussian blobs per lane (0 = none), per-knot setpoints, and the
    # vehicle family ("diff_drive" or "bicycle")
    n_blobs: int = 0
    has_setp: bool = False
    model: str = "diff_drive"
    # the per-tile loop even at n_done_needed = TILE, where it computes
    # what the per-lane exit does (to time the one against the other)
    lockstep: bool = False

    @property
    def tile_exit(self) -> bool:
        """The tile's lanes iterate together and the tile decides its exit:
        under `done_frac < 1` (a tile stops before all its lanes are done),
        or when asked for with `lockstep`."""
        return self.lockstep or self.n_done_needed < TILE

    @property
    def variant(self) -> tuple:
        """The kernel's template arguments (n_ls, ddp, fast, adaptive,
        tile_exit, blobs, setp, bicycle); the number of blobs is a runtime
        argument."""
        return (self.n_ls, self.ddp, self.fast_trig, self.adaptive,
                self.tile_exit, self.n_blobs > 0, self.has_setp,
                self.model == "bicycle")


def resolve_knobs(cfg, dtype, n_blobs: int = 0,
                  has_setp: bool = False) -> Knobs:
    """The knobs of one solve: with blobs (`n_blobs` > 0) the mu floor and
    the DDP gate resolve with obstacles, as `solve_pallas` resolves
    them."""
    if cfg.model not in MODELS:
        raise ValueError(f"solve_mega covers the families {MODELS}, got "
                         f"{cfg.model!r}")
    if cfg.trig not in ("fast", "exact"):
        raise ValueError(f"trig must be 'fast' or 'exact', got {cfg.trig!r}")
    return Knobs(
        T=cfg.n_controls,
        n_ls=cfg.ls_for(dtype),
        max_iters=int(cfg.max_sqp_iters),
        sign=float(cfg.cte_vsin_sign),
        tol_grad=float(cfg.tol_grad_for(dtype)),
        tol_cost_eff=max(cfg.tol_cost, 10.0 * float(torch.finfo(dtype).eps)),
        mu_min=float(cfg.mu_init_for(dtype, n_blobs > 0)),
        mu_max=float(cfg.mu_max),
        mu_factor=float(cfg.mu_factor),
        ddp=bool(cfg.ddp_for(dtype)),
        ddp_gate=float(cfg.gate_for(n_blobs > 0, dtype)),
        fast_trig=cfg.trig == "fast",
        adaptive=bool(cfg.scale_adaptive),
        # a tile runs while fewer of its lanes are done (solve_pallas)
        n_done_needed=(TILE if cfg.done_frac >= 1.0 else
                       min(TILE, int(math.ceil(cfg.done_frac * TILE)))),
        n_blobs=int(n_blobs),
        has_setp=bool(has_setp),
        model=cfg.model,
    )


def _knobs_for(cfg, dtype, blobs, refs) -> Knobs:
    if blobs is not None and len(blobs) != 4:
        raise ValueError(f"blobs is (cx, cy, gamma, w), got {len(blobs)} "
                         "arrays")
    return resolve_knobs(cfg, dtype,
                         n_blobs=0 if blobs is None else blobs[0].shape[0],
                         has_setp=refs is not None)


def check_diag(diag, kn, zT) -> None:
    """The line-search diagnostic output: None (the main path), or an
    (n_ls + 2, B) tensor of the inputs' dtype and device that every
    iteration a lane runs overwrites in that lane's column with the n_ls
    candidate costs, the cost before the step and the alpha chosen (0 when
    no candidate lowered the cost). After the call it holds each lane's
    last iteration; a lane that ran none keeps what the caller put
    there."""
    if diag is None:
        return
    want = (kn.n_ls + 2, zT.shape[-1])
    if tuple(diag.shape) != want or diag.dtype != zT.dtype or (
            diag.device != zT.device) or not diag.is_contiguous():
        raise ValueError(f"diag: expected a contiguous {want} {zT.dtype} "
                         f"tensor on {zT.device}, got {tuple(diag.shape)} "
                         f"{diag.dtype} on {diag.device}")


def _check_inputs(zT, cT, pp, lb, ub, u0, kn, resume=None, blobs=None,
                  refs=None):
    B = zT.shape[-1]
    want = {"zT": (zT, (6, B)), "params": (pp, (N_PAR, B)),
            "lb": (lb, (_M, B)), "ub": (ub, (_M, B)),
            "u0": (u0, (kn.T, _M, B))}
    if resume is not None:
        if len(resume) != 4:
            raise ValueError("resume is (done, conv, mu, gnorm), got "
                             f"{len(resume)} arrays")
        want.update({f"resume[{i}]": (r, (B,)) for i, r in enumerate(resume)})
    if blobs is not None:
        if kn.n_blobs < 1:
            raise ValueError("blobs needs at least one blob per lane")
        want.update({f"blobs[{i}]": (b, (kn.n_blobs, B))
                     for i, b in enumerate(blobs)})
    if refs is not None:
        want["refs"] = (refs, (kn.T + 1, 3, B))
    if kn.tile_exit and B % TILE:
        raise ValueError(f"the per-tile loop (done_frac < 1, or lockstep) "
                         f"runs {TILE}-lane tiles and needs B % {TILE} == 0, "
                         f"got B={B}")
    for name, (a, shape) in want.items():
        if tuple(a.shape) != shape:
            raise ValueError(f"{name}: expected shape {shape}, got "
                             f"{tuple(a.shape)}")
    if cT.dim() != 2 or cT.shape[1] != B or cT.shape[0] < 1:
        raise ValueError(f"cT: expected (P, {B}), got {tuple(cT.shape)}")
    return B


# --------------------------------------------------------------- plain


def replay_check(s=None, u=None, gains=None):
    """The kernel's check that a lane's re-roll may skip the blend: sums,
    in the kernel's order, of what its backward reads of a knot (the state
    s, rows 0-5, and the control u) or writes (`gains` = (k (2, B),
    K (2, 8, B)), K without its structurally zero column 4). A lane's
    running sum over the knots and the terminal state is finite only if
    every term is, and then the rejected step's re-roll at alpha = 0
    rebuilds the trajectory exactly (0 * new + old is old) and the accepted
    step's blend is its new rollout (new + 0 * old); an overflow of a sum
    of finite terms only sends the lane to the blend, which is exact
    anyway."""
    if gains is not None:
        k, K = gains
        acc = k[0] + k[1]
        for j in range(_N):
            if j != 4:
                acc = acc + (K[0, j] + K[1, j])
        return acc
    acc = ((s[0] + s[1]) + (s[2] + s[3])) + (s[4] + s[5])
    return acc if u is None else acc + (u[0] + u[1])


def _trajectory_finite(traj_s, traj_u):
    """(B,) True where every state row 0-5 and control of a trajectory
    buffer is finite."""
    rows = [r for knot in traj_s for r in knot[:6]]
    rows += [u for knot in traj_u for u in knot]
    return torch.isfinite(torch.stack(rows)).all(dim=0)


def _tile_runs(done, kn):
    """(B,) True where the lane's tile of TILE lanes (the kernel's block)
    still runs: under done_frac < 1 while fewer than n_done_needed of its
    lanes are done, else while one of them is not done."""
    B = done.shape[0]
    pad = -B % TILE
    d = torch.cat([done, done.new_ones(pad)]).reshape(-1, TILE)
    if kn.tile_exit:
        runs = d.sum(dim=1) < kn.n_done_needed - 0.5
    else:
        runs = (d < 0.5).any(dim=1)
    return runs.repeat_interleave(TILE)[:B]


def solve_mega_plain(zT, cT, pp, lb, ub, u0, cfg, resume=None, blobs=None,
                     refs=None, diag=None, design=False):
    """The plain PyTorch version of the kernel: `_kernel` of
    `solve_pallas.py` transcribed onto (B,)-vectors — the same
    structured-sparsity products in the same operation order, and an `act`
    mask so done lanes never update (with done_frac = 1 a lane's result
    does not depend on its neighbours).

    `resume`: optional (done, conv, mu, gnorm), each (B,), from an earlier
    pass; the cost is recomputed by the initial rollout of `u0`, and the
    small-step counter and iteration count restart at 0. With done_frac < 1
    the batch runs in tiles of TILE lanes, as the kernel's blocks do: a
    tile stops once ceil(done_frac * TILE) of its lanes are done, and its
    lanes are masked out of every update from then on.

    `blobs` (cx, cy, gamma, w), each (K, B): the blob penalty joins every
    knot's cost, and its gradient and Gauss-Newton curvature (with the
    concave part on lanes past the DDP gate) the backward's stage and
    terminal expansions. `refs` (T+1, 3, B): knot t's setpoints replace
    the scalar (ref_cte, ref_etheta, ref_vel) in knot t's cost. With
    `cfg.model == "bicycle"` the heading advances by v delta dt / lf.

    `diag`: an optional (n_ls + 2, B) tensor, written in place on every
    iteration a lane runs (`check_diag`).

    `design=True` runs the re-roll as the CUDA kernel does (for holding
    that design against this version on the CPU): a lane whose backward
    rows are all finite (`replay_check`) takes the winner's rollout on an
    accepted step and keeps its trajectory on a rejected one, with no
    blend; any other running lane blends as below; a done lane is left as
    it is unless its trajectory or its last backward's rows were not
    finite (or it was resumed done and has run no backward), or the
    backward it would run next (on the trajectory its last step left,
    under the gate and mu that step set: the kernel's probe) is not: such
    a lane blends with act = 0 while its tile of TILE lanes runs (the kernel's
    block: under done_frac < 1 until the tile stops, else while one of its
    lanes is not done), where this version blends every lane while any
    lane of the batch runs."""
    dtype = zT.dtype
    kn = _knobs_for(cfg, dtype, blobs, refs)
    T = kn.T
    B = _check_inputs(zT, cT, pp, lb, ub, u0, kn, resume, blobs, refs)
    check_diag(diag, kn, zT)
    dev = zT.device
    sign = kn.sign
    n_alpha = kn.n_ls
    par = [pp[i] for i in range(N_PAR)]
    cf = cT
    dt = par[P_DT]
    zeros = torch.zeros(B, dtype=dtype, device=dev)
    alphas = [0.5 ** j for j in range(n_alpha)]
    alpha_col = torch.tensor(alphas, dtype=dtype, device=dev)[:, None]
    lb0, lb1, ub0, ub1 = lb[0], lb[1], ub[0], ub[1]

    wv2 = 2.0 * par[P_WVEL]
    wc2 = 2.0 * par[P_WCTE]
    we2 = 2.0 * par[P_WETH]
    ww2 = 2.0 * par[P_WANG]
    wa2 = 2.0 * par[P_WACC]
    if kn.adaptive:
        wscl = torch.clamp(
            (par[P_WCTE] + par[P_WETH] + par[P_WVEL] + par[P_WANG]
             + par[P_WACC] + par[P_WDANG] + par[P_WDACC]) * (1.0 / 470.0),
            min=1.0)
        inv_wscl = 1.0 / wscl
        mu_lo = kn.mu_min * wscl
        mu_hi = kn.mu_max * wscl
    else:
        wscl = 1.0
        inv_wscl = 1.0
        mu_lo = torch.full((B,), kn.mu_min, dtype=dtype, device=dev)
        mu_hi = torch.full((B,), kn.mu_max, dtype=dtype, device=dev)
    n_blobs = kn.n_blobs
    bicycle = kn.model == "bicycle"

    def sq(a):
        return a * a

    # (e) Gaussian blobs: sum_k w exp(-|d|^2 g) and, for the backward, its
    # gradient and Gauss-Newton curvature; given the per-lane DDP gate, the
    # concave -2 g v I part is added back scaled by it
    if n_blobs:
        bx, by, bg, bw = blobs

    def obs_val(x, y):
        tot = zeros
        for k in range(n_blobs):
            dx = x - bx[k]
            dy = y - by[k]
            tot = tot + bw[k] * torch.exp(-(dx * dx + dy * dy) * bg[k])
        return tot

    def obs_terms(x, y, gate):
        gx = gy = hxx = hxy = hyy = zeros
        for k in range(n_blobs):
            dx = x - bx[k]
            dy = y - by[k]
            g = bg[k]
            v = bw[k] * torch.exp(-(dx * dx + dy * dy) * g)
            tg = 2.0 * g
            gx = gx - tg * dx * v
            gy = gy - tg * dy * v
            s_ = tg * tg * v
            hxx = hxx + s_ * dx * dx
            hxy = hxy + s_ * dx * dy
            hyy = hyy + s_ * dy * dy
            if gate is not None:
                hxx = hxx - gate * tg * v
                hyy = hyy - gate * tg * v
        return gx, gy, hxx, hxy, hyy

    # (f) the setpoints of knot t: the per-knot profile, or the per-lane
    # scalars
    if refs is not None:
        def ref3(t):
            return refs[t, 0], refs[t, 1], refs[t, 2]
    else:
        def ref3(t):
            return par[P_RCTE], par[P_RETH], par[P_RVEL]

    # (g) the heading increment: omega dt, or v delta dt / lf for the
    # bicycle, whose heading rows gain a v dependence
    if bicycle:
        invlf = 1.0 / par[P_LF]

        def dth_of(v, u0_):
            return v * invlf * u0_ * dt
    else:
        def dth_of(v, u0_):
            return u0_ * dt

    def dyn_step(s, u0_, u1_, ct_, st_, se_):
        x, y, th, v, cte, eth = s[:6]
        f0 = tiles.polyval(cf, x)
        dth = dth_of(v, u0_)
        return [x + v * ct_ * dt, y + v * st_ * dt, th + dth,
                v + u1_ * dt, (f0 - y) + sign * v * se_ * dt, eth + dth,
                u0_, u1_]

    def stage_cost(s, u0_, u1_, rate, t):
        du0 = u0_ - s[6]
        du1 = u1_ - s[7]
        rc, re, rv = ref3(t)
        c = (par[P_WCTE] * sq(s[4] - rc) + par[P_WETH] * sq(s[5] - re)
             + par[P_WVEL] * sq(s[3] - rv) + par[P_WANG] * sq(u0_)
             + par[P_WACC] * sq(u1_)
             + rate * (par[P_WDANG] * sq(du0) + par[P_WDACC] * sq(du1)))
        return c + obs_val(s[0], s[1]) if n_blobs else c

    def term_cost(s):
        rc, re, rv = ref3(T)
        c = (par[P_WCTE] * sq(s[4] - rc) + par[P_WETH] * sq(s[5] - re)
             + par[P_WVEL] * sq(s[3] - rv))
        return c + obs_val(s[0], s[1]) if n_blobs else c

    # rollout trigonometry: every rollout starts from the same pinned s0,
    # and theta/etheta advance by the same increment, so etheta_t =
    # theta_t + phi with phi fixed for the whole solve (fast mode: rotation
    # composition with a 9th/8th-order Taylor increment + one Newton
    # renormalization; no transcendentals after the first four). The
    # bicycle's increment has no configured bound: its Taylor runs on the
    # half angle and composes by the double-angle step
    s0 = [zT[i] for i in range(6)] + [zeros, zeros]
    ct00 = torch.cos(s0[2])
    st00 = torch.sin(s0[2])
    if kn.fast_trig:
        phi = s0[5] - s0[2]
        cphi = torch.cos(phi)
        sphi = torch.sin(phi)

        def se_of(ct, st, s):
            return st * cphi + ct * sphi

        def ce_of(ct, st, s):
            return ct * cphi - st * sphi

        def step_trig(ct, st, d, s_next):
            if bicycle:
                d = d * 0.5
            z = d * d
            sd = d * (1.0 + z * (-1.0 / 6.0 + z * (1.0 / 120.0
                      + z * (-1.0 / 5040.0 + z * (1.0 / 362880.0)))))
            cd = 1.0 + z * (-0.5 + z * (1.0 / 24.0
                      + z * (-1.0 / 720.0 + z * (1.0 / 40320.0))))
            if bicycle:
                cd, sd = cd * cd - sd * sd, 2.0 * sd * cd   # double angle
            c2 = ct * cd - st * sd
            s2 = st * cd + ct * sd
            f = 1.5 - 0.5 * (c2 * c2 + s2 * s2)
            return c2 * f, s2 * f
    else:
        def se_of(ct, st, s):
            return torch.sin(s[5])

        def ce_of(ct, st, s):
            return torch.cos(s[5])

        def step_trig(ct, st, d, s_next):
            return torch.cos(s_next[2]), torch.sin(s_next[2])

    # trajectory buffers: traj_s/traj_u double-buffered (the winner
    # re-roll at step t+1 still reads the OLD knot t+1), traj_g single
    traj_s = [[None] * (T + 1) for _ in range(2)]
    traj_u = [[None] * T for _ in range(2)]
    traj_g = [None] * T
    ks = [None] * T
    Ks = [None] * T

    def read_s(buf, t):
        # rows 6-7 are the previous control; the pinned start has none
        # (a select, never a multiply: 0 * NaN would poison the state)
        pu = traj_u[buf][t - 1] if t >= 1 else (zeros, zeros)
        return list(traj_s[buf][t]) + list(pu)

    # ---- initial rollout into buffer 0 ----
    traj_s[0][0] = s0[:6]
    acc = zeros
    ct, st = ct00, st00
    for t in range(T):
        s_a = read_s(0, t)
        u0_, u1_ = u0[t, 0], u0[t, 1]
        traj_u[0][t] = (u0_, u1_)
        rate = 1.0 if t >= 1 else 0.0
        acc = acc + stage_cost(s_a, u0_, u1_, rate, t)
        se = se_of(ct, st, s_a)
        traj_g[t] = (ct, st, se, ce_of(ct, st, s_a))
        s_n = dyn_step(s_a, u0_, u1_, ct, st, se)
        traj_s[0][t + 1] = s_n[:6]
        ct, st = step_trig(ct, st, dth_of(s_a[3], u0_), s_n)
    cost = acc + term_cost(traj_s[0][T])

    # ---- SQP loop ----
    n_small = zeros
    iters = zeros
    if resume is None:
        mu = mu_lo
        done = zeros
        conv = zeros
        gnorm = torch.full((B,), float("inf"), dtype=dtype, device=dev)
    else:
        done, conv, mu, gnorm = (r.to(dtype) for r in resume)
    if design:
        # the kernel's `dirt`: False where the lane's trajectory or its
        # last backward's rows were not finite, or it was resumed done
        clean = _trajectory_finite(traj_s[0], traj_u[0]) & (done < 0.5)
    cur = 0
    it = 0
    lss_idx = (None, None, None, wv2, wc2, we2)
    live = (0, 1, 2, 3, 5)

    def zadd(*terms):
        terms = [a for a in terms if a is not None]
        if not terms:
            return None
        out = terms[0]
        for a in terms[1:]:
            out = out + a
        return out

    while it < kn.max_iters:
        if kn.tile_exit:
            # per tile, as the kernel's blocks: run while fewer than
            # n_done_needed of the tile's lanes are done
            running = (done.reshape(-1, TILE).sum(dim=1)
                       < kn.n_done_needed - 0.5)
            if not bool(running.any()):
                break
            act = (1.0 - done) * running.to(dtype).repeat_interleave(TILE)
        else:
            if not bool((done < 0.5).any()):
                break
            act = 1.0 - done
        g_ddp = (gnorm < kn.ddp_gate).to(dtype) if kn.ddp else None

        # ---- backward scan with inline linearization ----
        sT = traj_s[cur][T]
        if n_blobs:
            ogxT, ogyT, ohxxT, ohxyT, ohyyT = obs_terms(sT[0], sT[1], g_ddp)
        else:
            ogxT = ogyT = ohxxT = ohxyT = ohyyT = zeros
        rcT, reT, rvT = ref3(T)
        Vs = [ogxT, ogyT, zeros, wv2 * (sT[3] - rvT), wc2 * (sT[4] - rcT),
              we2 * (sT[5] - reT), zeros, zeros]
        diagT = [ohxxT, ohyyT, zeros, wv2, wc2, we2, zeros, zeros]
        Vss = [[diagT[i] if i == j else zeros for j in range(_N)]
               for i in range(_N)]
        Vss[0][1] = Vss[1][0] = ohxyT
        dv1 = dv2 = pg = zeros
        if design:
            chk = replay_check(sT)
        for t in range(T - 1, -1, -1):
            s_t = read_s(cur, t)
            u_t = traj_u[cur][t]
            if design:
                chk = chk + replay_check(s_t, u_t)
            rate = 1.0 if t >= 1 else 0.0
            x = s_t[0]
            v = s_t[3]
            eth = s_t[5]
            ct, st, se, ce = traj_g[t]
            fp = tiles.polyder(cf, x)
            a02 = -v * st * dt
            a03 = ct * dt
            a12 = v * ct * dt
            a13 = st * dt
            a40 = fp
            a43 = sign * se * dt
            a45 = sign * v * ce * dt
            if bicycle:
                # the heading rows: A[2,3] = A[5,3] = delta dt / lf, and B
                # rows 2/5 scale by v / lf (dt for the diff drive)
                a23 = u_t[0] * invlf * dt
                b20 = v * invlf * dt
            else:
                a23 = None
                b20 = dt

            wdw2 = 2.0 * rate * par[P_WDANG]
            wda2 = 2.0 * rate * par[P_WDACC]
            du0 = u_t[0] - s_t[6]
            du1 = u_t[1] - s_t[7]
            if n_blobs:
                ogx, ogy, ohxx, ohxy, ohyy = obs_terms(s_t[0], s_t[1], g_ddp)
            else:
                ogx = ogy = zeros
            rc_t, re_t, rv_t = ref3(t)
            ls = [ogx, ogy, zeros, wv2 * (v - rv_t), wc2 * (s_t[4] - rc_t),
                  we2 * (eth - re_t), -wdw2 * du0, -wda2 * du1]
            lu = [ww2 * u_t[0] + wdw2 * du0, wa2 * u_t[1] + wda2 * du1]
            lss_diag = list(lss_idx) + [wdw2, wda2]
            y3 = Vs[3] if a23 is None else Vs[3] + a23 * (Vs[2] + Vs[5])
            AtV = [Vs[0] + a40 * Vs[4], Vs[1] - Vs[4],
                   a02 * Vs[0] + a12 * Vs[1] + Vs[2],
                   a03 * Vs[0] + a13 * Vs[1] + y3 + a43 * Vs[4],
                   zeros, a45 * Vs[4] + Vs[5], zeros, zeros]
            Qs = [ls[i] + AtV[i] for i in range(_N)]
            Qu = [lu[0] + (b20 * (Vs[2] + Vs[5]) + Vs[6]),
                  lu[1] + (dt * Vs[3] + Vs[7])]

            # structured VA = Vss @ A per entry: column 4 of A is zero, so
            # Vss row/col 4 is invariantly diag(wc2) and K/Qus column 4 is
            # exactly zero; None marks structural zeros (ops dropped)
            nrow = [i for i in range(_N) if i != 4]
            va0 = [Vss[i][0] for i in range(_N)]
            va0[4] = a40 * wc2
            va1 = [Vss[i][1] for i in range(_N)]
            va1[4] = -wc2
            va2 = [None] * _N
            va3 = [None] * _N
            for i in nrow:
                va2[i] = a02 * Vss[i][0] + a12 * Vss[i][1] + Vss[i][2]
                va3[i] = a03 * Vss[i][0] + a13 * Vss[i][1] + Vss[i][3]
                if a23 is not None:
                    va3[i] = va3[i] + a23 * (Vss[i][2] + Vss[i][5])
            # row 4's (4,2)/(4,5) entries are structurally zero, so the
            # bicycle's a23 term drops out of the row-4 invariant too
            va3[4] = a43 * wc2
            va5 = [Vss[i][5] for i in range(_N)]
            va5[4] = a45 * wc2
            va = {0: va0, 1: va1, 2: va2, 3: va3, 5: va5}

            def atva(i, j):
                y = va[j]
                y4 = y[4]
                if i == 0:
                    return zadd(y[0], None if y4 is None else a40 * y4)
                if i == 1:
                    return zadd(y[1], None if y4 is None else -y4)
                if i == 2:
                    return zadd(a02 * y[0], a12 * y[1], y[2])
                if i == 3:
                    return zadd(a03 * y[0], a13 * y[1], y[3],
                                None if y4 is None else a43 * y4,
                                None if a23 is None
                                else a23 * (y[2] + y[5]))
                return zadd(None if y4 is None else a45 * y4, y[5])

            dmap = {}
            if kn.ddp:
                fpp = tiles.polyder2(cf, x)
                dmap = {
                    (0, 0): Vs[4] * fpp * g_ddp,
                    (2, 2): -v * dt * (Vs[0] * ct + Vs[1] * st) * g_ddp,
                    (2, 3): dt * (Vs[1] * ct - Vs[0] * st) * g_ddp,
                    (3, 5): sign * dt * ce * Vs[4] * g_ddp,
                    (5, 5): -sign * dt * v * se * Vs[4] * g_ddp,
                }

            blob_h = ({(0, 0): ohxx, (1, 1): ohyy, (0, 1): ohxy}
                      if n_blobs else {})

            def qss_entry(i, j):
                e = atva(i, j) if (i in live and j in live) else None
                if i == j and lss_diag[i] is not None:
                    e = zadd(e, lss_diag[i])
                key = (i, j) if i <= j else (j, i)
                return zadd(e, blob_h.get(key), dmap.get(key))

            qus0 = {j: zadd(b20 * zadd(va[j][2], va[j][5]), va[j][6])
                    for j in live}
            qus1 = {j: zadd(dt * va[j][3], va[j][7]) for j in live}
            qus0[4] = qus1[4] = None
            qus0[6], qus1[6] = -wdw2, None
            qus0[7], qus1[7] = None, -wda2
            if kn.ddp and bicycle:
                # theta rows 2/5: d2(v delta dt / lf) / dv d delta
                qus0[3] = zadd(qus0[3], (Vs[2] + Vs[5]) * (invlf * dt)
                               * g_ddp)
            Qus = torch.stack([
                torch.stack([qus0[j] if qus0[j] is not None else zeros
                             for j in range(_N)]),
                torch.stack([qus1[j] if qus1[j] is not None else zeros
                             for j in range(_N)]),
            ])
            VB = [[b20 * (Vss[i][2] + Vss[i][5]) + Vss[i][6],
                   dt * Vss[i][3] + Vss[i][7]] for i in range(_N)]
            BtVB = [[b20 * (VB[2][n] + VB[5][n]) + VB[6][n] for n in (0, 1)],
                    [dt * VB[3][n] + VB[7][n] for n in (0, 1)]]
            offd = 0.5 * (BtVB[0][1] + BtVB[1][0])
            q00 = BtVB[0][0] + ww2 + wdw2
            q11 = BtVB[1][1] + wa2 + wda2
            Quu = torch.stack([torch.stack([q00, offd]),
                               torch.stack([offd, q11])])
            Quu_reg = torch.stack([torch.stack([q00 + mu, offd]),
                                   torch.stack([offd, q11 + mu])])
            u_t2 = torch.stack(list(u_t))
            Qu2 = torch.stack(Qu)
            k, K = tiles.boxqp(Quu_reg, Qu2, lb - u_t2, ub - u_t2, Qus)

            Quu_k = tiles.mv(Quu, k, _M, _M)
            ku = torch.stack([Quu_k[0] + Qu2[0], Quu_k[1] + Qu2[1]])
            Vs_n = (torch.stack(Qs) + tiles.mtv(K, ku, _N, _M)
                    + tiles.mtv(Qus, k, _N, _M))
            KtQuu = tiles.mtm(K, Quu, _N, _M, _M)

            def cross(i, j):
                return zadd(
                    None if qus0[j] is None else K[0, i] * qus0[j],
                    None if qus1[j] is None else K[1, i] * qus1[j])

            # Vss_n is symmetric: build the upper triangle and mirror;
            # row/col 4 is structural (diag(wc2))
            Vss_n = [[zeros] * _N for _ in range(_N)]
            for i2 in range(_N):
                for j2 in range(i2, _N):
                    if i2 == 4 or j2 == 4:
                        e = wc2 if i2 == j2 else zeros
                    else:
                        e = zadd(qss_entry(i2, j2),
                                 KtQuu[i2, 0] * K[0, j2]
                                 + KtQuu[i2, 1] * K[1, j2],
                                 cross(i2, j2), cross(j2, i2))
                    Vss_n[i2][j2] = e
                    Vss_n[j2][i2] = e

            ks[t] = k
            Ks[t] = K
            if design:
                chk = chk + replay_check(gains=(k, K))
            dv1 = dv1 + k[0] * Qu2[0] + k[1] * Qu2[1]
            dv2 = dv2 + 0.5 * (k[0] * Quu_k[0] + k[1] * Quu_k[1])
            # pg on the weight-scale-normalized gradient
            pg_t = torch.maximum(
                torch.abs(u_t[0] - torch.clamp(u_t[0] - Qu[0] * inv_wscl,
                                               lb0, ub0)),
                torch.abs(u_t[1] - torch.clamp(u_t[1] - Qu[1] * inv_wscl,
                                               lb1, ub1)))
            pg = torch.maximum(pg, pg_t)
            Vs = [Vs_n[i] for i in range(_N)]
            Vss = Vss_n

        pred_decrease = -(dv1 + dv2)
        tiny_model = (pred_decrease
                      <= kn.tol_cost_eff * (wscl + torch.abs(cost))).to(dtype)

        # ---- multi-alpha line search (candidates stacked (n_ls, B)) ----
        s0_t = read_s(cur, 0)
        S = [r.expand(n_alpha, B) for r in s0_t]
        accs = zeros.expand(n_alpha, B)
        cts = ct00.expand(n_alpha, B)
        sts = st00.expand(n_alpha, B)
        for t in range(T):
            s_b = read_s(cur, t)
            u_b = traj_u[cur][t]
            k, K = ks[t], Ks[t]
            rate = 1.0 if t >= 1 else 0.0
            ds = [S[j] - s_b[j] for j in range(_N)]
            u0_ = u_b[0] + alpha_col * k[0] + sum(
                K[0, j] * ds[j] for j in range(_N) if j != 4)
            u1_ = u_b[1] + alpha_col * k[1] + sum(
                K[1, j] * ds[j] for j in range(_N) if j != 4)
            u0_ = torch.clamp(u0_, lb0, ub0)
            u1_ = torch.clamp(u1_, lb1, ub1)
            accs = accs + stage_cost(S, u0_, u1_, rate, t)
            se = se_of(cts, sts, S)
            s_n = dyn_step(S, u0_, u1_, cts, sts, se)
            cts, sts = step_trig(cts, sts, dth_of(S[3], u0_), s_n)
            S = s_n
        costs = accs + term_cost(S)

        picked = zeros
        alpha_sel = zeros
        cost_sel = cost
        for a in range(n_alpha):
            improved = (costs[a] < cost).to(dtype)
            take = improved * (1.0 - torch.clamp(picked, max=1.0))
            picked = picked + take
            alpha_sel = alpha_sel + take * alphas[a]
            cost_sel = torch.where(take > 0.5, costs[a], cost_sel)
        if diag is not None:
            on_ = act > 0.5
            diag[:n_alpha] = torch.where(on_, costs, diag[:n_alpha])
            diag[n_alpha] = torch.where(on_, cost, diag[n_alpha])
            diag[n_alpha + 1] = torch.where(on_, alpha_sel, diag[n_alpha + 1])
        accepted = torch.clamp(picked, max=1.0)
        upd = accepted * act
        keep = 1.0 - upd
        if design:
            # the kernel's paths: the winner's replay on accepted lanes and
            # no change on rejected ones where every backward row is
            # finite, the blend on the other running lanes and, while their
            # tile runs, on the done lanes whose `dirt` is not finite or
            # whose backward of this iteration (the kernel's probe; the
            # same every iteration while the lane keeps its state) is not,
            # nothing on the other done lanes
            on_ = act > 0.5
            runs = on_ | ((done > 0.5) & (~clean | ~torch.isfinite(chk))
                          & _tile_runs(done, kn))
            blend = runs & ~torch.isfinite(chk)
            take_new = on_ & ~blend & (upd > 0.5)

            def mix(new, old, blended):
                return torch.where(blend, blended,
                                   torch.where(take_new, new, old))
        else:
            def mix(new, old, blended):
                return blended

        # ---- winner re-roll into the other buffer (masked) ----
        nxt = 1 - cur
        traj_s[nxt][0] = s0_t[:6]
        s_a = s0_t
        ct, st = ct00, st00
        for t in range(T):
            s_b = read_s(cur, t)
            u_b = traj_u[cur][t]
            k, K = ks[t], Ks[t]
            ds = [s_a[j] - s_b[j] for j in range(_N)]
            u0_ = u_b[0] + alpha_sel * k[0] + sum(
                K[0, j] * ds[j] for j in range(_N) if j != 4)
            u1_ = u_b[1] + alpha_sel * k[1] + sum(
                K[1, j] * ds[j] for j in range(_N) if j != 4)
            u0_ = torch.clamp(u0_, lb0, ub0)
            u1_ = torch.clamp(u1_, lb1, ub1)
            se = se_of(ct, st, s_a)
            g_n = (ct, st, se, ce_of(ct, st, s_a))
            # the trig cache blends like the states it describes; in place
            # is safe (nothing reads knot t again before the next backward)
            traj_g[t] = tuple(mix(g, g_old, upd * g + keep * g_old)
                              for g, g_old in zip(g_n, traj_g[t]))
            s_n = dyn_step(s_a, u0_, u1_, ct, st, se)
            traj_u[nxt][t] = tuple(
                mix(u_n, u_o, upd * u_n + keep * u_o)
                for u_n, u_o in zip((u0_, u1_), u_b))
            traj_s[nxt][t + 1] = [
                mix(s_n[i], traj_s[cur][t + 1][i],
                    upd * s_n[i] + keep * traj_s[cur][t + 1][i])
                for i in range(6)]
            ct, st = step_trig(ct, st, dth_of(s_a[3], u0_), s_n)
            s_a = s_n
        cost2 = torch.where(upd > 0.5, cost_sel, cost)
        if design:
            clean = torch.where(runs, torch.isfinite(chk) & _trajectory_finite(
                traj_s[nxt], traj_u[nxt]), clean)

        # ---- per-lane bookkeeping ----
        on = act > 0.5
        mu2 = torch.where(
            upd > 0.5, torch.maximum(mu / kn.mu_factor, mu_lo),
            torch.where(on, torch.minimum(mu * kn.mu_factor, mu_hi), mu))
        small_step = accepted * (
            torch.abs(cost - cost2)
            <= kn.tol_cost_eff * (wscl + torch.abs(cost))).to(dtype)
        n_small2 = torch.where(
            on, torch.where(small_step > 0.5, n_small + 1.0, zeros), n_small)
        # a tiny predicted decrease certifies only with the trust region
        # open; under inflated mu it is a stall only if the step was also
        # rejected (mu_open reads the OLD mu)
        mu_open = (mu <= mu_lo * kn.mu_factor).to(dtype)
        converged_now = torch.maximum(
            torch.maximum((pg < kn.tol_grad).to(dtype),
                          (n_small2 >= 2.0).to(dtype)),
            tiny_model * mu_open)
        stalled = torch.maximum(
            (1.0 - accepted) * (mu2 >= mu_hi).to(dtype),
            tiny_model * (1.0 - mu_open) * (1.0 - accepted))
        done2 = torch.where(on, torch.maximum(converged_now, stalled), done)
        conv = torch.where(on, converged_now, conv)
        gnorm = torch.where(on, pg, gnorm)
        iters = iters + act
        cost, mu, n_small, done = cost2, mu2, n_small2, done2
        cur = nxt
        it += 1

    ss = torch.stack([torch.stack(read_s(cur, t)) for t in range(T + 1)])
    us = torch.stack([torch.stack(traj_u[cur][t]) for t in range(T)])
    return ss, us, cost, conv, iters, gnorm, mu, done


# ---------------------------------------------------------------- CUDA


def scratch_shapes(T: int, n_ls: int, B: int) -> list:
    """The kernel's scratch buffers, which the wrapper allocates: the
    rollout's trig cache traj_g (T, 4, B), the gains ks (T, 2, B) and Ks
    without K's structurally zero column (T, 2, 7, B), and the line
    search's clamped controls cand_u (n_ls, T, 2, B), B being the batch
    or, on the persistent grid, its threads. One lane per thread, the
    trajectory itself lives in the outputs ss and us."""
    return [(T, 4, B), (T, _M, B), (T, _M, _N - 1, B), (n_ls, T, _M, B)]


def work_rows(T: int, n_blobs: int = 0, setp: bool = False) -> int:
    """Rows of the persistent grid's slot-indexed working set (each as long
    as the grid's threads): the trajectory's (T+1, 8) states, of which
    rows 0-5 are used, and (T, 2) controls, then the setpoint profile
    (T+1, 3) and the blobs' 4 x n_blobs that the variant reads at every
    knot, copied in once per lane."""
    return (T + 1) * _N + T * _M + 3 * (T + 1) * bool(setp) + 4 * n_blobs


def refill_slots(B: int, blocks_per_sm: int, n_sm: int) -> int:
    """The threads of K1's persistent grid for a batch of B lanes: every
    thread the card holds at once (`blocks_per_sm` blocks of TILE threads
    on each of `n_sm` SMs) where the batch has at least
    REFILL_LANES_PER_SLOT lanes for each, else 0 (one thread per lane). On
    the persistent grid a thread whose lane is done takes the next one, so
    no warp or block runs to its slowest lane."""
    slots = max(0, int(blocks_per_sm)) * max(0, int(n_sm)) * TILE
    return slots if slots and B >= REFILL_LANES_PER_SLOT * slots else 0


def pace(iters) -> torch.Tensor:
    """A call's pacing by its tiles, 0-d: the mean of each whole TILE-lane
    tile's most SQP iterations over (the mean iterations + 1). The
    persistent grid pays at GRID_PACE or more."""
    n = iters.shape[-1] // TILE * TILE
    tiles = iters[..., :n].reshape(-1, TILE).amax(dim=1).mean()
    return tiles / (iters.mean() + 1.0)


def grid_pays(seen) -> bool:
    """Whether the last call of a shape (`_PACE`: its pacing copied to
    pinned memory, the copy's event, the last verdict read) says the
    persistent grid pays; a copy still in flight keeps the verdict before
    it, and a shape not seen yet runs one thread per lane."""
    if seen is None:
        return False
    if seen["event"].query():
        seen["pays"] = float(seen["host"]) >= GRID_PACE
    return seen["pays"]


def tile_shift(n_tiles: int) -> int:
    """The tile the next launch of the per-tile exit over `n_tiles` tiles
    starts at (its block b solves tile (b + shift) mod n_tiles): the
    launch count times 0x9E3779B1 (about 2**32 over the golden ratio), mod
    n_tiles, so that the launches of one batch start spread over its
    tiles."""
    global tile_launches
    tile_launches += 1
    return tile_launches * 0x9E3779B1 % n_tiles


def tile_words(B: int) -> int:
    """Ints of the persistent grid's launch buffer: the claim counter, the
    refilled lanes and the re-solved tiles, then two per TILE-lane tile
    (its most iterations, and its lanes that blend after they are
    done)."""
    return 3 + 2 * (-(-B // TILE))


# Floats per knot that one SQP iteration of one lane moves through device
# memory, by phase (backward, line search, re-roll), counted from the
# kernel source; "replay" is the kernel, "recompute" the double-buffered
# design it replaced, whose re-roll recomputed u_b + alpha k + K ds and
# blended every lane. replay: the backward reads s, u, g (12) and writes k,
# K (16); the line search reads s, u, k, K (24) and writes 2 n_ls controls;
# the re-roll reads 2 and writes 12, on accepted steps only. recompute: the
# backward reads s, u_{t-1}, u, g (14) and writes k, K (18); the line
# search reads s, u_{t-1}, u, k, K (26); the re-roll reads those 26, the old
# g (4) and the old s(t+1) (6) and writes g, u, s (12), on every lane.
LAYOUTS = ("replay", "recompute")


def knot_floats(layout: str, n_ls: int) -> tuple:
    """(backward, line search, re-roll) floats per knot and SQP iteration
    of the layout (see LAYOUTS)."""
    if layout == "replay":
        return (12 + 16, 24 + 2 * n_ls, 2 + 12)
    if layout == "recompute":
        return (14 + 18, 26, 26 + 4 + 6 + 12)
    raise ValueError(f"layout is one of {LAYOUTS}, got {layout!r}")


def scratch_bytes(T: int, n_ls: int, layout: str = "replay",
                  n_blobs: int = 0, setp: bool = False,
                  accepted: bool = True) -> int:
    """Bytes one SQP iteration of one lane moves through device memory by
    the kernel's design (`knot_floats`): the backward and the line search,
    and the re-roll if the step was `accepted` (the recompute layout
    re-rolls every lane), plus the per-knot inputs its variant reads in
    the backward and the line search: the setpoint profile's 3 floats and
    each blob's 4 (a candidate's re-read of them hits L1 and is not
    counted)."""
    bwd, ls, reroll = knot_floats(layout, n_ls)
    per_knot = bwd + ls
    if accepted or layout == "recompute":
        per_knot += reroll
    per_knot += 2 * (3 * bool(setp) + 4 * n_blobs)
    return 4 * T * per_knot


def occupancy(variant) -> dict:
    """What one built variant of the kernel occupies on the current CUDA
    device: registers and local memory per thread, the knot ring's shared
    memory per block, and resident blocks per SM
    (`cudaOccupancyMaxActiveBlocksPerMultiprocessor`)."""
    from . import _build

    launch = _build.load("solve_mega", variant)
    out = (ctypes.c_int * 7)()
    fn = launch.lib.mpc_solve_mega_occupancy
    fn.argtypes = [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    _build.check(launch, fn(out), "solve_mega occupancy")
    return dict(zip(("registers", "local_bytes", "smem_bytes_per_block",
                     "blocks_per_sm", "refill_registers",
                     "refill_local_bytes", "refill_blocks_per_sm"), out))


_RESIDENCY: dict = {}
# per (variant, horizon, B, device): the pacing of the last call that the
# shape rule let onto the persistent grid, read without a synchronization
_PACE: dict = {}


def _residency(variant, dev) -> tuple:
    """(blocks per SM of the persistent grid, SMs) of a variant on a
    device, read once."""
    key = (tuple(variant), dev.index)
    got = _RESIDENCY.get(key)
    if got is None:
        with torch.cuda.device(dev):
            got = (occupancy(variant)["refill_blocks_per_sm"],
                   torch.cuda.get_device_properties(dev).multi_processor_count)
        _RESIDENCY[key] = got
    return got



def solve_mega_cuda(zT, cT, pp, lb, ub, u0, cfg, resume=None,
                    lockstep=False, blobs=None, refs=None, diag=None):
    """Launch the hand-written kernel (`csrc/solve_mega.cu`) on CUDA
    float32 tensors; raises on anything else. Allocates every output and
    scratch buffer; launches on the current stream and does not
    synchronize. At `done_frac = 1` a batch of `REFILL_LANES_PER_SLOT`
    lanes or more per resident thread runs on the persistent grid where
    the last call of its shape paced at GRID_PACE or more (`refill_slots`,
    `grid_pays`), bit for bit what one thread per lane computes.
    `lockstep=True` launches the per-block loop of `done_frac < 1` whatever
    `done_frac`; at `done_frac = 1` it computes what the per-thread loop
    does, so the two can be timed against each other. Blobs and setpoints select the kernel's BLOBS and SETP
    variants (the number of blobs is a runtime argument), the bicycle
    family its BICYCLE variant. `diag`: the line-search diagnostic
    (`check_diag`), off the main path."""
    global launches
    with span("k1.dispatch"):
        with span("k1.prepare"):
            launch, kn, ins, opt = _cuda_inputs(
                zT, cT, pp, lb, ub, u0, cfg, resume, lockstep, blobs, refs,
                diag)
        with span("k1.launch"):
            out = _cuda_launch(launch, kn, ins, opt, diag)
    launches += 1
    return out


def _cuda_inputs(zT, cT, pp, lb, ub, u0, cfg, resume, lockstep, blobs, refs,
                 diag):
    """`solve_mega_cuda`'s checks: the launcher of the variant, its knobs,
    the six inputs contiguous and the optional ones (resume, refs,
    blobs)."""
    args = ((zT, cT, pp, lb, ub, u0) + tuple(resume or ())
            + tuple(blobs or ()) + (() if refs is None else (refs,)))
    for a in args:
        if not a.is_cuda:
            raise ValueError("solve_mega_cuda needs CUDA tensors, got one "
                             f"on {a.device}")
        if a.dtype != torch.float32:
            raise ValueError("solve_mega_cuda computes in float32, got "
                             f"{a.dtype}")
        if a.device != zT.device:
            raise ValueError("solve_mega_cuda inputs must share a device")
    kn = dataclasses.replace(_knobs_for(cfg, torch.float32, blobs, refs),
                             lockstep=bool(lockstep))
    T = kn.T
    B = _check_inputs(zT, cT, pp, lb, ub, u0, kn, resume, blobs, refs)
    check_diag(diag, kn, zT)
    P = cT.shape[0]
    if P > 8:
        raise ValueError(f"the kernel takes polynomials up to order 7 "
                         f"(P <= 8), got P={P}")
    if T < 1 or not 1 <= kn.n_ls <= 8:
        raise ValueError(f"the kernel takes T >= 1 and 1 <= n_ls <= 8, "
                         f"got T={T}, n_ls={kn.n_ls}")
    if max(16 * T, 8 * (T + 1)) * B >= 2 ** 31:
        raise ValueError(f"the kernel addresses rows by 32-bit offsets: "
                         f"T={T} and B={B} are too large")
    ins = [a.contiguous() for a in args[:6]]
    # (4, B): done, conv, mu, gnorm
    res = None if resume is None else torch.stack(list(resume))
    opt = [res, None if refs is None else refs.contiguous()] + (
        [None] * 4 if blobs is None else [b.contiguous() for b in blobs])
    from . import _build

    return _build.load("solve_mega", kn.variant), kn, ins, opt


def outputs(T: int, B: int, slots: int, dev) -> tuple:
    """The kernel's outputs, uninitialized: ss (T+1, 8, B), us (T, 2, B)
    and six (B,) tensors. One thread per lane (`slots` = 0) they are
    batch-minor, as a warp writes a row of 32 neighbouring lanes at once.
    On the persistent grid, where a warp's lanes are scattered, they are
    views of lane-major arrays, so that each thread writes whole rows of
    its own lane: ss of a (B, T+1, 8) array, us of its rows 6-7 of knots
    1..T (the control before each knot is the knot's control), and the
    six of one (B, 6) array."""
    def empty(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    if not slots:
        return empty(T + 1, _N, B), empty(T, _M, B), [empty(B)
                                                      for _ in range(6)]
    ss = empty(B, T + 1, _N)
    return (ss.permute(1, 2, 0), ss[:, 1:, 6:].permute(1, 2, 0),
            list(empty(B, 6).unbind(1)))


def _cuda_launch(launch, kn, ins, opt, diag):
    """`solve_mega_cuda`'s outputs and scratch, allocated, and the
    launcher's call on the current stream: one thread per lane, or the
    persistent grid (`_grid_choice`) with its slot-indexed scratch and
    working set and its int buffer, whose counts become `refilled_lanes`
    and `retiled_tiles`; a call the shape rule lets onto the grid queues
    its pacing for the next (`_observe`)."""
    global refilled_lanes, retiled_tiles
    from . import _build

    T, B, P = kn.T, ins[0].shape[-1], ins[1].shape[0]
    dev = ins[0].device
    f32 = torch.float32
    key, slots = (None, 0) if kn.tile_exit else _grid_choice(kn, B, dev)
    shift = tile_shift(B // TILE) if kn.tile_exit else 0

    def empty(*shape):
        return torch.empty(shape, dtype=f32, device=dev)

    ss, us, outs = outputs(T, B, slots, dev)
    scratch = [empty(*shape)
               for shape in scratch_shapes(T, kn.n_ls, slots or B)]
    work = tiles = None
    if slots:
        work = empty(work_rows(T, kn.n_blobs, kn.has_setp), slots)
        tiles = torch.empty(tile_words(B), dtype=torch.int32, device=dev)
    ptr = [ctypes.c_void_p(a.data_ptr()) for a in ins]
    ptr += [ctypes.c_void_p(None if a is None else a.data_ptr())
            for a in opt]
    ptr += [ctypes.c_void_p(a.data_ptr()) for a in [ss, us] + outs]
    ptr += [ctypes.c_void_p(None if diag is None else diag.data_ptr())]
    ptr += [ctypes.c_void_p(a.data_ptr()) for a in scratch]
    ptr += [ctypes.c_void_p(None if a is None else a.data_ptr())
            for a in (work, tiles)]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = launch(
            *ptr, ctypes.c_int(P), ctypes.c_int(B), ctypes.c_int(T),
            ctypes.c_int(kn.max_iters), ctypes.c_int(kn.n_done_needed),
            ctypes.c_int(kn.n_blobs), ctypes.c_int(slots),
            ctypes.c_int(shift), ctypes.c_float(kn.sign),
            ctypes.c_float(kn.tol_grad), ctypes.c_float(kn.tol_cost_eff),
            ctypes.c_float(kn.mu_min), ctypes.c_float(kn.mu_max),
            ctypes.c_float(kn.mu_factor), ctypes.c_float(kn.ddp_gate),
            *(ctypes.c_int(int(v)) for v in kn.variant),
            ctypes.c_void_p(stream))
    _build.check(launch, err, "solve_mega")
    refilled_lanes = 0 if tiles is None else tiles[1]
    retiled_tiles = 0 if tiles is None else tiles[2]
    if key is not None:
        _observe(key, outs[2], dev)
    return (ss, us, *outs)


def _grid_choice(kn, B: int, dev) -> tuple:
    """(the key under which a call's pacing is kept, or None; the threads
    of the persistent grid, or 0 for one thread per lane) of a per-thread
    exit over B lanes: the grid where the shape rule lets the batch on
    (`refill_slots`) and the last call of the same variant, horizon and
    batch paced at GRID_PACE or more (`grid_pays`). The tests replace it
    to launch a given grid."""
    slots = refill_slots(B, *_residency(kn.variant, dev))
    if not slots:
        return None, 0
    key = (kn.variant, kn.T, B, dev.index)
    return key, slots if grid_pays(_PACE.get(key)) else 0


def _observe(key, iters, dev) -> None:
    """Queue the pacing of a call (`pace` of its iterations) into pinned
    memory for the next call of its shape, unless the last copy is still
    in flight."""
    seen = _PACE.get(key)
    if seen is None:
        seen = _PACE[key] = {
            "host": torch.zeros((), dtype=torch.float32, pin_memory=True),
            "event": torch.cuda.Event(), "pays": False}
    if not seen["event"].query():
        return
    seen["pays"] = float(seen["host"]) >= GRID_PACE
    with torch.cuda.device(dev):
        seen["host"].copy_(pace(iters), non_blocking=True)
        seen["event"].record()


def solve_mega(zT, cT, pp, lb, ub, u0, cfg, resume=None, blobs=None,
               refs=None, diag=None):
    """The megakernel solve: CPU tensors run `solve_mega_plain`, CUDA
    tensors the kernel (float32 only; anything else raises)."""
    fn = solve_mega_cuda if zT.is_cuda else solve_mega_plain
    return fn(zT, cT, pp, lb, ub, u0, cfg, resume, blobs=blobs, refs=refs,
              diag=diag)


# ------------------------------------------------------------ schedules


def _pass(zT, cT, pp, lb, ub, u0, cfg, plain, resume=None, blobs=None,
          refs=None):
    """One solve pass of a schedule, counted."""
    global passes
    passes += 1
    fn = solve_mega_plain if plain else solve_mega
    return fn(zT, cT, pp, lb, ub, u0, cfg, resume, blobs=blobs, refs=refs)


def solve_mega_scheduled(zT, cT, pp, lb, ub, u0, cfg, plain=False,
                         blobs=None, refs=None):
    """The megakernel under the SolverConfig iteration schedule
    (counterpart of `solve_pallas_scheduled`): "auto" resolves to the
    compact schedule at n_steps > 36 and to the single pass otherwise;
    "sorted" with 1 <= presolve_iters < max_sqp_iters runs the sorted two
    passes; anything else one pass. `plain=True` runs every pass on the
    plain version, whatever the device (to hold the kernel's schedule
    against it on the card). Blobs and setpoints travel with their lanes
    through every permutation and gather."""
    schedule = cfg.schedule
    if schedule == "auto" and cfg.n_steps > 36:
        schedule = "compact"
    if schedule == "compact":
        return _solve_compact(zT, cT, pp, lb, ub, u0, cfg, plain, blobs,
                              refs)
    k1 = cfg.presolve_iters
    if cfg.schedule == "sorted" and 1 <= k1 < cfg.max_sqp_iters:
        return _solve_sorted(zT, cT, pp, lb, ub, u0, cfg, plain, blobs, refs)
    return _pass(zT, cT, pp, lb, ub, u0, cfg, plain, blobs=blobs, refs=refs)


def _take(idx, blobs, refs):
    """The blobs and setpoints of the lanes `idx`, in that order."""
    return (None if blobs is None else
            tuple(b.index_select(-1, idx) for b in blobs),
            None if refs is None else refs.index_select(-1, idx))


def _solve_sorted(zT, cT, pp, lb, ub, u0, cfg, plain, blobs=None,
                  refs=None):
    """Sorted two passes (`solve_pallas_scheduled`): `presolve_iters`
    iterations for every lane; a stable sort putting done lanes first and
    the rest by projected gradient; the remaining budget on the permuted
    batch, resumed; the outputs back in the caller's order, with the two
    passes' iterations added."""
    k1 = cfg.presolve_iters
    cfg1 = dataclasses.replace(cfg, max_sqp_iters=k1)
    cfg2 = dataclasses.replace(cfg, max_sqp_iters=cfg.max_sqp_iters - k1)
    ss1, us1, cost1, conv1, it1, gn1, mu1, done1 = _pass(
        zT, cT, pp, lb, ub, u0, cfg1, plain, blobs=blobs, refs=refs)
    with span("k1.schedule"):
        key = torch.where(done1 > 0.5, torch.full_like(gn1, -1.0), gn1)
        # stable, as jnp.argsort: equal keys keep their order, so lanes
        # land in the same tiles as in the JAX package
        perm = torch.argsort(key, stable=True)
        inv_perm = torch.argsort(perm, stable=True)

        def tk(a):
            return a.index_select(-1, perm)

        blobs2, refs2 = _take(perm, blobs, refs)
        ins2 = (tk(zT), tk(cT), tk(pp), tk(lb), tk(ub), tk(us1))
        resume2 = (tk(done1), tk(conv1), tk(mu1), tk(gn1))
    outs = _pass(*ins2, cfg2, plain, resume=resume2, blobs=blobs2,
                 refs=refs2)
    with span("k1.schedule"):
        ss, us, cost, conv, it2, gnorm, mu, done = (
            a.index_select(-1, inv_perm) for a in outs)
        return ss, us, cost, conv, it1 + it2, gnorm, mu, done


def compact_n_tail(B: int, cfg) -> int:
    """The compact tail's lanes: ceil(compact_tail * B / TILE) tiles, at
    least one and at most the batch (then the schedule is one pass)."""
    n_tail = int(-(-B * cfg.compact_tail // TILE)) * TILE
    return max(TILE, min(n_tail, B))


def compact_pass1_cfg(cfg):
    """Pass 1 of the compact schedule: each tile stops once `compact_frac`
    of its lanes are done."""
    return dataclasses.replace(cfg, done_frac=cfg.compact_frac)


@dataclasses.dataclass
class CompactTail:
    """Pass 2 of the compact schedule, built from pass 1's outputs: the
    tail's lanes `sel` (those that need work first, in stable order), its
    inputs (zT, cT, params, lb, ub, and pass 1's controls as u0), its
    config, resume state, blobs and setpoints, and `need`, the number of
    lanes that needed pass 2 (0-d)."""

    sel: torch.Tensor
    ins: tuple
    cfg: object
    resume: tuple
    blobs: tuple
    refs: torch.Tensor
    need: torch.Tensor


def compact_tail(ins, out1, cfg, blobs=None, refs=None) -> CompactTail:
    """Gather pass 2 of the compact schedule from the inputs `ins` (zT,
    cT, params, lb, ub, u0) and pass 1's outputs `out1`. Under the
    long-horizon pair the stalled lanes (done but not converged) need
    work too; pass 2 runs the conservative gate 0.75 at the same mu floor
    1e-2 with twice the iteration budget, and stalled lanes re-enter with
    done cleared, mu reset to the (weight-scaled) floor and gnorm at
    +inf."""
    zT, cT, pp, lb, ub, _ = ins
    _, us1, _, conv1, _, gn1, mu1, done1 = out1
    dtype = zT.dtype
    has_obs = blobs is not None
    pair = cfg._long_horizon_pair(dtype, has_obs)
    need = ((done1 < 0.5) | (conv1 < 0.5)) if pair else done1 < 0.5
    sel = torch.argsort((~need).to(torch.uint8), stable=True)[
        :compact_n_tail(zT.shape[-1], cfg)]

    def tk(a):
        return a.index_select(-1, sel)

    cfg2 = dataclasses.replace(cfg, done_frac=1.0)
    if pair:
        cfg2 = dataclasses.replace(cfg2, ddp_gate=0.75, mu_init=1e-2,
                                   max_sqp_iters=2 * cfg.max_sqp_iters)
    d1s, c1s, m1s, g1s = tk(done1), tk(conv1), tk(mu1), tk(gn1)
    if pair:
        stalled1 = (d1s > 0.5) & (c1s < 0.5)
        floor2 = torch.full_like(m1s, cfg2.mu_init_for(dtype, has_obs))
        if cfg.scale_adaptive:
            # the kernel's mu floor is weight-scaled per lane, and so is
            # the reset: s = max(1, sum(w) / 470)
            pt = tk(pp)
            floor2 = floor2 * torch.clamp(
                (pt[P_WCTE] + pt[P_WETH] + pt[P_WVEL] + pt[P_WANG]
                 + pt[P_WACC] + pt[P_WDANG] + pt[P_WDACC]) * (1.0 / 470.0),
                min=1.0)
        d1s = torch.where(stalled1, torch.zeros_like(d1s), d1s)
        m1s = torch.where(stalled1, floor2, m1s)
        g1s = torch.where(stalled1, torch.full_like(g1s, float("inf")), g1s)
    blobs2, refs2 = _take(sel, blobs, refs)
    return CompactTail(sel, (tk(zT), tk(cT), tk(pp), tk(lb), tk(ub),
                             tk(us1)), cfg2, (d1s, c1s, m1s, g1s), blobs2,
                       refs2, need.sum())


def _count_need(need: torch.Tensor) -> None:
    """Add a 0-d count to `need_lanes` on its device and current stream."""
    key = (need.device, torch.cuda.current_stream(need.device).stream_id
           if need.device.type == "cuda" else None)
    need_lanes[key] = need_lanes.get(key, 0) + need


def need_total() -> int:
    """The sum of `need_lanes` over devices and streams (synchronizes each
    device that holds a count)."""
    for dev in {d for d, _ in need_lanes if d.type == "cuda"}:
        torch.cuda.synchronize(dev)
    return sum(int(n) for n in need_lanes.values())


def _solve_compact(zT, cT, pp, lb, ub, u0, cfg, plain, blobs=None,
                   refs=None):
    """Compact straggler schedule (`_solve_compact` of the JAX package).

    Pass 1 runs the whole batch with each tile stopping once
    `compact_frac` of its lanes are done. The lanes that still need work
    are gathered into a tile-granular tail of `compact_n_tail` lanes,
    padded with done lanes (`compact_tail`). Pass 2 resumes the tail to
    completion and the results are scattered back. Lanes that need pass 2
    beyond the tail keep their pass-1 iterate and report unconverged;
    `last_need` counts them in, `need_lanes` counts the tail's lanes that
    needed pass 2 (at most the tail). Pass 2 runs in the span `k1.tail`."""
    global tail_lanes, last_need
    ins = (zT, cT, pp, lb, ub, u0)
    n_tail = compact_n_tail(zT.shape[-1], cfg)
    if n_tail >= zT.shape[-1]:
        # batch too small for a compaction win — single pass
        return _pass(*ins, cfg, plain, blobs=blobs, refs=refs)
    out1 = _pass(*ins, compact_pass1_cfg(cfg), plain, blobs=blobs, refs=refs)
    with span("k1.schedule"):
        tail = compact_tail(ins, out1, cfg, blobs, refs)
    last_need = tail.need
    _count_need(tail.need.clamp(max=n_tail))
    tail_lanes += n_tail
    with span("k1.tail"):
        out2 = _pass(*tail.ins, tail.cfg, plain, resume=tail.resume,
                     blobs=tail.blobs, refs=tail.refs)
    ss1, us1, cost1, conv1, it1, gn1, mu1, done1 = out1
    ss2, us2, cost2, conv2, it2, gn2, mu2, done2 = out2
    sel = tail.sel

    def scat(full, part):
        return full.index_copy(full.dim() - 1, sel, part)

    with span("k1.schedule"):
        return (scat(ss1, ss2), scat(us1, us2), scat(cost1, cost2),
                scat(conv1, conv2), it1.index_add(0, sel, it2),
                scat(gn1, gn2), scat(mu1, mu2), scat(done1, done2))
