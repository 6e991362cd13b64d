"""Control-limited iLQR / SQP solver (counterpart of
`mpc_ros_tpu/solver/ilqr.py`), the behavioural spec of the whole solver.

It solves the reference NLP in condensed (single-shooting) form: the
states are eliminated through the dynamics, the decision variables are
the T = N-1 controls, and the box bounds on the controls are handled
exactly by a control-limited Riccati backward pass (a 2-D box QP per
stage, `boxqp.solve_boxqp_2d`). It is generic over the model registry:
the Jacobians come from the family (`Model.aug_step_jacobians`) and the
exact dynamics Hessians of the gated GN -> DDP terms from autodiff
(`step_hessians`, forward-mode twice).

Layout. The JAX package solves one scenario per `lax.while_loop` and
batches with `jax.vmap`. Here `solve` is batch-first: every array carries
the batch in front (z0 (B, 6), us (B, T, 2), ss (B, T+1, 8)), each lane
has its own done flag, and the loop reads "every lane done" on the host
once per iteration (`host_reads` counts those reads; each is the span
`sync.ilqr`, `obs.span`). The body runs on
every lane and a lane that is done keeps its state, its `n_iters` and its
`converged`, which is what `jax.vmap` of the `while_loop` does. One
scenario is B = 1: `solve` takes z0 (6,) and returns unbatched results.
Per-scenario MPCParams leaves of shape (B,) ride the batch; they reach
the autodiff of `step_hessians` mapped per lane (`base.lane_map`).

A grid costmap (`omap`, an `ObstacleMap`) is one map shared by every
lane (grid (H, W)) or one map per lane (grid (B, H, W)), sampled as the
JAX function mapped over the scenarios samples it. With
`SolverConfig.horizon_parallel` the backward is the associative-scan
Riccati of `solver/riccati.py` (`backward_pass_parallel`), O(log T) deep.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..config import MPCParams, SolverConfig
from ..models import diff_drive as dd
from ..models.base import Model, get_model, lane_map
from ..models.costs import (ref_state_vector, scaled_solver_knobs,
                            stage_expansion_aug, state_weights, total_cost)
from ..models.obstacles import (blob_concave_bl, blob_terms_bl,
                                obstacle_curv_xy, obstacle_grad_xy,
                                obstacle_knot_cost)
from ..obs.timers import span
from ..ops.consts import const
from .boxqp import solve_boxqp_2d
from .types import SolveResult

_S = dd.AUG_STATE_DIM   # 8
_M = dd.CONTROL_DIM     # 2

# host reads of the loop's exit condition (one per iteration run, plus the
# read that ends the loop before the cap)
host_reads = 0


def _lane_params(p: MPCParams, extra: int = 0) -> MPCParams:
    """p with every per-scenario leaf (B,) reshaped to (B,) + (1,) * extra,
    so that it broadcasts against arrays with `extra` more axes after the
    batch; shared leaves are unchanged."""
    def view(v):
        if isinstance(v, torch.Tensor) and v.dim() > 0:
            return v.reshape(v.shape + (1,) * extra)
        return v
    return MPCParams(**{f.name: view(getattr(p, f.name))
                        for f in dataclasses.fields(p)})


def _blob_lanes(blobs, extra: int = 0):
    """The blobs as four lane-major (K, B) tensors, reshaped to (K, B) +
    (1,) * extra to broadcast against (B, ...) points."""
    return tuple(a.transpose(0, 1).reshape(a.shape[::-1] + (1,) * extra)
                 for a in (blobs.cx, blobs.cy, blobs.gamma, blobs.w))


def _rollout_aug(z0, us, coeffs, dt, sign, mdl: Model, p: MPCParams):
    """Augmented-state rollout: z0 (B, 6), us (B, T, 2) -> ss (B, T+1, 8)
    with s = (z, prev_u)."""
    s = torch.cat([z0, torch.zeros(z0.shape[:-1] + (_M,), dtype=z0.dtype,
                                   device=z0.device)], dim=-1)
    ss = [s]
    for t in range(us.shape[-2]):
        s = mdl.aug_step(s, us[:, t], coeffs, dt, sign, p)
        ss.append(s)
    return torch.stack(ss, dim=1)


def _linearize_and_expand(ss, us, coeffs, p: MPCParams, dt, sign,
                          mdl: Model, omap=None, blobs=None, refs=None):
    """Per-stage Jacobians and exact cost quadratics along trajectories,
    all stages at once: A (B, T, 8, 8), Bm (B, T, 8, 2), l_s (B, T, 8),
    l_u (B, T, 2), l_ss (B, T, 8, 8), l_uu (B, T, 2, 2), l_us (B, T, 2, 8).
    `omap` adds the costmap penalty's gradient and PSD curvature to
    l_s / l_ss, `blobs` (leaves (B, K)) their exact gradient and
    Gauss-Newton curvature; `refs` (B, N, 3) the per-knot setpoints."""
    T = us.shape[1]
    dtype, dev = ss.dtype, ss.device
    rate_on = torch.cat([torch.zeros((1,), dtype=dtype, device=dev),
                         torch.ones((T - 1,), dtype=dtype, device=dev)])
    p1 = _lane_params(p, 1)
    dt1 = dt.reshape(dt.shape + (1,) * (dt.dim() > 0))
    A, Bm = mdl.aug_step_jacobians(ss[:, :-1], us, coeffs[:, None], dt1,
                                   sign, p1)
    l_s, l_u, l_ss, l_uu, l_us = stage_expansion_aug(
        ss[:, :-1], us, rate_on, p1, None if refs is None else refs[:, :-1])
    l_s, l_ss = l_s.clone(), l_ss.clone()
    if omap is not None:
        xy = ss[:, :-1, :2]
        l_s[..., 0:2] += obstacle_grad_xy(omap, xy)
        # the PSD curvature of the grid term: without it hard lanes die in
        # rejected-step spirals (see obstacle_curv_bl)
        hxx, hyy = obstacle_curv_xy(omap, xy)
        l_ss[..., 0, 0] += hxx
        l_ss[..., 1, 1] += hyy
    if blobs is not None:
        _, gx, gy, hxx, hxy, hyy = blob_terms_bl(
            *_blob_lanes(blobs, 1), ss[:, :-1, 0], ss[:, :-1, 1])
        l_s[..., 0] += gx
        l_s[..., 1] += gy
        l_ss[..., 0, 0] += hxx
        l_ss[..., 0, 1] += hxy
        l_ss[..., 1, 0] += hxy
        l_ss[..., 1, 1] += hyy
    return A, Bm, l_s, l_u, l_ss, l_uu, l_us


def _terminal_expansion(s_T, p: MPCParams, omap=None, blobs=None,
                        ref3_T=None):
    """Gradient and Hessian of the terminal tracking cost (exact, closed
    form), s_T (B, 8) -> V_s (B, 8), V_ss (B, 8, 8); with `omap` or
    `blobs` their gradient and curvature at the last knot. `ref3_T` (B, 3)
    = the last knot's (ref_cte, ref_etheta, ref_vel) row."""
    dtype, dev = s_T.dtype, s_T.device
    B = s_T.shape[0]
    wz6, ref6 = state_weights(p, dtype, dev)
    if ref3_T is not None:
        ref6 = ref_state_vector(p, dtype, ref3_T, device=dev)
    # padded to the augmented state (the prev-control rows carry no
    # terminal weight)
    pad = torch.zeros((_M,), dtype=dtype, device=dev)
    wz = torch.cat([wz6.expand(B, dd.STATE_DIM), pad.expand(B, _M)], dim=-1)
    ref = torch.cat([ref6.expand(B, dd.STATE_DIM), pad.expand(B, _M)],
                    dim=-1)
    V_s = 2.0 * wz * (s_T - ref)
    V_ss = torch.diag_embed(2.0 * wz)
    if omap is not None:
        V_s[:, 0:2] += obstacle_grad_xy(omap, s_T[:, :2])
        hxxT, hyyT = obstacle_curv_xy(omap, s_T[:, :2])
        V_ss[:, 0, 0] += hxxT
        V_ss[:, 1, 1] += hyyT
    if blobs is not None:
        _, gx, gy, hxx, hxy, hyy = blob_terms_bl(*_blob_lanes(blobs),
                                                 s_T[:, 0], s_T[:, 1])
        V_s[:, 0] += gx
        V_s[:, 1] += gy
        V_ss[:, 0, 0] += hxx
        V_ss[:, 0, 1] += hxy
        V_ss[:, 1, 0] += hxy
        V_ss[:, 1, 1] += hyy
    return V_s, V_ss


def step_hessians(ss, us, coeffs, dt, sign, mdl: Model, p: MPCParams):
    """Exact per-stage dynamics Hessians d2f_k/d(s,u)2 by forward-mode
    autodiff twice (`torch.func.jacfwd` of `jacfwd`), mapped over lanes x
    stages: (B, T, 8, 10, 10). Generic over the model registry, so any
    family of `model_from_step` gets exact second-order terms; the
    per-scenario inputs (coeffs, dt, MPCParams leaves of shape (B,)) reach
    each lane's stages mapped, not closed over."""
    from torch.func import jacfwd

    def h(c, d, pp, s_t, u_t):
        f = lambda q: mdl.aug_step(q[:_S], q[_S:], c, d, sign, pp)
        return jacfwd(jacfwd(f))(torch.cat([s_t, u_t]))

    batch = us.shape[:2]
    dt1 = dt.reshape(dt.shape + (1,) * (dt.dim() > 0))
    return lane_map(h, batch, coeffs[:, None], dt1, _lane_params(p, 1),
                    ss[:, :-1], us)


def _bmv(M, v):
    """Batched matrix @ vector over the leading dims."""
    return torch.einsum("...ij,...j->...i", M, v)


def _T(M):
    return M.transpose(-1, -2)


def backward_pass(A, B, l_s, l_u, l_ss, l_uu, l_us, V_s, V_ss, us, lb, ub,
                  mu, H=None, ddp_gate_val=None, inv_scale=None):
    """Control-limited Riccati recursion over the stages in reverse, every
    lane at once. A (B, T, 8, 8) ... us (B, T, 2), lb/ub (B, 2), mu (B,).

    `H` (B, T, 8, 10, 10) = exact dynamics Hessians (`step_hessians`):
    when given, the full-DDP contraction sum_k Vs_k H_k is added to the Q
    expansion, scaled per lane by `ddp_gate_val` (B,), the 0/1 hybrid
    GN -> DDP gate. `inv_scale` (0-d or (B,)) normalizes the projected-
    gradient measurement by the weight scale.

    Returns feedforwards k (B, T, 2), feedbacks K (B, T, 2, 8), the
    expected-improvement terms dV1, dV2 (B,) and the max projected-gradient
    norm over stages (B,)."""
    dtype, dev = us.dtype, us.device
    T = us.shape[1]
    gate = (torch.zeros((), dtype=dtype, device=dev) if ddp_gate_val is None
            else ddp_gate_val)
    iscl = (torch.ones((), dtype=dtype, device=dev) if inv_scale is None
            else torch.as_tensor(inv_scale, dtype=dtype, device=dev))
    iscl = iscl.reshape(iscl.shape + (1,) * (iscl.dim() > 0))
    eye = torch.eye(_M, dtype=dtype, device=dev)
    Vs, Vss = V_s, V_ss
    ks, Ks, dV1s, dV2s, pgs = ([None] * T for _ in range(5))
    for t in range(T - 1, -1, -1):
        A_t, B_t = A[:, t], B[:, t]
        u_t = us[:, t]
        Q_s = l_s[:, t] + _bmv(_T(A_t), Vs)
        Q_u = l_u[:, t] + _bmv(_T(B_t), Vs)
        Q_ss = l_ss[:, t] + _T(A_t) @ Vss @ A_t
        Q_us = l_us[:, t] + _T(B_t) @ Vss @ A_t
        Q_uu = l_uu[:, t] + _T(B_t) @ Vss @ B_t
        if H is not None:
            D = (torch.einsum("bkij,bk->bij", H[:, t], Vs)
                 * gate[:, None, None])
            Q_ss = Q_ss + D[:, :_S, :_S]
            Q_us = Q_us + D[:, _S:, :_S]
            Q_uu = Q_uu + D[:, _S:, _S:]
        Q_uu = 0.5 * (Q_uu + _T(Q_uu))
        Q_uu_reg = Q_uu + mu[:, None, None] * eye

        k, free, Minv = solve_boxqp_2d(Q_uu_reg, Q_u, lb - u_t, ub - u_t)
        K = Minv @ (-(free[..., :, None] * Q_us))

        KtQuu = _T(K) @ Q_uu
        Vs = Q_s + _bmv(KtQuu, k) + _bmv(_T(K), Q_u) + _bmv(_T(Q_us), k)
        KtQus = _T(K) @ Q_us
        Vss_n = Q_ss + KtQuu @ K + KtQus + _T(KtQus)
        Vss = 0.5 * (Vss_n + _T(Vss_n))

        ks[t], Ks[t] = k, K
        dV1s[t] = torch.sum(k * Q_u, dim=-1)
        dV2s[t] = torch.sum(_bmv(_T(Q_uu), 0.5 * k) * k, dim=-1)
        # projected gradient: zero where the KKT conditions hold on the box
        pgs[t] = torch.amax(torch.abs(
            u_t - torch.clamp(u_t - Q_u * iscl, lb, ub)), dim=-1)
    return (torch.stack(ks, dim=1), torch.stack(Ks, dim=1),
            torch.stack(dV1s, dim=1).sum(dim=1),
            torch.stack(dV2s, dim=1).sum(dim=1),
            torch.stack(pgs, dim=1).amax(dim=1))


def backward_pass_parallel(A, B, l_s, l_u, l_ss, l_uu, l_us, V_s, V_ss,
                           us, lb, ub, mu, n_sweeps: int = 8,
                           inv_scale=None, scan=None):
    """The exact control-limited horizon-parallel backward pass, every
    lane at once: the O(log T) associative-scan Riccati with clamped-
    dimension elimination, iterated to an active-set fixed point
    (`riccati.parallel_gains_boxed`). Shapes as `backward_pass`.

    It matches the sequential control-limited pass once the clamp pattern
    is stable. The one divergence is an inflated mu after rejected steps:
    the value recursion folds mu into l_uu (the elements need an SPD R up
    front) while the sequential pass regularizes only each stage's QP, an
    O(mu) difference that vanishes at the mu floor. `scan` overrides the
    reverse scan (the time-sharded one of `parallel.sharded`)."""
    from . import riccati

    lbd = lb[:, None, :] - us
    ubd = ub[:, None, :] - us
    ks, Ks, Q_u, Q_uu, _ = riccati.parallel_gains_boxed(
        A, B, l_s, l_u, l_ss, l_uu, l_us, V_s, V_ss, lbd, ubd, mu=mu,
        n_sweeps=n_sweeps, scan=scan or riccati.reverse_scan)
    dV1 = torch.einsum("btm,btm->bt", ks, Q_u).sum(dim=1)
    dV2 = 0.5 * torch.einsum("btm,btmk,btk->bt", ks, Q_uu, ks).sum(dim=1)
    dtype, dev = us.dtype, us.device
    iscl = (torch.ones((), dtype=dtype, device=dev) if inv_scale is None
            else torch.as_tensor(inv_scale, dtype=dtype, device=dev))
    iscl = iscl.reshape(iscl.shape + (1, 1) * (iscl.dim() > 0))
    lb1, ub1 = lb[:, None, :], ub[:, None, :]
    pg = torch.abs(us - torch.clamp(us - Q_u * iscl, lb1, ub1)).amax(
        dim=(1, 2))
    return ks, Ks, dV1, dV2, pg


def forward_pass_multi_alpha(ss_bar, us_bar, ks, Ks, alphas, z0, coeffs,
                             p: MPCParams, dt, lb, ub, sign, mdl: Model,
                             omap=None, blobs=None, refs=None):
    """Closed-loop rollouts for all candidate step sizes in one loop over
    the stages (carry (B, n_alpha, 8)). Returns ss (B, n_alpha, T+1, 8),
    us (B, n_alpha, T, 2), costs (B, n_alpha)."""
    n_alpha = alphas.shape[0]
    Bn = z0.shape[0]
    s0 = torch.cat([z0, torch.zeros((Bn, _M), dtype=z0.dtype,
                                    device=z0.device)], dim=-1)
    s_all = s0[:, None].expand(Bn, n_alpha, _S)
    p1 = _lane_params(p, 1)
    dt1 = dt.reshape(dt.shape + (1,) * (dt.dim() > 0))
    c1 = coeffs[:, None]
    lb1, ub1 = lb[:, None], ub[:, None]
    ss_out, us_out = [s_all], []
    for t in range(us_bar.shape[1]):
        ds = s_all - ss_bar[:, t, None]
        u_all = (us_bar[:, t, None] + alphas[:, None] * ks[:, t, None]
                 + torch.einsum("baj,bmj->bam", ds, Ks[:, t]))
        u_all = torch.clamp(u_all, lb1, ub1)
        s_all = mdl.aug_step(s_all, u_all, c1, dt1, sign, p1)
        ss_out.append(s_all)
        us_out.append(u_all)
    ss_new = torch.stack(ss_out, dim=2)
    us_new = torch.stack(us_out, dim=2)
    costs = _traj_cost(ss_new[..., :dd.STATE_DIM], us_new,
                       _lane_params(p, 2), omap, blobs,
                       None if refs is None else refs[:, None])
    return ss_new, us_new, costs


def _traj_cost(zs, us, p: MPCParams, omap=None, blobs=None, refs=None):
    """FG_eval objective plus the obstacle penalties over every knot: zs
    (B, ..., N, 6), us (B, ..., N-1, 2) -> (B, ...); the MPCParams leaves
    and `refs` shaped to broadcast against zs[..., 0] and zs[..., :3]."""
    J = total_cost(zs, us, p, refs)
    if omap is not None:
        J = J + obstacle_knot_cost(omap, zs[..., :2])
    if blobs is not None:
        extra = zs.dim() - 2
        val = blob_terms_bl(*_blob_lanes(blobs, extra), zs[..., 0],
                            zs[..., 1])[0]
        J = J + torch.sum(val, dim=-1)
    return J


def _batched(x, dtype, dev, rank: int):
    """x as a tensor with a batch dim in front (added when x has `rank`
    dims, the single-scenario form)."""
    if x is None:
        return None
    x = torch.as_tensor(x, dtype=dtype, device=dev)
    return x[None] if x.dim() == rank else x


@dataclasses.dataclass
class Problem:
    """What every SQP iteration of one solve reads and never writes: the
    inputs as the solver holds them and the constants built once per solve
    (bounds, tolerances, the scaled knobs, the step sizes, the DDP gate).
    Every tensor is built without a host-to-device copy (`ops.consts`), so
    a solve's only host traffic is the per-iteration read of "all done"."""

    z0: torch.Tensor
    coeffs: torch.Tensor
    p: MPCParams
    cfg: SolverConfig
    mdl: Model
    dt: torch.Tensor
    sign: float
    lb: torch.Tensor
    ub: torch.Tensor
    omap: object
    blobs: object
    refs: Optional[torch.Tensor]
    use_ddp: bool
    n_ls: int
    tol_grad: torch.Tensor
    tol_cost: torch.Tensor
    mu_min: torch.Tensor
    mu_max: torch.Tensor
    inv_scl: Optional[torch.Tensor]
    cost_guard: torch.Tensor
    mu_factor: torch.Tensor
    alphas: torch.Tensor
    gate: torch.Tensor
    rank: torch.Tensor
    ar: torch.Tensor
    single: bool
    scan: object = None


@dataclasses.dataclass
class State:
    """The SQP loop's carry, one entry per lane."""

    ss: torch.Tensor
    us: torch.Tensor
    cost: torch.Tensor
    mu: torch.Tensor
    it: torch.Tensor
    done: torch.Tensor
    gnorm: torch.Tensor
    n_small: torch.Tensor
    conv: torch.Tensor

    def copy_(self, other: "State") -> None:
        """Write `other` into this carry's tensors in place (a captured
        iteration updates its static carry so)."""
        for f in dataclasses.fields(self):
            getattr(self, f.name).copy_(getattr(other, f.name))


def prepare(z0: torch.Tensor, coeffs: torch.Tensor, p: MPCParams,
            cfg: SolverConfig, u_init: Optional[torch.Tensor] = None,
            omap=None, blobs=None, refs: Optional[torch.Tensor] = None,
            _scan=None):
    """The solve up to its loop (arguments as `solve`): the inputs batched
    and on z0's device, the per-solve constants, the warm start clipped to
    the bounds, its rollout and cost. Returns (Problem, State)."""
    if cfg.ddp != "auto" and bool(cfg.ddp) and cfg.horizon_parallel:
        # the associative-scan elements need SPD stage quadratics up
        # front, so the gated DDP contraction is sequential-path only
        raise ValueError(
            "SolverConfig.ddp is not supported with horizon_parallel "
            "(the scan elements need SPD stage quadratics); pick one")
    dtype, dev = z0.dtype, z0.device
    single = z0.dim() == 1
    z0 = _batched(z0, dtype, dev, 1)
    coeffs = _batched(coeffs, dtype, dev, 1)
    u_init = _batched(u_init, dtype, dev, 2)
    refs = _batched(refs, dtype, dev, 2)
    if blobs is not None:
        blobs = dataclasses.replace(blobs, **{
            f.name: _batched(getattr(blobs, f.name), dtype, dev, 1)
            for f in dataclasses.fields(blobs)})
    if omap is not None:
        omap = omap.for_solver(dtype, dev)
    Bn = z0.shape[0]
    T = cfg.n_controls
    mdl = get_model(cfg.model)
    dt = const(p.dt, dtype, dev)
    blb, bub = mdl.control_bounds(p, dtype, dev)     # (2,) or (2, B)
    lb = (blb.T if blb.dim() == 2 else blb).expand(Bn, _M)
    ub = (bub.T if bub.dim() == 2 else bub).expand(Bn, _M)
    if u_init is None:
        us0 = torch.zeros((Bn, T, _M), dtype=dtype, device=dev)
    else:
        us0 = torch.clamp(u_init.expand(Bn, T, _M), lb[:, None],
                          ub[:, None])
    use_ddp = cfg.ddp_for(dtype)
    n_ls = cfg.ls_for(dtype)
    sign = cfg.cte_vsin_sign
    ss = _rollout_aug(z0, us0, coeffs, dt, sign, mdl, p)
    us = us0
    p1 = _lane_params(p, 1)
    cost = _traj_cost(ss[..., :dd.STATE_DIM], us, p1, omap, blobs, refs)

    def t_(x):
        return const(x, dtype, dev)

    tol_grad = t_(cfg.tol_grad_for(dtype))
    # the relative cost tolerance can't be tighter than the dtype resolves
    tol_cost = t_(max(cfg.tol_cost, 10.0 * float(torch.finfo(dtype).eps)))
    # one-sided weight-scale equivariance (models/costs.scaled_solver_knobs):
    # mu bounds and the relative-cost guards' floor scale with s, pg is
    # measured on Q_u / s
    mu_min, mu_max, inv_scl, cost_guard = scaled_solver_knobs(
        cfg, p, dtype, dev, has_obstacles=blobs is not None,
        has_omaps=omap is not None)
    mu_factor = t_(cfg.mu_factor)
    alphas = t_(0.5) ** torch.arange(n_ls, dtype=dtype, device=dev)
    # obstacle ensembles cap the auto gate at 0.75 and restore the blob
    # Hessian's concave part (SolverConfig.gate_for)
    gate = t_(cfg.gate_for(blobs is not None, dtype,
                           has_omaps=omap is not None))
    prob = Problem(
        z0=z0, coeffs=coeffs, p=p, cfg=cfg, mdl=mdl, dt=dt, sign=sign,
        lb=lb, ub=ub, omap=omap, blobs=blobs, refs=refs, use_ddp=use_ddp,
        n_ls=n_ls, tol_grad=tol_grad, tol_cost=tol_cost, mu_min=mu_min,
        mu_max=mu_max, inv_scl=inv_scl, cost_guard=cost_guard,
        mu_factor=mu_factor, alphas=alphas, gate=gate,
        rank=torch.arange(n_ls, device=dev), ar=torch.arange(Bn, device=dev),
        single=single, scan=_scan)
    st = State(
        ss=ss, us=us, cost=cost, mu=mu_min.expand(Bn).clone(),
        it=torch.zeros((Bn,), dtype=torch.int32, device=dev),
        done=torch.zeros((Bn,), dtype=torch.bool, device=dev),
        gnorm=torch.full((Bn,), float("inf"), dtype=dtype, device=dev),
        n_small=torch.zeros((Bn,), dtype=torch.int32, device=dev),
        conv=torch.zeros((Bn,), dtype=torch.bool, device=dev))
    return prob, st


def iterate(prob: Problem, st: State) -> State:
    """One SQP iteration on every lane; a lane that is done keeps its
    state, as vmap's while_loop does. Reads nothing on the host."""
    pr, cfg = prob, prob.cfg
    p, mdl, omap, blobs, refs = pr.p, pr.mdl, pr.omap, pr.blobs, pr.refs
    ss, us, cost, mu = st.ss, st.us, st.cost, st.mu
    dtype = ss.dtype
    run = ~st.done
    A, Bm, l_s, l_u, l_ss, l_uu, l_us = _linearize_and_expand(
        ss, us, pr.coeffs, p, pr.dt, pr.sign, mdl, omap, blobs, refs)
    V_s, V_ss = _terminal_expansion(
        ss[:, -1], p, omap, blobs, None if refs is None else refs[:, -1])
    if cfg.horizon_parallel:
        # the scan elements need SPD stage quadratics up front; the
        # gated DDP contraction is sequential-path only
        ks, Ks, dV1, dV2, pg = backward_pass_parallel(
            A, Bm, l_s, l_u, l_ss, l_uu, l_us, V_s, V_ss, us, pr.lb, pr.ub,
            mu, inv_scale=pr.inv_scl, scan=pr.scan)
    elif pr.use_ddp:
        H = step_hessians(ss, us, pr.coeffs, pr.dt, pr.sign, mdl, p)
        g = (st.gnorm < pr.gate).to(dtype)
        if blobs is not None:
            corr = blob_concave_bl(*_blob_lanes(blobs, 1), ss[:, :-1, 0],
                                   ss[:, :-1, 1]) * g[:, None]
            l_ss[..., 0, 0] -= corr
            l_ss[..., 1, 1] -= corr
            corrT = blob_concave_bl(*_blob_lanes(blobs), ss[:, -1, 0],
                                    ss[:, -1, 1]) * g
            V_ss[:, 0, 0] -= corrT
            V_ss[:, 1, 1] -= corrT
        ks, Ks, dV1, dV2, pg = backward_pass(
            A, Bm, l_s, l_u, l_ss, l_uu, l_us, V_s, V_ss, us, pr.lb, pr.ub,
            mu, H=H, ddp_gate_val=g, inv_scale=pr.inv_scl)
    else:
        ks, Ks, dV1, dV2, pg = backward_pass(
            A, Bm, l_s, l_u, l_ss, l_uu, l_us, V_s, V_ss, us, pr.lb, pr.ub,
            mu, inv_scale=pr.inv_scl)
    tol_cost, cost_guard = pr.tol_cost, pr.cost_guard
    mu_min, mu_max, mu_factor = pr.mu_min, pr.mu_max, pr.mu_factor
    # a tiny predicted decrease -(dV1 + dV2) marks a numerical optimum
    pred_decrease = -(dV1 + dV2)
    tiny_model = pred_decrease <= tol_cost * (cost_guard + torch.abs(cost))

    # the parallel-in-alpha line search: the first (largest) alpha with
    # a cost decrease wins
    ss_all, us_all, costs_all = forward_pass_multi_alpha(
        ss, us, ks, Ks, pr.alphas, pr.z0, pr.coeffs, p, pr.dt, pr.lb, pr.ub,
        pr.sign, mdl, omap, blobs, refs)
    improved = costs_all < cost[:, None]
    accepted = torch.any(improved, dim=1)
    pick = torch.argmin(torch.where(improved, pr.rank, pr.n_ls + 1), dim=1)
    ss_n = ss_all[pr.ar, pick]
    us_n = us_all[pr.ar, pick]
    cost_n = costs_all[pr.ar, pick]

    ss2 = torch.where(accepted[:, None, None], ss_n, ss)
    us2 = torch.where(accepted[:, None, None], us_n, us)
    cost2 = torch.where(accepted, cost_n, cost)
    mu2 = torch.where(accepted, torch.maximum(mu / mu_factor, mu_min),
                      torch.minimum(mu * mu_factor, mu_max))

    # convergence is gradient-driven; the cost-based stop fires after
    # two consecutive negligible decreases
    small_step = accepted & (torch.abs(cost - cost2)
                             <= tol_cost * (cost_guard + torch.abs(cost)))
    n_small2 = torch.where(small_step, st.n_small + 1,
                           torch.zeros_like(st.n_small))
    # a tiny predicted decrease certifies an optimum only with the trust
    # region open; under inflated mu it is a stall, and only if the
    # step was also rejected
    mu_open = mu <= mu_min * mu_factor
    converged = (pg < pr.tol_grad) | (n_small2 >= 2) | (tiny_model & mu_open)
    stalled = ((~accepted & (mu2 >= mu_max))
               | (tiny_model & ~mu_open & ~accepted))
    # lanes that are done keep their state, as vmap's while_loop does
    return State(
        ss=torch.where(run[:, None, None], ss2, ss),
        us=torch.where(run[:, None, None], us2, us),
        cost=torch.where(run, cost2, cost),
        mu=torch.where(run, mu2, mu),
        it=st.it + run.to(torch.int32),
        gnorm=torch.where(run, pg, st.gnorm),
        n_small=torch.where(run, n_small2, st.n_small),
        conv=torch.where(run, converged, st.conv),
        done=torch.where(run, converged | stalled, st.done))


def result(prob: Problem, st: State) -> SolveResult:
    """The loop's carry as a SolveResult (unbatched for one scenario)."""
    res = SolveResult(us=st.us, zs=st.ss[..., :dd.STATE_DIM], cost=st.cost,
                      converged=st.conv, n_iters=st.it, grad_norm=st.gnorm,
                      reg=st.mu)
    if prob.single:
        res = SolveResult(**{f.name: getattr(res, f.name)[0]
                             for f in dataclasses.fields(res)})
    return res


def solve(z0: torch.Tensor, coeffs: torch.Tensor, p: MPCParams,
          cfg: SolverConfig, u_init: Optional[torch.Tensor] = None,
          omap=None, blobs=None,
          refs: Optional[torch.Tensor] = None, *,
          _scan=None) -> SolveResult:
    """Solve NMPC problems: z0 (B, 6), coeffs (B, P), or one problem, z0
    (6,), coeffs (P,), whose result is then unbatched. The computation
    runs on z0's device in z0's dtype.

    `p`'s leaves are shared (floats or 0-d tensors) or per scenario ((B,)).
    `u_init` (B, T, 2) warm-starts (clipped to the bounds); None is the
    cold start, the plant rolled under zero controls. `blobs`
    (`GaussianObstacles`, leaves (B, K)) adds Gaussian obstacles; `refs`
    (B, N, 3) per-knot (ref_cte, ref_etheta, ref_vel) setpoint profiles;
    `omap` (an `ObstacleMap`: one map for every lane, or one per lane
    with leaves (B, ...)) a grid-costmap penalty. They compose. `_scan`
    is internal: `parallel.sharded` passes the time-sharded reverse scan
    of the horizon-parallel backward."""
    global host_reads
    prob, st = prepare(z0, coeffs, p, cfg, u_init, omap, blobs, refs, _scan)
    for _ in range(cfg.max_sqp_iters):
        # the loop's condition per lane is it < max_iters and not done;
        # every lane still running has run every iteration so far, so the
        # cap is read on the host and "all done" once per iteration
        host_reads += 1
        with span("sync.ilqr"):
            done = bool(st.done.all())
        if done:
            break
        st = iterate(prob, st)
    return result(prob, st)


def solve_jit(z0: torch.Tensor, coeffs: torch.Tensor, p: MPCParams,
              cfg: SolverConfig, u_init: Optional[torch.Tensor] = None,
              omap=None, blobs=None,
              refs: Optional[torch.Tensor] = None) -> SolveResult:
    """The JAX package's jitted single-scenario entry point: `solve`
    captured as CUDA graphs on the card, one capture per signature (the
    config, which optional inputs are present, dtype, device and shapes),
    as jit traces once per signature (`solver/graphed.py`); on the CPU the
    same bodies run eagerly. The result equals `solve`'s bit for bit."""
    from . import graphed

    return graphed.solve_jit(z0, coeffs, p, cfg, u_init=u_init, omap=omap,
                             blobs=blobs, refs=refs)
