"""Plain reference of the tracking NLP and of its control-limited SQP solve.

The problem is the reference planner's (OkDoky/mpc_ros, `FG_eval`): a
differential drive with state (x, y, theta, v, cte, etheta) in the robot
frame, controls (omega, accel) held in a box, a cubic reference path
f(x), and the cost

    sum_t  w_cte (cte_t - ref_cte)^2 + w_etheta (eth_t - ref_etheta)^2
         + w_vel (v_t - ref_vel)^2 + w_angvel omega_t^2 + w_accel a_t^2
         + [t >= 1] (w_angvel_d (omega_t - omega_{t-1})^2
                     + w_accel_d (a_t - a_{t-1})^2)
    + the three state terms at the last knot,

over N knots and T = N - 1 controls, with

    x' = x + v cos(theta) dt        y' = y + v sin(theta) dt
    theta' = theta + omega dt       v' = v + a dt
    cte' = f(x) - y + sign v sin(eth) dt       eth' = eth + omega dt.

The solver is the algorithm the configuration names, written densely and
batch-first: the state is augmented with the previous control (8 rows),
each iteration runs a Riccati backward pass (Gauss-Newton, plus the
dynamics' second-order terms contracted with the value gradient on lanes
whose last projected gradient is under the DDP gate), a 2-D box QP per
stage solved by its active sets (the KKT point of least violation), a line search over alpha = 0.5^j that takes the largest alpha that
lowers the cost, and the per-lane regularization and stopping rules
(projected gradient under tol_grad, two negligible accepted steps, or a
negligible predicted decrease with the trust region open; a stall when
the regularization saturates). Lanes are independent. Trigonometry is
exact, and everything is computed in the dtype of the inputs.

Nothing here imports the program: it is the yardstick the program's
answers are held against.
"""

from __future__ import annotations

import dataclasses
import math

import torch

NX = 8   # augmented state: x, y, theta, v, cte, etheta, omega_prev, a_prev
NU = 2


@dataclasses.dataclass(frozen=True)
class Knobs:
    """The solve's constants, as the configuration file states them."""

    n_steps: int
    max_iters: int
    n_ls: int
    tol_grad: float
    tol_cost: float      # effective: max(tol_cost, 10 eps(config dtype))
    mu_min: float
    mu_max: float
    mu_factor: float
    ddp: bool
    ddp_gate: float
    scale_adaptive: bool
    sign: float

    @property
    def T(self) -> int:
        return self.n_steps - 1

    @staticmethod
    def from_config(cfg: dict, n_steps: int | None = None) -> "Knobs":
        s = cfg["solver"]
        eps = torch.finfo(getattr(torch, cfg["dtype"])).eps
        return Knobs(
            n_steps=int(n_steps or s["n_steps"]),
            max_iters=int(s["max_sqp_iters"]), n_ls=int(s["ls_iters"]),
            tol_grad=float(s["tol_grad"]),
            tol_cost=max(float(s["tol_cost"]), 10.0 * eps),
            mu_min=float(s["mu_init"]), mu_max=float(s["mu_max"]),
            mu_factor=float(s["mu_factor"]), ddp=bool(s["ddp"]),
            ddp_gate=float(s["ddp_gate"]),
            scale_adaptive=bool(s["scale_adaptive"]),
            sign=float(s["cte_vsin_sign"]))


def stated_params(cfg: dict) -> dict:
    """The configuration's numeric parameters as the numbers its dtype
    holds (0.1 in float32 is 0.100000001490116...), as Python floats."""
    dt = getattr(torch, cfg["dtype"])
    return {k: float(torch.tensor(v, dtype=dt)) for k, v in
            cfg["params"].items()}


WEIGHTS = ("w_cte", "w_etheta", "w_vel", "w_angvel", "w_accel",
           "w_angvel_d", "w_accel_d")


class Params:
    """The numeric parameters as tensors of one dtype and device; each is
    a 0-d tensor or one value per lane (B,)."""

    def __init__(self, params: dict, dtype, device, B: int):
        def t(v):
            a = torch.as_tensor(v, dtype=dtype, device=device)
            return a.expand(B) if a.dim() == 0 else a
        for k, v in params.items():
            setattr(self, k, t(v))
        wsum = sum(getattr(self, w) for w in WEIGHTS)
        self.wscl = torch.clamp(wsum / 470.0, min=1.0)


def poly(c, x):
    """f(x) = sum_i c[..., i] x^i."""
    P = c.shape[-1]
    acc = c[..., P - 1]
    for i in range(P - 2, -1, -1):
        acc = c[..., i] + x * acc
    return acc


def dpoly(c, x):
    P = c.shape[-1]
    acc = torch.zeros_like(x)
    for i in range(P - 1, 0, -1):
        acc = i * c[..., i] + x * acc
    return acc


def ddpoly(c, x):
    P = c.shape[-1]
    acc = torch.zeros_like(x)
    for i in range(P - 1, 1, -1):
        acc = i * (i - 1) * c[..., i] + x * acc
    return acc


def step(s, u, c, pr: Params, sign: float):
    """The augmented plant: s (..., 8), u (..., 2) -> (..., 8)."""
    dt = pr.dt
    x, y, th, v, eth = s[..., 0], s[..., 1], s[..., 2], s[..., 3], s[..., 5]
    w, a = u[..., 0], u[..., 1]
    return torch.stack([
        x + v * torch.cos(th) * dt, y + v * torch.sin(th) * dt,
        th + w * dt, v + a * dt,
        poly(c, x) - y + sign * v * torch.sin(eth) * dt,
        eth + w * dt, w, a], dim=-1)


def stage_cost(s, u, pr: Params, rate: float):
    c = (pr.w_cte * (s[..., 4] - pr.ref_cte) ** 2
         + pr.w_etheta * (s[..., 5] - pr.ref_etheta) ** 2
         + pr.w_vel * (s[..., 3] - pr.ref_vel) ** 2
         + pr.w_angvel * u[..., 0] ** 2 + pr.w_accel * u[..., 1] ** 2)
    if rate:
        c = c + (pr.w_angvel_d * (u[..., 0] - s[..., 6]) ** 2
                 + pr.w_accel_d * (u[..., 1] - s[..., 7]) ** 2)
    return c


def terminal_cost(s, pr: Params):
    return (pr.w_cte * (s[..., 4] - pr.ref_cte) ** 2
            + pr.w_etheta * (s[..., 5] - pr.ref_etheta) ** 2
            + pr.w_vel * (s[..., 3] - pr.ref_vel) ** 2)


def augment(z0):
    return torch.cat([z0, torch.zeros_like(z0[..., :2])], dim=-1)


def rollout(z0, us, c, pr: Params, sign: float):
    """States (B, T+1, 8) and cost (B,) of controls us (B, T, 2) from the
    6-row start z0 (B, 6)."""
    s = augment(z0)
    ss = [s]
    cost = torch.zeros_like(z0[:, 0])
    for t in range(us.shape[1]):
        cost = cost + stage_cost(s, us[:, t], pr, 1.0 if t else 0.0)
        s = step(s, us[:, t], c, pr, sign)
        ss.append(s)
    return torch.stack(ss, dim=1), cost + terminal_cost(s, pr)


def jacobians(s, u, c, pr: Params, sign: float):
    """A = df/ds (B, 8, 8) and Bm = df/du (B, 8, 2) of `step`."""
    dt = pr.dt
    B = s.shape[0]
    th, v, eth = s[:, 2], s[:, 3], s[:, 5]
    ct, st = torch.cos(th), torch.sin(th)
    A = s.new_zeros(B, NX, NX)
    A[:, 0, 0] = 1.0
    A[:, 0, 2] = -v * st * dt
    A[:, 0, 3] = ct * dt
    A[:, 1, 1] = 1.0
    A[:, 1, 2] = v * ct * dt
    A[:, 1, 3] = st * dt
    A[:, 2, 2] = 1.0
    A[:, 3, 3] = 1.0
    A[:, 4, 0] = dpoly(c, s[:, 0])
    A[:, 4, 1] = -1.0
    A[:, 4, 3] = sign * torch.sin(eth) * dt
    A[:, 4, 5] = sign * v * torch.cos(eth) * dt
    A[:, 5, 5] = 1.0
    Bm = s.new_zeros(B, NX, NU)
    Bm[:, 2, 0] = dt
    Bm[:, 3, 1] = dt
    Bm[:, 5, 0] = dt
    Bm[:, 6, 0] = 1.0
    Bm[:, 7, 1] = 1.0
    return A, Bm


def dynamics_curvature(s, c, Vs, pr: Params, sign: float):
    """sum_i Vs_i d^2 f_i / ds^2 (B, 8, 8): the dynamics' second-order
    term of the DDP backward (the diff drive is linear in u)."""
    dt = pr.dt
    th, v, eth = s[:, 2], s[:, 3], s[:, 5]
    ct, st = torch.cos(th), torch.sin(th)
    ce, se = torch.cos(eth), torch.sin(eth)
    H = s.new_zeros(s.shape[0], NX, NX)
    H[:, 0, 0] = Vs[:, 4] * ddpoly(c, s[:, 0])
    H[:, 2, 2] = -v * dt * (Vs[:, 0] * ct + Vs[:, 1] * st)
    h23 = dt * (Vs[:, 1] * ct - Vs[:, 0] * st)
    H[:, 2, 3] = h23
    H[:, 3, 2] = h23
    h35 = sign * dt * ce * Vs[:, 4]
    H[:, 3, 5] = h35
    H[:, 5, 3] = h35
    H[:, 5, 5] = -sign * dt * v * se * Vs[:, 4]
    return H


def box_qp(H, q, lo, hi, Hus):
    """min 0.5 d'Hd + q'd over lo <= d <= hi for a 2x2 H per lane, by its
    nine active sets (each coordinate free, at its lower or at its upper
    bound; the free ones minimize with the others fixed): the set whose
    point violates the KKT conditions least (a free coordinate outside its
    bounds, a bound's multiplier of the wrong sign), the first of the sets
    in order (coordinate 0 slowest; free, lower, upper) where several tie,
    each clamped coordinate counting 1e-12 against its set so that a tie
    prefers fewer clamps. Where H is positive definite this is the
    minimum; where the DDP term leaves it indefinite it is the KKT point
    the rule names. Returns d (B, 2) and the feedback gain K (B, 2, 8) of
    the chosen set: -H_FF^-1 Hus_F on the free rows, zero on the clamped
    ones."""
    a, b, d_ = H[:, 0, 0], H[:, 0, 1], H[:, 1, 1]
    det = a * d_ - b * b
    zero = torch.zeros_like(a)

    def pos(x):
        return torch.maximum(x, zero)

    best_viol = best_d = best_K = None
    for m0 in ("free", "lo", "hi"):
        for m1 in ("free", "lo", "hi"):
            K = torch.zeros_like(Hus)
            if m0 == "free" and m1 == "free":
                d0 = -(d_ * q[:, 0] - b * q[:, 1]) / det
                d1 = -(a * q[:, 1] - b * q[:, 0]) / det
                inv = torch.stack([torch.stack([d_, -b], -1),
                                   torch.stack([-b, a], -1)], -2) / det[
                                       :, None, None]
                K = -inv @ Hus
            elif m0 == "free":
                d1 = lo[:, 1] if m1 == "lo" else hi[:, 1]
                d0 = -(q[:, 0] + b * d1) / a
                K[:, 0] = -Hus[:, 0] / a[:, None]
            elif m1 == "free":
                d0 = lo[:, 0] if m0 == "lo" else hi[:, 0]
                d1 = -(q[:, 1] + b * d0) / d_
                K[:, 1] = -Hus[:, 1] / d_[:, None]
            else:
                d0 = lo[:, 0] if m0 == "lo" else hi[:, 0]
                d1 = lo[:, 1] if m1 == "lo" else hi[:, 1]
            lam0 = q[:, 0] + a * d0 + b * d1
            lam1 = q[:, 1] + b * d0 + d_ * d1
            viol = zero
            for m, di, lam, i in ((m0, d0, lam0, 0), (m1, d1, lam1, 1)):
                if m == "free":
                    viol = viol + pos(lo[:, i] - di) + pos(di - hi[:, i])
                elif m == "lo":
                    viol = viol + pos(-lam)
                else:
                    viol = viol + pos(lam)
            viol = viol + 1e-12 * ((m0 != "free") + (m1 != "free"))
            dd = torch.stack([d0, d1], -1)
            if best_viol is None:
                best_viol, best_d, best_K = viol, dd, K
            else:
                take = viol < best_viol
                best_viol = torch.where(take, viol, best_viol)
                best_d = torch.where(take[:, None], dd, best_d)
                best_K = torch.where(take[:, None, None], K, best_K)
    return best_d, best_K


@dataclasses.dataclass
class Solution:
    us: torch.Tensor      # (B, T, 2)
    zs: torch.Tensor      # (B, T+1, 6)
    cost: torch.Tensor    # (B,)
    converged: torch.Tensor  # (B,) bool
    iters: torch.Tensor   # (B,) int


def _mT(M):
    return M.transpose(-1, -2)


def backward(ss, us, c, pr: Params, kn: Knobs, lb, ub, mu, gate):
    """One Riccati pass along the trajectory (ss, us): the step k and gain
    K per stage, the predicted decrease's two terms and the projected
    gradient's largest entry (on the weight-scale-normalized Q_u)."""
    B, T = us.shape[0], us.shape[1]
    sT = ss[:, T]
    z = torch.zeros_like(sT[:, 0])
    Vs = torch.stack([z, z, z, 2 * pr.w_vel * (sT[:, 3] - pr.ref_vel),
                      2 * pr.w_cte * (sT[:, 4] - pr.ref_cte),
                      2 * pr.w_etheta * (sT[:, 5] - pr.ref_etheta), z, z], -1)
    Vss = torch.diag_embed(torch.stack(
        [z, z, z, 2 * pr.w_vel + z, 2 * pr.w_cte + z, 2 * pr.w_etheta + z,
         z, z], -1))
    eye2 = torch.eye(NU, dtype=ss.dtype, device=ss.device)
    ks = [None] * T
    Ks = [None] * T
    dv1 = torch.zeros_like(z)
    dv2 = torch.zeros_like(z)
    pg = torch.zeros_like(z)
    for t in range(T - 1, -1, -1):
        s, u = ss[:, t], us[:, t]
        r = 1.0 if t else 0.0
        wd0, wd1 = 2 * r * pr.w_angvel_d, 2 * r * pr.w_accel_d
        du0, du1 = u[:, 0] - s[:, 6], u[:, 1] - s[:, 7]
        ls = torch.stack([z, z, z, 2 * pr.w_vel * (s[:, 3] - pr.ref_vel),
                          2 * pr.w_cte * (s[:, 4] - pr.ref_cte),
                          2 * pr.w_etheta * (s[:, 5] - pr.ref_etheta),
                          -wd0 * du0, -wd1 * du1], -1)
        lu = torch.stack([2 * pr.w_angvel * u[:, 0] + wd0 * du0,
                          2 * pr.w_accel * u[:, 1] + wd1 * du1], -1)
        lss = torch.diag_embed(torch.stack(
            [z, z, z, 2 * pr.w_vel + z, 2 * pr.w_cte + z,
             2 * pr.w_etheta + z, wd0 + z, wd1 + z], -1))
        luu = torch.diag_embed(torch.stack(
            [2 * pr.w_angvel + wd0, 2 * pr.w_accel + wd1], -1))
        lus = s.new_zeros(B, NU, NX)
        lus[:, 0, 6] = -wd0
        lus[:, 1, 7] = -wd1
        A, Bm = jacobians(s, u, c, pr, kn.sign)
        Qs = ls + (_mT(A) @ Vs[..., None])[..., 0]
        Qu = lu + (_mT(Bm) @ Vs[..., None])[..., 0]
        Qss = lss + _mT(A) @ Vss @ A
        if gate is not None:
            Qss = Qss + gate[:, None, None] * dynamics_curvature(
                s, c, Vs, pr, kn.sign)
        Quu = luu + _mT(Bm) @ Vss @ Bm
        Quu = 0.5 * (Quu + _mT(Quu))
        Qus = lus + _mT(Bm) @ Vss @ A
        k, K = box_qp(Quu + mu[:, None, None] * eye2, Qu, lb - u, ub - u, Qus)
        Quk = (Quu @ k[..., None])[..., 0]
        Vs = (Qs + (_mT(K) @ (Quk + Qu)[..., None])[..., 0]
              + (_mT(Qus) @ k[..., None])[..., 0])
        Vss = Qss + _mT(K) @ Quu @ K + _mT(K) @ Qus + _mT(Qus) @ K
        Vss = 0.5 * (Vss + _mT(Vss))
        ks[t], Ks[t] = k, K
        dv1 = dv1 + (k * Qu).sum(-1)
        dv2 = dv2 + 0.5 * (k * Quk).sum(-1)
        g = Qu / pr.wscl[:, None]
        pg = torch.maximum(pg, (u - torch.minimum(torch.maximum(
            u - g, lb), ub)).abs().max(-1).values)
    return torch.stack(ks, 1), torch.stack(Ks, 1), dv1, dv2, pg


def line_search(z0, ss, us, ks, Ks, c, pr: Params, kn: Knobs, lb, ub):
    """Rollouts of u = clip(u_bar + alpha k + K (s - s_bar)) for the n_ls
    step sizes alpha = 0.5^j: states (n_ls, B, T+1, 8), controls
    (n_ls, B, T, 2) and costs (n_ls, B)."""
    alphas = 0.5 ** torch.arange(kn.n_ls, dtype=ss.dtype, device=ss.device)
    s = augment(z0).expand(kn.n_ls, *z0.shape[:1], NX)
    cf = c.expand(kn.n_ls, *c.shape)
    cost = torch.zeros_like(s[..., 0])
    S, U = [s], []
    for t in range(us.shape[1]):
        u = (us[:, t] + alphas[:, None, None] * ks[:, t]
             + (Ks[:, t] @ (s - ss[:, t])[..., None])[..., 0])
        u = torch.minimum(torch.maximum(u, lb), ub)
        cost = cost + stage_cost(s, u, pr, 1.0 if t else 0.0)
        s = step(s, u, cf, pr, kn.sign)
        S.append(s)
        U.append(u)
    return (torch.stack(S, 2), torch.stack(U, 2),
            cost + terminal_cost(s, pr))


def solve(z0, c, params: dict, kn: Knobs, u_init=None) -> Solution:
    """The SQP solve of every lane: z0 (B, 6), c (B, P) in one dtype and
    device; `params` the configuration's numeric parameters; `u_init`
    (B, T, 2) a warm start (zeros when None), clipped to the bounds."""
    B, T = z0.shape[0], kn.T
    pr = Params(params, z0.dtype, z0.device, B)
    lb = torch.stack([-pr.max_angvel, -pr.max_throttle], -1)   # (B, 2)
    ub = -lb
    us = (torch.zeros(B, T, NU, dtype=z0.dtype, device=z0.device)
          if u_init is None else u_init.to(z0))
    us = torch.minimum(torch.maximum(us, lb[:, None]), ub[:, None])
    if not kn.scale_adaptive:
        pr.wscl = torch.ones_like(pr.wscl)
    ss, cost = rollout(z0, us, c, pr, kn.sign)
    mu_lo, mu_hi = kn.mu_min * pr.wscl, kn.mu_max * pr.wscl
    mu = mu_lo.clone()
    done = torch.zeros(B, dtype=torch.bool, device=z0.device)
    conv = torch.zeros_like(done)
    gnorm = torch.full_like(cost, math.inf)
    n_small = torch.zeros(B, dtype=torch.int64, device=z0.device)
    iters = torch.zeros_like(n_small)
    for _ in range(kn.max_iters):
        run = ~done
        if not bool(run.any()):
            break
        gate = (gnorm < kn.ddp_gate).to(z0.dtype) if kn.ddp else None
        ks, Ks, dv1, dv2, pg = backward(ss, us, c, pr, kn, lb, ub, mu, gate)
        tiny = -(dv1 + dv2) <= kn.tol_cost * (pr.wscl + cost.abs())
        S, U, costs = line_search(z0, ss, us, ks, Ks, c, pr, kn, lb, ub)
        improved = costs < cost[None]
        accepted = improved.any(0)
        first = torch.argmax(improved.to(torch.int8), dim=0)   # first True
        lane = torch.arange(B, device=z0.device)
        ss_n, us_n, cost_n = S[first, lane], U[first, lane], costs[first, lane]
        acc = accepted & run
        ss = torch.where(acc[:, None, None], ss_n, ss)
        us = torch.where(acc[:, None, None], us_n, us)
        cost2 = torch.where(acc, cost_n, cost)
        mu2 = torch.where(acc, torch.maximum(mu / kn.mu_factor, mu_lo),
                          torch.minimum(mu * kn.mu_factor, mu_hi))
        small = accepted & ((cost - cost2).abs()
                            <= kn.tol_cost * (pr.wscl + cost.abs()))
        n_small2 = torch.where(small, n_small + 1, torch.zeros_like(n_small))
        mu_open = mu <= mu_lo * kn.mu_factor
        converged = (pg < kn.tol_grad) | (n_small2 >= 2) | (tiny & mu_open)
        stalled = ((~accepted & (mu2 >= mu_hi))
                   | (tiny & ~mu_open & ~accepted))
        cost = cost2
        mu = torch.where(run, mu2, mu)
        n_small = torch.where(run, n_small2, n_small)
        conv = torch.where(run, converged, conv)
        gnorm = torch.where(run, pg, gnorm)
        done = torch.where(run, converged | stalled, done)
        iters = iters + run.to(iters.dtype)
    return Solution(us=us, zs=ss[..., :6], cost=cost, converged=conv,
                    iters=iters)


def evaluate(z0, us, c, params: dict, kn: Knobs):
    """The cost of given controls (B, T, 2) from z0 (B, 6): the plain
    rollout, without clipping."""
    pr = Params(params, z0.dtype, z0.device, z0.shape[0])
    return rollout(z0, us, c, pr, kn.sign)[1]


@dataclasses.dataclass
class Trace:
    zs: torch.Tensor      # (n_cycles, B, 6) plant state at each cycle
    us: torch.Tensor      # (n_cycles, B, 2) control applied at each cycle
    iters: torch.Tensor   # (n_cycles, B) SQP iterations of each solve


def receding(z0, c, params: dict, kn: Knobs, n_cycles: int) -> Trace:
    """Closed-loop serving of B robots: each cycle solves from the plant's
    state, warm-started from the last solution shifted by one knot (its
    last control repeated; zeros at the first cycle), applies the first
    control, and steps the plant once."""
    pr = Params(params, z0.dtype, z0.device, z0.shape[0])
    z, warm = z0, None
    zs, us, its = [], [], []
    for _ in range(n_cycles):
        sol = solve(z, c, params, kn, u_init=warm)
        u0 = sol.us[:, 0]
        zs.append(z)
        us.append(u0)
        its.append(sol.iters)
        z = step(augment(z), u0, c, pr, kn.sign)[:, :6]
        warm = torch.cat([sol.us[:, 1:], sol.us[:, -1:]], dim=1)
    return Trace(zs=torch.stack(zs), us=torch.stack(us),
                 iters=torch.stack(its))
