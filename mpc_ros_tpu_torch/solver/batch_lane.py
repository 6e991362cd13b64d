"""Lane-major batched solver — the port's throughput path.

Counterpart of `mpc_ros_tpu/solver/batch_lane.py`. The public function
keeps the JAX package's batch-major layout (z0s (B, 6), coeffs (B, P),
u_init (B, T, 2), a batch-major SolveResult); inside, every array is
batch-last ((T, 8, 8, B) and so on), so the kernels read coalesced rows.

Three routes, chosen by the JAX package's dispatch rule. `kernels_ok` is
float32, B % 128 == 0, a lane-specialized family ("diff_drive" or
"bicycle") and no grid obstacle maps (`omaps`: grid sampling was never a
kernel in the JAX package, so grid maps take the XLA lane path whatever
`backward` says; the production costmap route fits blobs instead):

* the whole-solve kernel (`kernels/solve_mega.py`, K1) for
  `backward="mega"`, or `"auto"` on CUDA tensors (the counterpart of
  running on the TPU); it takes blobs, per-knot setpoints (`refs`) and
  both families;
* the legacy two-kernel route for `backward="pallas"`: the SQP loop below
  with the fused backward kernel (`kernels/backward_fused.py`, K4) and the
  fused line-search kernel (`kernels/forward.py`, K5), Gauss-Newton,
  diff-drive and no blobs only — with blobs or the bicycle, "pallas" runs
  the XLA lane path;
* the XLA lane path for everything else — `"xla"`, `"auto"` on CPU
  tensors, f64, B % 128 != 0, grid maps — the same loop with the plain
  PyTorch stages `_backward_bl` and `_forward_multi_alpha_bl`, grid and
  blob terms and the bicycle rows included.

CPU tensors run each kernel's plain version, CUDA tensors launch the
kernel. Per-knot setpoints (`refs`) off the kernel route run on the
registry-generic engine (`engine.batch_solve`, the single-scenario
solver batched), as the JAX package does; with grid maps they raise its
ValueError.

Spans (`obs.span`): on the kernel route the lane packing is
`dispatch.lane_inputs` and the batch-major result `dispatch.result`; the
XLA lane path's loop condition, read on the host, is `sync.batch_lane`.
"""

from __future__ import annotations

import dataclasses
import itertools

import torch

from ..config import SolverConfig
from ..kernels import backward_fused as _bf
from ..kernels import forward as _fw
from ..kernels import tiles
from ..kernels.pack import pack_params
from ..kernels.solve_mega import solve_mega_scheduled
from ..models.base import get_model
from ..models.costs import scaled_solver_knobs
from ..models.obstacles import (blob_concave_bl, blob_terms_bl,
                                obstacle_cost_grad_bl, obstacle_curv_bl)
from ..obs.timers import span
from .types import SolveResult

# active-set enumeration order of the XLA box QP
_COMBOS = list(itertools.product(range(3), repeat=2))
_NC = len(_COMBOS)


def _pl(p, name, dtype, device):
    return torch.as_tensor(getattr(p, name), dtype=dtype, device=device)


# ---------------------------------------------------------------- dynamics


def _step_bl(s, u, coeffs, dt, sign, model="diff_drive", p=None):
    """Augmented step, batch-last. s (..., 8, B), u (..., 2, B), coeffs
    (P, B); leading dims broadcast (the alpha axis). "diff_drive" advances
    theta by omega dt, "bicycle" by v delta dt / lf (lf a scalar or per-lane
    MPCParams leaf)."""
    x, y, th, v, cte, eth = (s[..., i, :] for i in range(6))
    w = u[..., 0, :]
    a = u[..., 1, :]
    f0 = tiles.polyval(coeffs, x)
    if model == "bicycle":
        inc = v * w * (dt / torch.as_tensor(p.lf, dtype=x.dtype,
                                            device=x.device))
    else:
        inc = w * dt
    rows = [
        x + v * torch.cos(th) * dt,
        y + v * torch.sin(th) * dt,
        th + inc,
        v + a * dt,
        (f0 - y) + sign * v * torch.sin(eth) * dt,
        eth + inc,
        w,
        a,
    ]
    return torch.stack(rows, dim=-2)


def _state_cost_bl(s, p, dtype):
    """Tracking cost per lane from augmented states (..., 8, B) -> (..., B)."""
    dev = s.device
    v = s[..., 3, :]
    cte = s[..., 4, :]
    eth = s[..., 5, :]
    return (_pl(p, "w_cte", dtype, dev) * (cte - _pl(p, "ref_cte", dtype,
                                                      dev)) ** 2
            + _pl(p, "w_etheta", dtype, dev)
            * (eth - _pl(p, "ref_etheta", dtype, dev)) ** 2
            + _pl(p, "w_vel", dtype, dev) * (v - _pl(p, "ref_vel", dtype,
                                                      dev)) ** 2)


def _ctrl_cost_bl(u, pu, rate_on, p, dtype):
    """Control + rate cost: u, pu (..., 2, B); rate_on a scalar mask."""
    dev = u.device
    w = u[..., 0, :]
    a = u[..., 1, :]
    dw = w - pu[..., 0, :]
    da = a - pu[..., 1, :]
    return (_pl(p, "w_angvel", dtype, dev) * w ** 2
            + _pl(p, "w_accel", dtype, dev) * a ** 2
            + rate_on * (_pl(p, "w_angvel_d", dtype, dev) * dw ** 2
                         + _pl(p, "w_accel_d", dtype, dev) * da ** 2))


def _rollout_and_cost(s0, us, coeffs, dt, sign, p, dtype, T,
                      model="diff_drive"):
    """Roll (8, B) through us (T, 2, B); return ss (T+1, 8, B), cost (B,).
    The JAX `lax.scan` is a loop over T."""
    s = s0
    acc = torch.zeros(s0.shape[-1], dtype=dtype, device=s0.device)
    out = [s0]
    for t in range(T):
        rate_on = 1.0 if t >= 1 else 0.0
        u = us[t]
        acc = acc + _state_cost_bl(s, p, dtype) + _ctrl_cost_bl(
            u, s[6:8], rate_on, p, dtype)
        s = _step_bl(s, u, coeffs, dt, sign, model, p)
        out.append(s)
    return torch.stack(out), acc + _state_cost_bl(s, p, dtype)


def _terminal_bl(s_T, p, dtype):
    """Terminal value expansion, batch-last: V_s (8, B), V_ss (8, 8, B)."""
    B = s_T.shape[-1]
    dev = s_T.device
    zero = torch.zeros((B,), dtype=dtype, device=dev)
    wv = _pl(p, "w_vel", dtype, dev)
    wc = _pl(p, "w_cte", dtype, dev)
    we = _pl(p, "w_etheta", dtype, dev)

    def bz(q):
        return q.expand(B)

    V_s = torch.stack([
        zero, zero, zero,
        2.0 * wv * (s_T[3] - _pl(p, "ref_vel", dtype, dev)),
        2.0 * wc * (s_T[4] - _pl(p, "ref_cte", dtype, dev)),
        2.0 * we * (s_T[5] - _pl(p, "ref_etheta", dtype, dev)),
        zero, zero,
    ], dim=-2)
    diag = [zero, zero, zero, bz(2.0 * wv), bz(2.0 * wc), bz(2.0 * we),
            zero, zero]
    V_ss = torch.stack(
        [torch.stack([diag[i] if i == j else zero for j in range(8)], dim=-2)
         for i in range(8)], dim=-3)
    return V_s, V_ss


# ----------------------------------------------------------------- box QP


def _inv2_bl(M):
    """Closed-form inverse of (..., 2, 2, B) matrices."""
    a = M[..., 0, 0, :]
    b = M[..., 0, 1, :]
    c = M[..., 1, 0, :]
    d = M[..., 1, 1, :]
    det = a * d - b * c
    row0 = torch.stack([d, -b], dim=-2)
    row1 = torch.stack([-c, a], dim=-2)
    return torch.stack([row0, row1], dim=-3) / det[..., None, None, :]


def _boxqp_bl(Q, q, lb, ub, Qus):
    """Exact 2-dim box QP by active-set enumeration, batch-last.

    Q (2,2,B), q (2,B), lb/ub (2,B), Qus (2,8,B) -> d (2,B), free (2,B),
    K (2,8,B) with zero rows for clamped dims. The winner is the first
    combo (itertools order) of least KKT violation; each clamped dim adds
    1e-12 so ties prefer fewer clamps."""
    dtype = Q.dtype
    dev = Q.device

    def table(side):
        return torch.tensor([[1.0 if s == side else 0.0 for s in c]
                             for c in _COMBOS], dtype=dtype,
                            device=dev)[:, :, None]          # (9, 2, 1)

    f, at_lo, at_hi = table(0), table(1), table(2)
    d_clamp = at_lo * lb[None] + at_hi * ub[None]              # (9, 2, B)
    ff = f[:, :, None, :] * f[:, None, :, :]                   # (9, 2, 2, 1)
    eye = torch.eye(2, dtype=dtype, device=dev)[None, :, :, None]
    # free rows keep Q on free cols; clamped rows become identity rows
    M = Q[None] * ff + (1.0 - f)[:, :, None, :] * eye
    Qd = torch.einsum("ijb,cjb->cib", Q, d_clamp)
    rhs = f * (-(q[None] + Qd)) + (1.0 - f) * d_clamp
    Minv = _inv2_bl(M)                                         # (9, 2, 2, B)
    d = torch.einsum("cijb,cjb->cib", Minv, rhs)               # (9, 2, B)
    lam = q[None] + torch.einsum("ijb,cjb->cib", Q, d)
    zero = torch.zeros((), dtype=dtype, device=dev)
    viol = torch.sum(
        f * (torch.maximum(lb[None] - d, zero)
             + torch.maximum(d - ub[None], zero))
        + at_lo * torch.maximum(-lam, zero)
        + at_hi * torch.maximum(lam, zero), dim=-2)            # (9, B)
    viol = viol + 1e-12 * torch.sum(1.0 - f, dim=-2)
    best = torch.argmin(viol, dim=0)                           # first wins
    sel = torch.nn.functional.one_hot(best, _NC).to(dtype).T   # (9, B)
    d_best = torch.einsum("cb,cib->ib", sel, d)
    f_best = torch.einsum("cb,cib->ib", sel, f.expand(d.shape))
    Minv_best = torch.einsum("cb,cijb->ijb", sel, Minv)
    K = torch.einsum("ijb,jnb->inb", Minv_best, -(f_best[:, None, :] * Qus))
    return d_best, f_best, K


# ---------------------------------------------------------------- passes


def _stage_linexp_bl(s, u, coeffs, dt, sign, rate_on, p, dtype,
                     model="diff_drive"):
    """Stage Jacobians + exact cost quadratics, batch-last.

    s (8, ...), u (2, ...) -> A (..., 8, 8), Bm (..., 8, 2), l_s (..., 8),
    l_u (..., 2), l_ss (..., 8, 8), l_uu (..., 2, 2), l_us (..., 2, 8),
    where "..." is the per-lane shape: (B,) for one stage, (T, B) for all
    stages at once (the JAX vmap over T; rate_on then (T, 1))."""
    dev = s.device
    x = s[0]
    th = s[2]
    v = s[3]
    eth = s[5]
    pu = s[6:8]
    ct, st = torch.cos(th), torch.sin(th)
    ce, se = torch.cos(eth), torch.sin(eth)
    fp = tiles.polyder(coeffs, x)
    zero = torch.zeros_like(x)
    one = torch.ones_like(x)
    dt_ = torch.as_tensor(dt, dtype=dtype, device=dev)

    def bz(q):
        return torch.as_tensor(q).expand(x.shape)

    def M(rows):
        return torch.stack([torch.stack(r, dim=-2) for r in rows], dim=-3)

    z2 = [zero, zero]
    if model == "bicycle":
        k_lf = dt_ / _pl(p, "lf", dtype, dev)     # per lane when lf is (B,)
        dth_dv = bz(u[0] * k_lf)                  # d(theta')/dv = delta dt/lf
        dth_du0 = bz(v * k_lf)                    # d(theta')/d delta
    else:
        dth_dv = zero
        dth_du0 = dt_ * one
    A = M([
        [one, zero, -v * st * dt_, ct * dt_, zero, zero] + z2,
        [zero, one, v * ct * dt_, st * dt_, zero, zero] + z2,
        [zero, zero, one, dth_dv, zero, zero] + z2,
        [zero, zero, zero, one, zero, zero] + z2,
        [fp, -one, zero, sign * se * dt_, zero, sign * v * ce * dt_] + z2,
        [zero, zero, zero, dth_dv, zero, one] + z2,
        [zero] * 8,
        [zero] * 8,
    ])
    Bm = M([
        z2, z2,
        [dth_du0, zero],
        [zero, dt_ * one],
        z2,
        [dth_du0, zero],
        [one, zero],
        [zero, one],
    ])

    wv = _pl(p, "w_vel", dtype, dev)
    wc = _pl(p, "w_cte", dtype, dev)
    we = _pl(p, "w_etheta", dtype, dev)
    ww = _pl(p, "w_angvel", dtype, dev)
    wa = _pl(p, "w_accel", dtype, dev)
    wdw = _pl(p, "w_angvel_d", dtype, dev) * rate_on
    wda = _pl(p, "w_accel_d", dtype, dev) * rate_on
    du = u - pu
    l_s = torch.stack([
        zero, zero, zero,
        2.0 * wv * (v - _pl(p, "ref_vel", dtype, dev)),
        2.0 * wc * (s[4] - _pl(p, "ref_cte", dtype, dev)),
        2.0 * we * (eth - _pl(p, "ref_etheta", dtype, dev)),
        bz(-2.0 * wdw * du[0]),
        bz(-2.0 * wda * du[1]),
    ], dim=-2)
    l_u = torch.stack([
        bz(2.0 * ww * u[0] + 2.0 * wdw * du[0]),
        bz(2.0 * wa * u[1] + 2.0 * wda * du[1]),
    ], dim=-2)
    diag_s = [zero, zero, zero, bz(2.0 * wv), bz(2.0 * wc), bz(2.0 * we),
              bz(2.0 * wdw), bz(2.0 * wda)]
    l_ss = M([[diag_s[i] if i == j else zero for j in range(8)]
              for i in range(8)])
    l_uu = M([
        [bz(2.0 * (ww + wdw)), zero],
        [zero, bz(2.0 * (wa + wda))],
    ])
    l_us = M([
        [zero] * 6 + [bz(-2.0 * wdw), zero],
        [zero] * 6 + [zero, bz(-2.0 * wda)],
    ])
    return A, Bm, l_s, l_u, l_ss, l_uu, l_us


def _backward_bl(ss, us, coeffs, dt, sign, p, V_s, V_ss, lb, ub, mu,
                 omaps=None, blobs=None, model="diff_drive", ddp=False,
                 ddp_mask=None, inv_scale=None):
    """Control-limited Riccati scan, batch-last. mu (B,). The stage
    Jacobians and quadratics are materialized for all T stages at once
    (with a batch dimension, as the JAX vmap does) and the reverse scan is
    a loop over T. `blobs`: four lane-major (K, B) tensors
    (`GaussianObstacles.lane()`), whose gradient and Gauss-Newton curvature
    join each stage's cost expansion; under gated DDP the concave -2 g v I
    part is added back on the lanes past the gate. Returns ks (T,2,B),
    Ks (T,2,8,B), dV1, dV2, pg (B,)."""
    dtype = ss.dtype
    dev = ss.device
    T = us.shape[0]
    i_scl = (torch.ones((), dtype=dtype, device=dev) if inv_scale is None
             else torch.as_tensor(inv_scale, dtype=dtype, device=dev))
    eye2 = torch.eye(2, dtype=dtype, device=dev)[:, :, None]
    rate = torch.cat([torch.zeros((1,), dtype=dtype, device=dev),
                      torch.ones((T - 1,), dtype=dtype, device=dev)])
    A, Bm, l_s, l_u, l_ss, l_uu, l_us = _stage_linexp_bl(
        ss[:-1].movedim(0, 1), us.movedim(0, 1), coeffs, dt, sign,
        rate[:, None], p, dtype, model)
    if omaps is not None:
        _, gx, gy = obstacle_cost_grad_bl(omaps, ss[:-1, 0], ss[:-1, 1])
        l_s[:, 0] += gx
        l_s[:, 1] += gy
        # the PSD second-difference curvature: without it the grid term
        # has no stiffness and hard lanes die in rejected-step spirals
        hxx, hyy = obstacle_curv_bl(omaps, ss[:-1, 0], ss[:-1, 1])
        l_ss[:, 0, 0] += hxx
        l_ss[:, 1, 1] += hyy
    if blobs is not None:
        x_t, y_t = ss[:-1, 0], ss[:-1, 1]
        _, gx, gy, hxx, hxy, hyy = blob_terms_bl(*blobs, x_t, y_t)
        if ddp and ddp_mask is not None:
            # the exact blob Hessian past the gate: GN keeps only the PSD
            # outer product, the gated DDP adds the concave -2 g v I back
            corr = blob_concave_bl(*blobs, x_t, y_t) * ddp_mask
            hxx = hxx - corr
            hyy = hyy - corr
        l_s[:, 0] += gx
        l_s[:, 1] += gy
        l_ss[:, 0, 0] += hxx
        l_ss[:, 0, 1] += hxy
        l_ss[:, 1, 0] += hxy
        l_ss[:, 1, 1] += hyy
    if ddp:
        # exact second-order dynamics data per stage: the only nonzero
        # d2f/ds2 entries are rows 0/1 (v cos/sin theta) and row 4 (f(x)
        # and v sin(etheta))
        th_t = ss[:-1, 2]
        dd_xs = torch.stack([
            ss[:-1, 3],
            torch.cos(th_t), torch.sin(th_t),
            torch.sin(ss[:-1, 5]), torch.cos(ss[:-1, 5]),
            tiles.polyder2(coeffs, ss[:-1, 0]),
        ], dim=1)                                          # (T, 6, B)
    dt_c = torch.as_tensor(dt, dtype=dtype, device=dev)
    lf_c = _pl(p, "lf", dtype, dev) if model == "bicycle" else None

    Vs, Vss = V_s, V_ss
    ks, Ks, dV1s, dV2s, pgs = ([None] * T for _ in range(5))
    for t in range(T - 1, -1, -1):
        A_t, B_t, ls, lu = A[t], Bm[t], l_s[t], l_u[t]
        lss, luu, lus, u_t = l_ss[t], l_uu[t], l_us[t], us[t]
        Qs = ls + torch.einsum("kib,kb->ib", A_t, Vs)
        Qu = lu + torch.einsum("kmb,kb->mb", B_t, Vs)
        VA = torch.einsum("kmb,mjb->kjb", Vss, A_t)
        Qss = lss + torch.einsum("kib,kjb->ijb", A_t, VA)
        Qus = lus + torch.einsum("kmb,kjb->mjb", B_t, VA)
        VB = torch.einsum("kmb,mjb->kjb", Vss, B_t)
        Quu = luu + torch.einsum("kmb,kjb->mjb", B_t, VB)
        Quu = 0.5 * (Quu + Quu.transpose(0, 1))
        if ddp:
            # per-lane hybrid gate (ddp_mask in [0, 1]): Gauss-Newton far
            # from the optimum, the exact Hessian for the endgame
            v_t, ct_t, st_t, se_t, ce_t, fpp_t = (dd_xs[t, i]
                                                   for i in range(6))
            g = 1.0 if ddp_mask is None else ddp_mask
            q22 = -v_t * dt_c * (Vs[0] * ct_t + Vs[1] * st_t) * g
            q23 = dt_c * (Vs[1] * ct_t - Vs[0] * st_t) * g
            q00 = Vs[4] * fpp_t * g
            q55 = -sign * dt_c * v_t * se_t * Vs[4] * g
            q35 = sign * dt_c * ce_t * Vs[4] * g
            Qss = Qss.clone()
            for (i, j), q in (((2, 2), q22), ((2, 3), q23), ((3, 2), q23),
                              ((0, 0), q00), ((5, 5), q55), ((3, 5), q35),
                              ((5, 3), q35)):
                Qss[i, j] = Qss[i, j] + q
            if model == "bicycle":
                # theta rows 2/5: d2(v delta dt / lf) / dv d delta
                Qus = Qus.clone()
                Qus[0, 3] = Qus[0, 3] + (Vs[2] + Vs[5]) * (dt_c / lf_c) * g
        Quu_reg = Quu + mu[None, None, :] * eye2

        k, _free, K = _boxqp_bl(Quu_reg, Qu, lb - u_t, ub - u_t, Qus)

        KtQuu = torch.einsum("mib,mkb->ikb", K, Quu)
        Vs = (Qs + torch.einsum("ikb,kb->ib", KtQuu, k)
              + torch.einsum("mib,mb->ib", K, Qu)
              + torch.einsum("mib,mb->ib", Qus, k))
        KtQus = torch.einsum("mib,mjb->ijb", K, Qus)
        Vss_n = (Qss + torch.einsum("ikb,kjb->ijb", KtQuu, K)
                 + KtQus + KtQus.transpose(0, 1))
        Vss = 0.5 * (Vss_n + Vss_n.transpose(0, 1))

        ks[t], Ks[t] = k, K
        dV1s[t] = torch.einsum("mb,mb->b", k, Qu)
        dV2s[t] = 0.5 * torch.einsum("mb,mkb,kb->b", k, Quu, k)
        # pg on the weight-scale-normalized gradient (Q_u / s is the c=1
        # problem's Q_u for uniform weight scalings)
        pgs[t] = torch.amax(
            torch.abs(u_t - torch.clamp(u_t - Qu * i_scl, lb, ub)), dim=0)
    return (torch.stack(ks), torch.stack(Ks), torch.stack(dV1s).sum(0),
            torch.stack(dV2s).sum(0), torch.stack(pgs).amax(0))


def _forward_multi_alpha_bl(ss_bar, us_bar, ks, Ks, alphas, coeffs, dt, sign,
                            lb, ub, p, dtype, model="diff_drive"):
    """All-alpha forward rollouts in one loop over T, batch-last. Carry
    (n_ls, 8, B); returns ss (T+1, n_ls, 8, B), us (T, n_ls, 2, B),
    costs (n_ls, B)."""
    n_ls = alphas.shape[0]
    B = ss_bar.shape[-1]
    T = us_bar.shape[0]
    s0 = ss_bar[0][None].expand(n_ls, 8, B)
    s_all = s0
    acc = torch.zeros((n_ls, B), dtype=dtype, device=ss_bar.device)
    ss_out, us_out = [s0], []
    for t in range(T):
        s_b, u_b, k, K = ss_bar[t], us_bar[t], ks[t], Ks[t]
        du = torch.einsum("mjb,ajb->amb", K, s_all - s_b[None])
        u_all = u_b[None] + alphas[:, None, None] * k[None] + du
        u_all = torch.clamp(u_all, lb[None], ub[None])
        rate_on = 1.0 if t >= 1 else 0.0
        acc = acc + _state_cost_bl(s_all, p, dtype) + _ctrl_cost_bl(
            u_all, s_all[:, 6:8], rate_on, p, dtype)
        s_all = _step_bl(s_all, u_all, coeffs, dt, sign, model, p)
        ss_out.append(s_all)
        us_out.append(u_all)
    costs = acc + _state_cost_bl(s_all, p, dtype)
    return torch.stack(ss_out), torch.stack(us_out), costs


# ------------------------------------------------------------------ solve


def lane_inputs(z0s: torch.Tensor, coeffs: torch.Tensor, p,
                cfg: SolverConfig, u_init=None):
    """The batch-last inputs of a solve from batch-major ones: zT (6, B),
    cT (P, B), params (12, B) (`pack_params`), lb/ub (2, B) from the
    model's control bounds, and u0 (T, 2, B) — zeros, or u_init (B, T, 2)
    clipped to the bounds."""
    dtype = z0s.dtype
    dev = z0s.device
    B = z0s.shape[0]
    T = cfg.n_controls
    zT = z0s.transpose(0, 1).contiguous()                 # (6, B)
    cT = coeffs.to(dtype).transpose(0, 1).contiguous()    # (P, B)
    blb, bub = get_model(cfg.model).control_bounds(p, dtype, dev)
    lb = (blb if blb.dim() == 2 else blb[:, None]).expand(2, B).contiguous()
    ub = (bub if bub.dim() == 2 else bub[:, None]).expand(2, B).contiguous()
    if u_init is None:
        us0 = torch.zeros((T, 2, B), dtype=dtype, device=dev)
    else:
        # u_init arrives batch-major (B, T, 2), clipped to the bounds
        u = torch.as_tensor(u_init, dtype=dtype, device=dev)
        us0 = torch.clamp(u.permute(1, 2, 0), lb[None],
                          ub[None]).contiguous()
    pp = pack_params(p, B, dtype, dev)
    return zT, cT, pp, lb, ub, us0


def two_kernel_stages(plain: bool = False):
    """(backward, forward) of the two-kernel route: the kernels'
    dispatchers (CPU tensors run the plain versions, CUDA tensors the
    kernels), or with `plain=True` the plain versions by name on any
    device — the yardstick the route is held against on the card."""
    if plain:
        return _bf.backward_fused_plain, _fw.forward_plain
    return _bf.backward_fused, _fw.forward


class LaneSQP:
    """The lane-major SQP loop of one batched solve (`batch_lane.py`'s
    `while_loop`, body and cond), as an object: construct it (initial
    rollout), `step()` while `running()`, then `result()`.

    `two_kernel` is None for the XLA lane stages, or a (backward, forward)
    pair from `two_kernel_stages` for the two-kernel route, whose knobs
    resolve with `scale_adaptive=False` (its pg is not weight-scale
    normalized); that route takes neither blobs, grid maps nor the
    bicycle. `blobs` (a `GaussianObstacles` with (B, K) leaves) and
    `omaps` (an `ObstacleMap` with leaves (B, ...)) add their penalty to
    every knot's cost, their expansion to the backward and the terminal
    value, and resolve the gate and the mu floor with obstacles. The loop
    reads its exit condition on the host once per iteration;
    `backward_inputs` / `forward_inputs` give the stage inputs of the next
    iteration."""

    def __init__(self, z0s, coeffs, p, cfg: SolverConfig, u_init=None,
                 two_kernel=None, blobs=None, omaps=None):
        dtype = z0s.dtype
        dev = z0s.device
        if two_kernel is not None and (blobs is not None or omaps is not None
                                       or cfg.model != "diff_drive"):
            raise ValueError("the two-kernel route is diff-drive only and "
                             "takes no obstacles")
        # 4x (K, B): cx, cy, gamma, w
        self.bl = (None if blobs is None else
                   tuple(a.to(dtype=dtype, device=dev) for a in blobs.lane()))
        self.omaps = (None if omaps is None
                      else omaps.for_solver(dtype, dev))
        self.cfg, self.p, self.dtype = cfg, p, dtype
        self.B = z0s.shape[0]
        self.T = T = cfg.n_controls
        self.sign = float(cfg.cte_vsin_sign)
        self.model = cfg.model
        self.two_kernel = two_kernel
        self.dt = torch.as_tensor(p.dt, dtype=dtype, device=dev)
        zT, self.cT, self.pp, self.lb, self.ub, us0 = lane_inputs(
            z0s, coeffs, p, cfg, u_init)
        s0 = torch.cat([zT, torch.zeros((2, self.B), dtype=dtype,
                                        device=dev)])
        self.use_ddp = cfg.ddp_for(dtype)
        self.n_ls = cfg.ls_for(dtype)
        # with obstacles the auto gate is capped at 0.75 and the mu floor
        # resolves without the long-horizon pair
        has_blobs = self.bl is not None
        has_omaps = self.omaps is not None
        has_obs = has_blobs or has_omaps
        self.gate = cfg.gate_for(has_blobs, dtype, has_omaps=has_omaps)

        def t(x):
            return torch.as_tensor(x, dtype=dtype, device=dev)

        self.tol_grad = t(cfg.tol_grad_for(dtype))
        self.tol_cost = t(max(cfg.tol_cost,
                              10.0 * float(torch.finfo(dtype).eps)))
        knob_cfg = (cfg if two_kernel is None
                    else dataclasses.replace(cfg, scale_adaptive=False))
        (self.mu_min, self.mu_max, self.inv_scl,
         self.cost_guard) = scaled_solver_knobs(knob_cfg, p, dtype, dev,
                                                has_obstacles=has_blobs,
                                                has_omaps=has_omaps)
        self.mu_factor = t(cfg.mu_factor)
        self.alphas = t(0.5) ** torch.arange(self.n_ls, dtype=dtype,
                                             device=dev)
        self.done_frac = t(cfg.done_frac)

        self.ss, self.cost = _rollout_and_cost(
            s0, us0, self.cT, self.dt, self.sign, p, dtype, T, self.model)
        if has_obs:
            self.cost = self.cost + self._obs_cost_knots(self.ss)
        self.us = us0
        B = self.B
        self.mu = self.mu_min.expand(B).clone()
        self.it = 0
        self.done = torch.zeros((B,), dtype=torch.bool, device=dev)
        self.gnorm = torch.full((B,), float("inf"), dtype=dtype, device=dev)
        self.n_small = torch.zeros((B,), dtype=torch.int32, device=dev)
        self.conv = torch.zeros((B,), dtype=torch.bool, device=dev)
        self.iters = torch.zeros((B,), dtype=torch.int32, device=dev)

    def _obs_cost_knots(self, ss):
        """The grid and blob penalties summed over every knot: ss
        (T+1, ..., 8, B) -> (..., B)."""
        x, y = ss[..., 0, :], ss[..., 1, :]
        tot = 0.0
        if self.omaps is not None:
            tot = tot + obstacle_cost_grad_bl(self.omaps, x, y)[0].sum(0)
        if self.bl is not None:
            tot = tot + blob_terms_bl(*self.bl, x, y)[0].sum(0)
        return tot

    def running(self) -> bool:
        """The loop condition, read on the host: iterations left, and not
        every lane done (or, with done_frac < 1, the done fraction below
        done_frac)."""
        if self.it >= self.cfg.max_sqp_iters:
            return False
        with span("sync.batch_lane"):
            if self.cfg.done_frac >= 1.0:
                return not bool(self.done.all())
            return bool(self.done.to(self.dtype).mean() < self.done_frac)

    def backward_inputs(self):
        """The backward stage's inputs of the next iteration: ss, us, cT,
        params, sign, V_s, V_ss, lb, ub, mu."""
        V_s, V_ss = _terminal_bl(self.ss[-1], self.p, self.dtype)
        return (self.ss, self.us, self.cT, self.pp, self.sign, V_s, V_ss,
                self.lb, self.ub, self.mu)

    def forward_inputs(self, ks, Ks):
        """The fused line search's inputs given the backward's gains:
        ss, us, ks, Ks, cT, params, sign, lb, ub, cost, act."""
        return (self.ss, self.us, ks, Ks, self.cT, self.pp, self.sign,
                self.lb, self.ub, self.cost,
                torch.logical_not(self.done).to(self.dtype))

    def step(self) -> None:
        """One SQP iteration (the JAX while_loop body)."""
        dtype = self.dtype
        ss, us, cost, mu = self.ss, self.us, self.cost, self.mu
        done, gnorm = self.done, self.gnorm
        if self.two_kernel is not None:
            backward, forward = self.two_kernel
            ks, Ks, dV1, dV2, pg = backward(*self.backward_inputs())
        else:
            dmask = (gnorm < self.gate).to(dtype) if self.use_ddp else None
            V_s, V_ss = _terminal_bl(ss[-1], self.p, dtype)
            if self.omaps is not None:
                xT, yT = ss[-1, 0], ss[-1, 1]
                _, gxT, gyT = obstacle_cost_grad_bl(self.omaps, xT, yT)
                V_s[0] += gxT
                V_s[1] += gyT
                hxxT, hyyT = obstacle_curv_bl(self.omaps, xT, yT)
                V_ss[0, 0] += hxxT
                V_ss[1, 1] += hyyT
            if self.bl is not None:
                xT, yT = ss[-1, 0], ss[-1, 1]
                _, gxT, gyT, hxxT, hxyT, hyyT = blob_terms_bl(*self.bl, xT,
                                                              yT)
                if dmask is not None:
                    corrT = blob_concave_bl(*self.bl, xT, yT) * dmask
                    hxxT = hxxT - corrT
                    hyyT = hyyT - corrT
                V_s[0] += gxT
                V_s[1] += gyT
                V_ss[0, 0] += hxxT
                V_ss[0, 1] += hxyT
                V_ss[1, 0] += hxyT
                V_ss[1, 1] += hyyT
            ks, Ks, dV1, dV2, pg = _backward_bl(
                ss, us, self.cT, self.dt, self.sign, self.p, V_s, V_ss,
                self.lb, self.ub, mu, omaps=self.omaps, blobs=self.bl,
                model=self.model,
                ddp=self.use_ddp, ddp_mask=dmask, inv_scale=self.inv_scl)

        pred_decrease = -(dV1 + dV2)
        tiny_model = pred_decrease <= self.tol_cost * (self.cost_guard
                                                       + torch.abs(cost))
        act = torch.logical_not(done)                    # still-solving lanes
        if self.two_kernel is not None:
            ss2, us2, cost2, acc_f = forward(*self.forward_inputs(ks, Ks),
                                             n_alpha=self.n_ls)
            accepted = acc_f > 0.5
        else:
            n_ls = self.n_ls
            ss_all, us_all, costs_all = _forward_multi_alpha_bl(
                ss, us, ks, Ks, self.alphas, self.cT, self.dt, self.sign,
                self.lb, self.ub, self.p, dtype, self.model)
            if self.bl is not None or self.omaps is not None:
                # ss_all (T+1, n_ls, 8, B): each candidate's obstacle penalty
                costs_all = costs_all + self._obs_cost_knots(ss_all)
            improved = costs_all < cost[None]                    # (n_ls, B)
            accepted = torch.any(improved, dim=0)
            rank = torch.arange(n_ls, device=ss.device)[:, None]
            pick = torch.argmin(torch.where(improved, rank, n_ls + 1), dim=0)
            sel = torch.nn.functional.one_hot(pick, n_ls).to(dtype).T
            ss_n = torch.einsum("ab,taib->tib", sel, ss_all)
            us_n = torch.einsum("ab,tamb->tmb", sel, us_all)
            cost_n = torch.einsum("ab,ab->b", sel, costs_all)
            upd_x = torch.logical_and(act, accepted)
            ss2 = torch.where(upd_x[None, None, :], ss_n, ss)
            us2 = torch.where(upd_x[None, None, :], us_n, us)
            cost2 = torch.where(upd_x, cost_n, cost)
        upd = torch.logical_and(act, accepted)
        mu_f = self.mu_factor
        mu2 = torch.where(
            upd, torch.maximum(mu / mu_f, self.mu_min),
            torch.where(act, torch.minimum(mu * mu_f, self.mu_max), mu))
        small_step = torch.logical_and(
            accepted, torch.abs(cost - cost2)
            <= self.tol_cost * (self.cost_guard + torch.abs(cost)))
        n_small2 = torch.where(act, torch.where(small_step, self.n_small + 1,
                                                0), self.n_small)
        # a tiny predicted decrease is the optimum only with the trust
        # region open; under inflated mu it is a stall only if the step was
        # also rejected (mu_open reads the OLD mu)
        mu_open = mu <= self.mu_min * mu_f
        converged_now = ((pg < self.tol_grad) | (n_small2 >= 2)
                         | (tiny_model & mu_open))
        stalled = ((~accepted & (mu2 >= self.mu_max))
                   | (tiny_model & ~mu_open & ~accepted))
        self.done = torch.where(act, converged_now | stalled, done)
        self.conv = torch.where(act, converged_now, self.conv)
        self.gnorm = torch.where(act, pg, gnorm)
        self.iters = self.iters + act.to(torch.int32)
        self.ss, self.us, self.cost, self.mu = ss2, us2, cost2, mu2
        self.n_small = n_small2
        self.it += 1

    def result(self) -> SolveResult:
        return SolveResult(
            us=self.us.permute(2, 0, 1),              # (B, T, 2)
            zs=self.ss[:, :6, :].permute(2, 0, 1),    # (B, N, 6)
            cost=self.cost,
            converged=self.conv,
            n_iters=self.iters,
            grad_norm=self.gnorm,
            reg=self.mu,
        )

    def run(self) -> SolveResult:
        while self.running():
            self.step()
        return self.result()


def _refuse_route_ddp(cfg: SolverConfig) -> None:
    if cfg.ddp != "auto" and bool(cfg.ddp):
        # ddp="auto" resolves to GN on this backward instead of raising
        raise ValueError(
            "SolverConfig.ddp is implemented on the megakernel and XLA "
            "lane paths; the legacy two-kernel backward (backward='pallas')"
            " does not carry the second-order terms")


def solve_two_kernel(z0s, coeffs, p, cfg: SolverConfig, u_init=None,
                     plain: bool = False) -> SolveResult:
    """The two-kernel route (K4 backward + K5 line search) on any inputs
    the kernels take; `plain=True` runs the kernels' plain versions by
    name (see `two_kernel_stages`)."""
    _refuse_route_ddp(cfg)
    return LaneSQP(z0s, coeffs, p, cfg, u_init,
                   two_kernel=two_kernel_stages(plain)).run()


def batch_solve_lane(z0s: torch.Tensor, coeffs: torch.Tensor, p,
                     cfg: SolverConfig, u_init=None, omaps=None, blobs=None,
                     refs=None) -> SolveResult:
    """Lane-major batched solve. z0s (B, 6), coeffs (B, P); per-scenario
    MPCParams leaves of shape (B,) ride the lanes. Returns a batch-major
    SolveResult.

    `blobs`: a `GaussianObstacles` with (B, K) leaves, per-scenario
    parametric obstacles (the kernel route and the XLA lane path carry
    them). `omaps`: an `ObstacleMap` with leaves (B, ...), per-scenario
    grid costmaps; they run on the XLA lane path whatever `backward` says
    (the JAX package's rule: grid sampling is no kernel's). `refs`:
    (B, n_steps, 3) per-knot (ref_cte, ref_etheta, ref_vel) setpoint
    profiles: the kernel route evaluates them, every other configuration
    runs on `engine.batch_solve` (shared or per-lane params, blobs
    composed with the profiles; grid maps refused)."""
    if omaps is not None and refs is not None:
        # the JAX package's refusal: the fallback below carries no
        # batched grid terms
        raise ValueError(
            "batch_solve_lane(refs=...) with grid omaps requires the "
            "megakernel path (cfg.backward='mega' on a kernel shape); "
            "the registry-generic fallback does not carry batched grid "
            "terms")
    if cfg.model not in ("diff_drive", "bicycle"):
        # the lane stages are specialized per family; a silent diff-drive
        # fallback would solve a custom family with the wrong dynamics
        raise ValueError(
            f"batch_solve_lane supports the lane-specialized families "
            f"('diff_drive', 'bicycle'), got {cfg.model!r}; use "
            f"engine.batch_solve for registry-defined families")
    if cfg.backward not in ("auto", "mega", "pallas", "xla"):
        raise ValueError(f"unknown backward {cfg.backward!r}")

    B = z0s.shape[0]
    kernels_ok = (omaps is None and B % 128 == 0
                  and z0s.dtype == torch.float32)
    on_cuda = z0s.device.type == "cuda"
    use_mega = kernels_ok and (cfg.backward == "mega" or (
        cfg.backward == "auto" and on_cuda))
    # the two-kernel route predates obstacles and the bicycle: with either,
    # "pallas" runs the XLA lane path
    use_pallas = (not use_mega and kernels_ok and blobs is None
                  and cfg.backward == "pallas" and cfg.model == "diff_drive")
    if use_pallas:
        _refuse_route_ddp(cfg)
    if refs is not None and not use_mega:
        # the XLA lane stages keep the scalar setpoints: profiles off the
        # kernel run on the single-scenario solver, batched (per-lane
        # params ride its batch, blobs compose with the profiles)
        from ..engine.batch import batch_solve

        return batch_solve(z0s, coeffs, p, cfg, u_init=u_init,
                           refs=torch.as_tensor(refs, dtype=z0s.dtype,
                                                device=z0s.device),
                           blobs=blobs)
    if use_mega:
        dtype, dev = z0s.dtype, z0s.device
        with span("dispatch.lane_inputs"):
            zT, cT, pp, lb, ub, us0 = lane_inputs(z0s, coeffs, p, cfg,
                                                  u_init)
            bl = (None if blobs is None else
                  tuple(a.to(dtype=dtype, device=dev) for a in blobs.lane()))
            refsT = (None if refs is None else torch.as_tensor(
                refs, dtype=dtype, device=dev).permute(1, 2, 0).contiguous())
        # CUDA tensors launch the kernel, CPU tensors run its plain version
        (ss_f, us_f, cost_f, conv_f, iters_f, gnorm_f, mu_f,
         _done) = solve_mega_scheduled(zT, cT, pp, lb, ub, us0, cfg,
                                       blobs=bl, refs=refsT)
        with span("dispatch.result"):
            return SolveResult(
                us=us_f.permute(2, 0, 1),               # (B, T, 2)
                zs=ss_f[:, :6, :].permute(2, 0, 1),     # (B, N, 6)
                cost=cost_f,
                converged=conv_f > 0.5,
                n_iters=iters_f.to(torch.int32),
                grad_norm=gnorm_f,
                reg=mu_f,
            )
    if use_pallas:
        return solve_two_kernel(z0s, coeffs, p, cfg, u_init)
    return LaneSQP(z0s, coeffs, p, cfg, u_init, blobs=blobs,
                   omaps=omaps).run()
