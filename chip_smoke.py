#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`mpc_ros_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Needs one CUDA device and the CUDA toolkit's nvcc; exits non-zero without
them and never falls back to the CPU. Phases, one output line each:

 1. the card: `nvidia-smi --query-gpu=name,power.limit`;
 2. the kernel build (seconds, ptxas registers and spills per variant);
 3. the solve kernel against its plain PyTorch version on the same card,
    B=8192, N=30, the same inputs on both sides, held to the solver parity
    gates (`mpc_ros_tpu_torch.verify.parity_gates`, limits printed) in
    four variants: (a) production (ddp, 4 line-search candidates, fast
    trig), (b) exact trig, (c) Gauss-Newton with 8 candidates, (d)
    per-lane weights scaled x{0.5, 1, 4} under the adaptive weight scale;
 4. the main path: `batch_solve_lane` at the production configuration,
    B=524,288 — solves/s of the kernel path and of the plain version at
    the same shape, converged fraction, mean iterations, kernel launches,
    and the kernel against its plain version at that shape;
 5. serving: `receding_horizon_rollout`, 131,072 robots x 10 cycles —
    control cycles/s, mean warm iterations, converged fraction, kernel
    launches, and the kernel against its plain version on a warm-started
    cycle;
 6. the two-kernel route's kernels — the fused backward (K4) and the fused
    line search (K5) — against their plain versions on the inputs of a
    real SQP iteration (iteration 1, and the state after 3 iterations,
    where mu and act vary across lanes) at B=8192 and B=524,288, then the
    route end to end against the route with the plain versions;
 7. the two-kernel main path: `batch_solve_lane(backward="pallas")` at
    B=524,288 — solves/s, K4/K5 time per launch, launches per solve
    (= iterations run), converged fraction, the plain route's time, and
    the route against the whole-solve kernel in its matching variant;
 8. serving through the route: 131,072 robots x 3 cycles.

Then a JSON line describing each kernel (launches on the main path, error
against the plain version, times, the bound on this card) and, last, the
device JSON line. Every phase raises on failure; nothing is caught.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import time

import torch

from mpc_ros_tpu_torch.config import MPCParams, SolverConfig
from mpc_ros_tpu_torch.engine import (make_random_scenarios,
                                      receding_horizon_rollout)
from mpc_ros_tpu_torch.kernels import _build, backward_fused, forward
from mpc_ros_tpu_torch.kernels import solve_mega
from mpc_ros_tpu_torch.solver.batch_lane import (LaneSQP, batch_solve_lane,
                                                 lane_inputs,
                                                 solve_two_kernel,
                                                 two_kernel_stages)
from mpc_ros_tpu_torch.testing import scaled_weights
from mpc_ros_tpu_torch.verify import parity_gates

N_STEPS = 30
B_VERIFY = 8192
B_MAIN = 524288
B_SERVE = 131072
N_CYCLES = 10
ROUTE_CYCLES = 3
# the production N=30 configuration of bench.py
PROD = SolverConfig(n_steps=N_STEPS, max_sqp_iters=12, ls_iters=4, ddp=True,
                    tol_grad=1e-4, trig="fast", scale_adaptive=True,
                    schedule="auto")
# the legacy two-kernel route: Gauss-Newton, 8 candidates, no adaptive
# weight scale (the knobs `backward="pallas"` resolves)
ROUTE = SolverConfig(n_steps=N_STEPS, max_sqp_iters=12, tol_grad=1e-4,
                     backward="pallas")
# the whole-solve kernel in the route's matching variant
ROUTE_MEGA = SolverConfig(n_steps=N_STEPS, max_sqp_iters=12, tol_grad=1e-4,
                          ddp=False, ls_iters=8, trig="exact",
                          scale_adaptive=False, backward="mega")
N_ALPHA = ROUTE.ls_for(torch.float32)

# The card's peaks for the bounds (NVIDIA's H100 SXM data sheet): HBM3 at
# 3.35 TB/s, f32 outside the tensor cores at 67 TFLOP/s.
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
# Arithmetic per scenario, counted from the kernel sources (an add, a
# multiply, a division, a sin or a cos each one operation; the box QP's
# nine-combo enumeration ~180): the fused backward ~1,210 per stage; the
# line search ~100 per candidate and stage plus ~125 per stage of the
# winner re-roll; the whole-solve kernel per SQP iteration and stage
# ~1,020 in the backward (row 4 skipped, no trig), ~110 per line-search
# candidate (rotation-composition trig) and ~140 in the re-roll.
FLOP_BWD_STAGE = 1210
FLOP_FWD_CAND_STAGE = 100
FLOP_FWD_REROLL_STAGE = 125
FLOP_MEGA_STAGE = (1020, 110, 140)
# the card's name and power limit as nvidia-smi gives them, read in main()
CARD = ""


def emit(phase: str, **fields) -> None:
    """One JSON line per phase; every time and rate stands beside the
    card's name and power limit."""
    print(json.dumps({"phase": phase, "card": CARD, **fields}),
          flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def variants():
    """(name, config, per-lane weight scaling) of the four checks."""
    return [
        ("a_production", PROD, False),
        ("b_trig_exact", dataclasses.replace(PROD, trig="exact"), False),
        ("c_gn_ls8", dataclasses.replace(PROD, ddp=False, ls_iters=8), False),
        ("d_lane_weights", PROD, True),
    ]


def params(B: int, dev, lane_weights: bool) -> MPCParams:
    leaves = (scaled_weights(dataclasses.asdict(MPCParams()), B)
              if lane_weights else {})
    return MPCParams.from_numpy(leaves).astype(torch.float32, dev)


def scenarios(seed: int, B: int, dev):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return make_random_scenarios(gen, B, torch.float32)


def held_against_plain(ins, cfg, what: str):
    """The kernel and its plain version on the same inputs on the card,
    held to the parity gates; raises on a broken gate. Returns (gates,
    kernel seconds, plain seconds), each side timed alone to a sync."""
    t0 = time.perf_counter()
    out_k = solve_mega.solve_mega_cuda(*ins, cfg)
    torch.cuda.synchronize()
    t_k = time.perf_counter() - t0
    t0 = time.perf_counter()
    out_p = solve_mega.solve_mega_plain(*ins, cfg)
    torch.cuda.synchronize()
    t_p = time.perf_counter() - t0
    g = parity_gates(
        out_k[1].permute(2, 0, 1).cpu().numpy(), out_k[2].cpu().numpy(),
        out_k[3].cpu().numpy(), out_k[4].cpu().numpy(),
        out_p[1].permute(2, 0, 1).cpu().numpy(), out_p[2].cpu().numpy(),
        out_p[3].cpu().numpy(), out_p[4].cpu().numpy(), cfg.n_steps)
    if not g["ok"]:
        raise SystemExit(f"kernel disagrees with its plain version ({what}): "
                         f"{g}")
    return g, t_k, t_p


def kernel_vs_plain(dev) -> float:
    """Phase 3; returns the largest gated |du| over the variants."""
    worst = 0.0
    z0s, coeffs = scenarios(0, B_VERIFY, dev)
    for name, cfg, lane_w in variants():
        p = params(B_VERIFY, dev, lane_w)
        g, t_k, t_p = held_against_plain(lane_inputs(z0s, coeffs, p, cfg),
                                         cfg, f"variant {name}")
        emit("kernel_vs_plain", variant=name, kernel_s=t_k, plain_s=t_p,
             **g)
        worst = max(worst, g["max_du"])
    return worst


def reset_launches() -> None:
    """Every kernel's launch count to 0, just before a path is driven."""
    solve_mega.launches = backward_fused.launches = forward.launches = 0


def check_result(res, B: int) -> None:
    T = N_STEPS - 1
    if tuple(res.us.shape) != (B, T, 2) or tuple(res.zs.shape) != (
            B, N_STEPS, 6):
        raise SystemExit(f"unexpected shapes {res.us.shape} {res.zs.shape}")
    for name in ("us", "zs", "cost"):
        if not bool(torch.isfinite(getattr(res, name)).all()):
            raise SystemExit(f"non-finite {name} on the main path")


def main_path(dev) -> dict:
    """Phase 4: the main path through the kernel, then the kernel and the
    plain version timed alone at the same shape."""
    z0s, coeffs = scenarios(1, B_MAIN, dev)
    p = params(B_MAIN, dev, False)
    batch_solve_lane(z0s, coeffs, p, PROD)          # warm-up
    torch.cuda.synchronize()
    reps = 3
    reset_launches()
    t0 = time.perf_counter()
    for _ in range(reps):
        res = batch_solve_lane(z0s, coeffs, p, PROD)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / reps
    launches = solve_mega.launches
    if launches == 0:
        raise SystemExit("the main path did not launch the solve kernel")
    check_result(res, B_MAIN)
    conv = float(res.converged.float().mean())
    iters = float(res.n_iters.float().mean())
    if conv < 0.99:
        raise SystemExit(f"main-path converged fraction {conv} < 0.99")

    ins = lane_inputs(z0s, coeffs, p, PROD)
    kernel_ms = cuda_ms(lambda: solve_mega.solve_mega_cuda(*ins, PROD), reps)
    bound = mega_bound(ins, solve_mega.solve_mega_cuda(*ins, PROD), PROD,
                       res.n_iters)
    # the kernel against its plain version at the main path's shape
    vs_plain, _, plain_s = held_against_plain(ins, PROD, "main path")
    plain_ms = plain_s * 1e3
    out = dict(batch=B_MAIN, solves_per_s=B_MAIN / wall,
               kernel_ms=kernel_ms, plain_ms=plain_ms,
               plain_solves_per_s=B_MAIN / (plain_ms / 1e3),
               bound_ms=bound[0], bound_by=bound[1],
               converged_frac=conv, mean_iters=iters,
               max_iters=int(res.n_iters.max()), launches=launches,
               vs_plain=vs_plain)
    emit("main_path", **out)
    return out


def serving(dev) -> dict:
    """Phase 5: warm-started receding-horizon serving."""
    z0s, coeffs = scenarios(2, B_SERVE, dev)
    p = params(B_SERVE, dev, False)
    # set-up (allocator growth at this shape) is paid once, outside the
    # timed run, and reported on its own
    t0 = time.perf_counter()
    receding_horizon_rollout(z0s, coeffs, p, PROD, n_cycles=2)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    reset_launches()
    t0 = time.perf_counter()
    tr = receding_horizon_rollout(z0s, coeffs, p, PROD, n_cycles=N_CYCLES)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = solve_mega.launches
    if launches == 0:
        raise SystemExit("serving did not launch the solve kernel")
    if not bool(torch.isfinite(tr.us).all()):
        raise SystemExit("non-finite controls in serving")
    # the kernel against its plain version on cycle 1's warm-started solve:
    # the plant state after cycle 0 and cycle 0's solution shifted by one
    us0 = batch_solve_lane(z0s, coeffs, p, PROD).us
    warm = torch.cat([us0[:, 1:], us0[:, -1:]], dim=1)
    vs_plain, _, _ = held_against_plain(
        lane_inputs(tr.zs[1], coeffs, p, PROD, u_init=warm), PROD,
        "serving, warm start")
    out = dict(robots=B_SERVE, cycles=N_CYCLES,
               control_cycles_per_s=B_SERVE * N_CYCLES / wall,
               ms_per_cycle=wall / N_CYCLES * 1e3,
               setup_run_2_cycles_s=setup_s,
               mean_warm_iters=float(tr.iters[1:].float().mean()),
               cold_iters=float(tr.iters[0].float().mean()),
               converged_frac=float(tr.converged.float().mean()),
               launches=launches, vs_plain=vs_plain)
    emit("serving", **out)
    return out


def bound_ms(tensors, flops: float):
    """The least time this card could take for a function: the larger of
    its bytes (each input read once, each output written once) over the
    HBM rate and its operations over the f32 rate. Returns (ms, which)."""
    nbytes = sum(t.numel() * t.element_size() for t in tensors
                 if torch.is_tensor(t))
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def mega_bound(ins, outs, cfg, iters) -> tuple:
    """The whole-solve kernel's bound on one call: its inputs and outputs,
    and the operations of the SQP iterations these lanes ran."""
    T = cfg.n_controls
    bwd, cand, reroll = FLOP_MEGA_STAGE
    per_iter = T * (bwd + cfg.ls_for(torch.float32) * cand + reroll)
    return bound_ms(list(ins) + list(outs),
                    per_iter * float(iters.double().sum()))


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of `fn` over `reps` back-to-back calls (CUDA
    events, after one untimed call)."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def host_s(fn):
    """(result, seconds) of one call timed on the host clock to a sync."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def errors(k, p) -> dict:
    """Max absolute error, and max error relative to the output's largest
    magnitude."""
    d = float((k - p).abs().max())
    return {"max_abs": d, "max_rel": d / max(float(p.abs().max()), 1e-30)}


def lanes_within(pairs, tol: float):
    """(B,) bool: every element of every (kernel, plain) pair of a lane
    lies within tol * (1 + |plain|)."""
    ok = None
    for k, p in pairs:
        bad = ((k - p).abs() > tol * (1.0 + p.abs())).reshape(-1, k.shape[-1])
        lane_ok = ~bad.any(dim=0)
        ok = lane_ok if ok is None else ok & lane_ok
    return ok


# Tolerances of phase 6, on identical inputs. The kernels compute in f32
# with FMA contraction, the plain versions with separate multiplies and
# adds: rounding-level differences that the 29-stage recursions carry.
# The box QP's active set and the line search's acceptance are
# discontinuous in their inputs, so such a difference can flip a stage's
# clamp or a lane's accepted alpha; those lanes are bounded by a fraction
# (0.999, the parity gates' conv-match bar) and their effect by the
# end-to-end parity gates. Within a lane, 1e-3 relative to 1 + |value|
# holds 2-3 orders above the f32 rounding measured against a CPU
# emulation of the kernels (2.4e-7 in the gains, 4.7e-5 in the
# trajectories).
LANE_TOL = 1e-3
LANE_FRAC = 0.999
# The line search's acceptance on identical inputs: at iteration 1 every
# lane is active and far from its optimum, so the flags must agree on
# >= LANE_FRAC of all lanes. Later, converged lanes compare candidate
# costs that differ from the current one at rounding level, and FMA
# contraction decides them; a flag on a done lane (act = 0) reaches
# nothing, since every update of the loop is masked by act. So from
# iteration 2 on the gate is over active lanes, and a flip counts as a
# tie when the accepting side's improvement is below TIE_REL * (1 + |J|),
# under ten times the solver's own small-step tolerance (10 eps_f32 =
# 1.19e-6 relative). The raw agreement over all lanes is printed.
TIE_REL = 1e-5


def acceptance(fk, fp, cost_prev, act) -> dict:
    """Agreement of the kernel's and the plain version's `accepted`."""
    agree = fk[3] == fp[3]
    gain = torch.maximum(cost_prev - fk[2], cost_prev - fp[2])
    tie = ~agree & (gain <= TIE_REL * (1.0 + cost_prev.abs()))
    on = act > 0.5
    return {"all_lanes": float(agree.float().mean()),
            "active_lanes": float(agree[on].float().mean()),
            "active_agree_or_tie": float((agree | tie)[on].float().mean()),
            "agree": agree}


def stage_kernels_vs_plain(dev) -> dict:
    """Phase 6: K4 and K5 against their plain versions on the inputs of
    SQP iterations 1 and 4 of the route, then the route against the route
    with the plain versions, at B=8192 and B=524,288."""
    out = {"bwd_err": 0.0, "fwd_err": 0.0}
    for B in (B_VERIFY, B_MAIN):
        z0s, coeffs = scenarios(3, B, dev)
        p = params(B, dev, False)
        sqp = LaneSQP(z0s, coeffs, p, ROUTE, two_kernel=two_kernel_stages())
        for it in range(4):
            if it in (0, 3):
                bi = sqp.backward_inputs()
                bk = backward_fused.backward_fused_cuda(*bi)
                bp, bp_s = host_s(lambda: backward_fused.backward_fused_plain(
                    *bi))
                names = ("ks", "Ks", "dV1", "dV2", "pg")
                b_errs = {n: errors(k, q) for n, k, q in zip(names, bk, bp)}
                b_ok = float(lanes_within(zip(bk, bp), LANE_TOL)
                             .float().mean())
                fi = sqp.forward_inputs(bp[0], bp[1])
                fk = forward.forward_cuda(*fi, n_alpha=N_ALPHA)
                fp, fp_s = host_s(lambda: forward.forward_plain(
                    *fi, n_alpha=N_ALPHA))
                act = fi[-1]
                acc = acceptance(fk, fp, fi[9], act)
                agree = acc.pop("agree")
                f_errs = {n: errors(k[..., agree], q[..., agree])
                          for n, k, q in zip(("ss", "us", "cost"), fk[:3],
                                             fp[:3])}
                # trajectories over the lanes whose acceptance agrees
                f_ok = float(lanes_within(
                    [(k[..., agree], q[..., agree]) for k, q in
                     zip(fk[:3], fp[:3])], LANE_TOL).float().mean())
                acc_gate = (acc["all_lanes"] if it == 0
                            else acc["active_agree_or_tie"])
                emit("stage_kernels_vs_plain", batch=B, iteration=it + 1,
                     mu_distinct=int(torch.unique(bi[-1]).numel()),
                     act_frac=float(act.mean()),
                     backward=b_errs, backward_lanes_within=b_ok,
                     forward=f_errs, forward_lanes_within=f_ok,
                     accepted_agreement=acc,
                     accepted_frac=float(fp[3].mean()),
                     tol={"lane": LANE_TOL, "lane_frac": LANE_FRAC,
                          "tie_rel": TIE_REL})
                if min(b_ok, f_ok, acc_gate) < LANE_FRAC:
                    raise SystemExit(
                        f"K4/K5 disagree with their plain versions (B={B}, "
                        f"iteration {it + 1}): lanes within tolerance "
                        f"{b_ok} / {f_ok}, accepted agreement {acc}")
                out["bwd_err"] = max(out["bwd_err"],
                                     b_errs["ks"]["max_abs"],
                                     b_errs["Ks"]["max_abs"])
                out["fwd_err"] = max(out["fwd_err"], f_errs["us"]["max_abs"])
                if B == B_MAIN and it == 0:
                    out["bwd_plain_ms"] = bp_s * 1e3
                    out["fwd_plain_ms"] = fp_s * 1e3
            sqp.step()
        # the route end to end, kernels against plain versions
        rk, rk_s = host_s(lambda: solve_two_kernel(z0s, coeffs, p, ROUTE))
        rp, rp_s = host_s(lambda: solve_two_kernel(z0s, coeffs, p, ROUTE,
                                                   plain=True))
        g = parity_gates(
            rk.us.cpu().numpy(), rk.cost.cpu().numpy(),
            rk.converged.cpu().numpy(), rk.n_iters.cpu().numpy(),
            rp.us.cpu().numpy(), rp.cost.cpu().numpy(),
            rp.converged.cpu().numpy(), rp.n_iters.cpu().numpy(), N_STEPS)
        emit("route_vs_plain_route", kernel_route_s=rk_s,
             plain_route_s=rp_s, **g)
        if not g["ok"]:
            raise SystemExit(f"the route disagrees with its plain version "
                             f"(B={B}): {g}")
        if B == B_MAIN:
            out["plain_route_s"] = rp_s
            out["route_max_du"] = g["max_du"]
    return out


def route_main_path(dev, plain_route_s: float) -> dict:
    """Phase 7: `batch_solve_lane(backward="pallas")` at B=524,288, cold
    starts; then K4 and K5 timed per launch on iteration 1's inputs."""
    z0s, coeffs = scenarios(4, B_MAIN, dev)
    p = params(B_MAIN, dev, False)
    batch_solve_lane(z0s, coeffs, p, ROUTE)          # warm-up
    torch.cuda.synchronize()
    reps = 3
    reset_launches()
    t0 = time.perf_counter()
    for _ in range(reps):
        res = batch_solve_lane(z0s, coeffs, p, ROUTE)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / reps
    launches = {"solve_mega": solve_mega.launches,
                "backward_fused": backward_fused.launches,
                "forward": forward.launches}
    check_result(res, B_MAIN)
    its = int(res.n_iters.max())
    if min(launches["backward_fused"], launches["forward"]) == 0:
        raise SystemExit(f"the route did not launch its kernels: {launches}")
    if (launches["backward_fused"] != reps * its
            or launches["forward"] != reps * its
            or launches["solve_mega"] != 0):
        raise SystemExit(f"launches {launches} over {reps} solves are not "
                         f"one per kernel and iteration ({its} iterations)")
    conv = float(res.converged.float().mean())
    if conv < 0.99:
        raise SystemExit(f"route converged fraction {conv} < 0.99")

    # the host read of the exit condition: the same solve with its `its`
    # iterations enqueued back to back (a done lane never updates, so the
    # result is the same bit for bit)
    def no_read():
        sqp = LaneSQP(z0s, coeffs, p, ROUTE, two_kernel=two_kernel_stages())
        for _ in range(its):
            sqp.step()
        return sqp.result()

    no_read()
    free, free_s = host_s(no_read)
    same = all(torch.equal(getattr(free, f), getattr(res, f))
               for f in ("us", "zs", "cost", "converged", "n_iters"))
    if not same:
        raise SystemExit("the solve without the exit read differs")

    sqp = LaneSQP(z0s, coeffs, p, ROUTE, two_kernel=two_kernel_stages())
    bi = sqp.backward_inputs()
    bwd_ms = cuda_ms(lambda: backward_fused.backward_fused_cuda(*bi), 10)
    bk = backward_fused.backward_fused_cuda(*bi)
    fi = sqp.forward_inputs(bk[0], bk[1])
    fwd_ms = cuda_ms(lambda: forward.forward_cuda(*fi, n_alpha=N_ALPHA), 10)
    fk = forward.forward_cuda(*fi, n_alpha=N_ALPHA)
    T = ROUTE.n_controls
    bwd_bound = bound_ms(list(bi) + list(bk), FLOP_BWD_STAGE * T * B_MAIN)
    fwd_bound = bound_ms(list(fi) + list(fk), (
        N_ALPHA * FLOP_FWD_CAND_STAGE + FLOP_FWD_REROLL_STAGE) * T * B_MAIN)

    # the whole-solve kernel in the route's matching variant, no gate
    mega = batch_solve_lane(z0s, coeffs, p, ROUTE_MEGA)
    vs_mega = parity_gates(
        res.us.cpu().numpy(), res.cost.cpu().numpy(),
        res.converged.cpu().numpy(), res.n_iters.cpu().numpy(),
        mega.us.cpu().numpy(), mega.cost.cpu().numpy(),
        mega.converged.cpu().numpy(), mega.n_iters.cpu().numpy(), N_STEPS)
    out = dict(batch=B_MAIN, solves_per_s=B_MAIN / wall,
               ms_per_solve=wall * 1e3,
               iterations_run=its, launches_per_solve={
                   k: v / reps for k, v in launches.items()},
               converged_frac=conv, mean_iters=float(res.n_iters.float()
                                                     .mean()),
               max_iters=its, ms_per_solve_no_exit_read=free_s * 1e3,
               exit_read_ms_per_iter=(wall - free_s) * 1e3 / its,
               bwd_ms=bwd_ms, fwd_ms=fwd_ms,
               bwd_bound_ms=bwd_bound[0], bwd_bound_by=bwd_bound[1],
               fwd_bound_ms=fwd_bound[0], fwd_bound_by=fwd_bound[1],
               plain_route_s=plain_route_s,
               plain_route_solves_per_s=B_MAIN / plain_route_s,
               vs_mega_matching_variant=vs_mega, launches=launches)
    emit("route_main_path", **out)
    return out


def route_serving(dev) -> dict:
    """Phase 8: warm-started serving through the two-kernel route."""
    z0s, coeffs = scenarios(5, B_SERVE, dev)
    p = params(B_SERVE, dev, False)
    receding_horizon_rollout(z0s, coeffs, p, ROUTE, n_cycles=1)   # set-up
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    tr = receding_horizon_rollout(z0s, coeffs, p, ROUTE,
                                  n_cycles=ROUTE_CYCLES)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"solve_mega": solve_mega.launches,
                "backward_fused": backward_fused.launches,
                "forward": forward.launches}
    its = int(tr.iters.max(dim=1).values.sum())
    if launches != {"solve_mega": 0, "backward_fused": its, "forward": its}:
        raise SystemExit(f"serving launches {launches} are not one per "
                         f"kernel and iteration ({its} iterations)")
    if not bool(torch.isfinite(tr.us).all()):
        raise SystemExit("non-finite controls in route serving")
    out = dict(robots=B_SERVE, cycles=ROUTE_CYCLES,
               control_cycles_per_s=B_SERVE * ROUTE_CYCLES / wall,
               ms_per_cycle=wall / ROUTE_CYCLES * 1e3,
               mean_warm_iters=float(tr.iters[1:].float().mean()),
               cold_iters=float(tr.iters[0].float().mean()),
               converged_frac=float(tr.converged.float().mean()),
               launches=launches)
    emit("route_serving", **out)
    return out


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device; none found")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    global CARD
    CARD = card_line()
    print(CARD, flush=True)

    # every kernel variant the phases launch, one nvcc each, all at once
    t0 = time.perf_counter()
    pairs = {("solve_mega", solve_mega.resolve_knobs(cfg, torch.float32)
              .variant) for cfg in [c for _, c, _ in variants()]
             + [ROUTE_MEGA]}
    pairs |= {("backward_fused", ()), ("forward", (N_ALPHA,))}
    builds = _build.build_many(sorted(pairs))
    emit("build", seconds=time.perf_counter() - t0,
         variants={f"{k}{v}": {"seconds": s, "ptxas": lines}
                   for (k, v), (s, lines) in builds.items()})

    max_err = kernel_vs_plain(dev)
    mp = main_path(dev)
    sv = serving(dev)
    max_err = max(max_err, mp["vs_plain"]["max_du"], sv["vs_plain"]["max_du"])
    st = stage_kernels_vs_plain(dev)
    rm = route_main_path(dev, st["plain_route_s"])
    route_serving(dev)

    def entry(name, source, replaces, launches, err, ms, plain_ms, bound):
        return {"name": name, "route": "cuda",
                "source": f"mpc_ros_tpu_torch/kernels/csrc/{source}",
                "replaces": replaces, "launches": launches,
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound[0], "bound_by": bound[1],
                "library_ms": None}

    print(json.dumps({"kernels": [
        entry("solve_mega", "solve_mega.cu",
              "mpc_ros_tpu/kernels/solve_pallas.py:53", mp["launches"],
              max_err, mp["kernel_ms"], mp["plain_ms"],
              (mp["bound_ms"], mp["bound_by"])),
        entry("backward_fused", "backward_fused.cu",
              "mpc_ros_tpu/kernels/backward_fused_pallas.py:52",
              rm["launches"]["backward_fused"], st["bwd_err"], rm["bwd_ms"],
              st["bwd_plain_ms"], (rm["bwd_bound_ms"], rm["bwd_bound_by"])),
        entry("forward", "forward.cu",
              "mpc_ros_tpu/kernels/forward_pallas.py:37",
              rm["launches"]["forward"], st["fwd_err"], rm["fwd_ms"],
              st["fwd_plain_ms"], (rm["fwd_bound_ms"], rm["fwd_bound_by"])),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
