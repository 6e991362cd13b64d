"""Tests that need an NVIDIA GPU (marker `cuda`; they skip without one):
the three kernels against their plain versions on the card (the solve
kernel also with resume state and the per-block exit), the main path, the
long-horizon compact schedule and the two-kernel route launching them, the
XLA lane path taking what the kernels do not, and the single-robot closed
loop (the planner and the trajectory tracker on the three courses) and
fleet serving (the host and device pipelines and the fleet trajectory
tracker, with K1 launched once per cycle), grid costmaps on the XLA lane
path against the CPU, the fleet's costmap route (one K1 launch per
cycle), the device blob fit and the supervisors, and the single-robot
cycles as captured CUDA graphs against the eager cycles. Run on
the card with
`python -m pytest --noconftest tests/test_torch_cuda.py` (tests/conftest.py
configures JAX, which the card's machine need not have).
"""

import dataclasses

import numpy as np

import pytest
import torch

from mpc_ros_tpu_torch.config import MPCParams, SolverConfig
from mpc_ros_tpu_torch.engine import (make_random_scenarios,
                                      receding_horizon_rollout)
from mpc_ros_tpu_torch.kernels import backward_fused, forward, solve_mega
from mpc_ros_tpu_torch.models.obstacles import GaussianObstacles
from mpc_ros_tpu_torch.solver.batch_lane import (LaneSQP, batch_solve_lane,
                                                 lane_inputs,
                                                 solve_two_kernel,
                                                 two_kernel_stages)
from mpc_ros_tpu_torch.testing import (WITNESS_LANE, next_backward_witness,
                                       nonfinite_agreement, numpy_blobs,
                                       numpy_refs, plant_nonfinite)
from mpc_ros_tpu_torch.verify import parity_gates

pytestmark = pytest.mark.cuda

PROD = SolverConfig(n_steps=30, max_sqp_iters=12, ls_iters=4, ddp=True,
                    tol_grad=1e-4)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _scen(dev, B, seed=0):
    return make_random_scenarios(torch.Generator(device=dev).manual_seed(seed),
                                 B)


@pytest.mark.parametrize("B", [1024, 8192])
@pytest.mark.parametrize("variant", ["prod", "exact", "gn", "no_adaptive"])
def test_kernel_matches_plain(dev, variant, B):
    cfg = {"prod": PROD,
           "exact": dataclasses.replace(PROD, trig="exact"),
           "gn": dataclasses.replace(PROD, ddp=False, ls_iters=8),
           "no_adaptive": dataclasses.replace(PROD, scale_adaptive=False,
                                              n_steps=12)}[variant]
    z0s, coeffs = _scen(dev, B)
    ins = lane_inputs(z0s, coeffs, MPCParams().astype(torch.float32, dev),
                      cfg)
    k = solve_mega.solve_mega_cuda(*ins, cfg)
    p = solve_mega.solve_mega_plain(*ins, cfg)
    g = parity_gates(k[1].permute(2, 0, 1).cpu(), k[2].cpu(), k[3].cpu(),
                     k[4].cpu(), p[1].permute(2, 0, 1).cpu(), p[2].cpu(),
                     p[3].cpu(), p[4].cpu(), cfg.n_steps)
    assert g["ok"], g


def test_main_path_and_serving_launch_the_kernel(dev):
    z0s, coeffs = _scen(dev, 2048, seed=1)
    p = MPCParams().astype(torch.float32, dev)
    before = solve_mega.launches
    res = batch_solve_lane(z0s, coeffs, p, PROD)
    assert solve_mega.launches == before + 1
    assert res.us.is_cuda and bool(torch.isfinite(res.us).all())
    tr = receding_horizon_rollout(z0s, coeffs, p, PROD, n_cycles=3)
    assert solve_mega.launches == before + 4
    assert float(tr.converged.float().mean()) >= 0.99


def _launch_counts():
    return (solve_mega.launches, backward_fused.launches, forward.launches)


def test_cuda_refuses_what_the_kernel_does_not_take(dev):
    """Off the kernels' rule (f64, B % 128 != 0) a CUDA solve runs the XLA
    lane path on the card, launching no kernel; the wrappers refuse f64."""
    z0s, coeffs = _scen(dev, 256)
    before = _launch_counts()
    for z, c in ((z0s.double(), coeffs.double()), (z0s[:200], coeffs[:200])):
        res = batch_solve_lane(z, c, MPCParams(), PROD)
        assert res.us.is_cuda and res.us.dtype == z.dtype
        assert bool(torch.isfinite(res.us).all())
        assert float(res.converged.float().mean()) >= 0.99
    assert _launch_counts() == before
    ins = lane_inputs(z0s, coeffs, MPCParams(), PROD)
    with pytest.raises(ValueError):
        solve_mega.solve_mega_cuda(*(a.double() for a in ins), PROD)
    sqp = LaneSQP(z0s, coeffs, MPCParams(), ROUTE,
                  two_kernel=two_kernel_stages(plain=True))
    bi = [a.double() if torch.is_tensor(a) else a
          for a in sqp.backward_inputs()]
    with pytest.raises(ValueError):
        backward_fused.backward_fused_cuda(*bi)
    fi = [a.double() if torch.is_tensor(a) else a
          for a in sqp.forward_inputs(*backward_fused.backward_fused_plain(
              *sqp.backward_inputs())[:2])]
    with pytest.raises(ValueError):
        forward.forward_cuda(*fi, n_alpha=8)
    assert _launch_counts() == before


# the two-kernel route: GN, 8 candidates, the adaptive scale off
ROUTE = SolverConfig(n_steps=30, max_sqp_iters=12, tol_grad=1e-4,
                     backward="pallas")


def _iteration_inputs(dev, B, iters):
    """The backward and forward inputs of SQP iteration `iters` + 1 of the
    route (plain stages) on B scenarios, and the plain outputs on them."""
    z0s, coeffs = _scen(dev, B, seed=3)
    sqp = LaneSQP(z0s, coeffs, MPCParams().astype(torch.float32, dev), ROUTE,
                  two_kernel=two_kernel_stages(plain=True))
    for _ in range(iters):
        sqp.step()
    bi = sqp.backward_inputs()
    bp = backward_fused.backward_fused_plain(*bi)
    return bi, bp, sqp.forward_inputs(bp[0], bp[1])


@pytest.mark.parametrize("iters", [0, 3])
def test_backward_fused_kernel_matches_plain(dev, iters):
    bi, bp, _ = _iteration_inputs(dev, 1024, iters)
    bk = backward_fused.backward_fused_cuda(*bi)
    torch.cuda.synchronize()
    # f32 with FMA contraction against separate multiply-adds: rounding-
    # level differences, amplified through the 29-stage recursion
    for k, p in zip(bk, bp):
        torch.testing.assert_close(k, p, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("iters", [0, 3])
@pytest.mark.parametrize("n_alpha", [8, 3])
def test_forward_kernel_matches_plain(dev, iters, n_alpha):
    _, _, fi = _iteration_inputs(dev, 1024, iters)
    fk = forward.forward_cuda(*fi, n_alpha=n_alpha)
    fp = forward.forward_plain(*fi, n_alpha=n_alpha)
    torch.cuda.synchronize()
    agree = fk[3] == fp[3]
    if iters == 0:
        # every lane active and far from its optimum: the flags agree
        assert float(agree.float().mean()) >= 0.999
    else:
        # converged lanes compare candidate costs equal to the current one
        # at rounding level, and FMA contraction decides them; a flag on a
        # done lane (act = 0) reaches nothing. Over active lanes, a flip
        # must be such a tie: the accepting side gains < 1e-5 (1 + |J|)
        cost, on = fi[9], fi[10] > 0.5
        gain = torch.maximum(cost - fk[2], cost - fp[2])
        tie = ~agree & (gain <= 1e-5 * (1.0 + cost.abs()))
        assert float((agree | tie)[on].float().mean()) >= 0.999
    # over the lanes whose acceptance agrees, the trajectories and costs
    # agree to f32 rounding carried through 29 steps; a lane may still
    # take another (tied) alpha, so the bar is per lane on >= 0.999 of
    # them, as in chip_smoke.py
    lane_ok = torch.ones_like(agree)
    for k, p in zip(fk[:3], fp[:3]):
        bad = (k - p).abs() > 1e-3 * (1.0 + p.abs())
        lane_ok &= ~bad.reshape(-1, bad.shape[-1]).any(dim=0)
    assert float(lane_ok[agree].float().mean()) >= 0.999


@pytest.mark.parametrize("iters", [0, 3])
def test_forward_second_pass_matches_design(dev, iters):
    """The kernel's `second` output (the second pass each lane took, and
    its winning candidate) equals what the design computes from the plain
    version's candidates (`forward.second_pass_plain`) on every lane where
    both pick the same candidate, and its pass on every inactive lane
    (whose pass does not depend on the candidate). Near convergence the
    candidates' costs tie with the cost before the step at rounding
    level, which FMA contraction decides, so on >= 0.999 of the active
    lanes the two sides pick the same candidate or the accepting side
    gains < 1e-5 (1 + |J|), as in chip_smoke.py. The lanes that skipped
    the second pass hold the plain version's outputs."""
    _, _, fi = _iteration_inputs(dev, 1024, iters)
    sec = torch.full((1024,), -1, dtype=torch.int8, device=dev)
    fk = forward.forward_cuda(*fi, n_alpha=8, second=sec)
    want = forward.second_pass_plain(*fi, n_alpha=8)
    fp = forward.forward_plain(*fi, n_alpha=8)
    torch.cuda.synchronize()
    same = (sec // 4) == (want // 4)
    cost, on = fi[9], fi[10] > 0.5
    gain = torch.maximum(cost - fk[2], cost - fp[2])
    tie = ~same & (gain <= 1e-5 * (1.0 + cost.abs()))
    assert float((same | tie)[on].float().mean()) >= 0.999
    assert torch.equal(sec[same], want[same])
    assert torch.equal(sec[~on] % 4, want[~on] % 4)
    skipped = same & (sec % 4 == forward.SP_NONE)
    assert int(skipped.sum()) > 0
    for k, p in zip(fk[:2], fp[:2]):
        torch.testing.assert_close(k[..., skipped], p[..., skipped],
                                   rtol=1e-3, atol=1e-3)


# lanes planted with NaN, inf or an overflowing coefficient
NONFINITE_LANES = (3, 130, 257, 390, 515, 640, 777, 901, 1000, 1023)


@pytest.mark.parametrize("kernel", ["forward", "backward_fused"])
def test_nonfinite_lanes_match_plain(dev, kernel):
    """K5 and K4 on iteration 1's route inputs (B=1,024) with lanes planted
    with NaN or inf in ss, ks, Ks and the coefficients: NaN and inf where
    the plain version has them (clip and max propagate NaN as
    torch.clamp and torch.maximum do), and every other lane as on the
    clean inputs."""
    bi, _, fi = _iteration_inputs(dev, 1024, 0)
    if kernel == "forward":
        names = ("ss", "us", "ks", "Ks", "coeffs")
        run_k = lambda a: forward.forward_cuda(*a, n_alpha=8)
        run_p = lambda a: forward.forward_plain(*a, n_alpha=8)
        clean = fi
    else:
        names = ("ss", "us", "coeffs")
        run_k = lambda a: backward_fused.backward_fused_cuda(*a)
        run_p = lambda a: backward_fused.backward_fused_plain(*a)
        clean = bi
    planted = plant_nonfinite(
        {n: a for n, a in zip(names, clean) if n != "us"}, NONFINITE_LANES)
    ins = tuple(planted.get(n, a) for n, a in zip(names, clean)) + tuple(
        clean[len(names):])
    rec = nonfinite_agreement(run_k(ins), run_p(ins), run_k(clean),
                              NONFINITE_LANES, 1e-3)
    assert rec["ok"], rec
    assert rec["planted_lanes_with_nan"] > 0, rec


def test_nonfinite_lanes_match_plain_solve(dev):
    """The whole-solve kernel (K1, production variant, N=30, B=8,192) with
    lanes whose initial state or coefficients hold NaN, inf or 1e30,
    against its plain version: every output, the trajectories included,
    NaN and inf where the plain version has them and every other lane as
    on the clean inputs. A lane whose backward rows are not all finite
    runs the blended re-roll (`solve_mega.replay_check`)."""
    _nonfinite_solve(dev, PROD)


@pytest.mark.parametrize("variant", ["bicycle", "exact", "blobs_setp_tile"])
def test_nonfinite_lanes_match_plain_solve_variants(dev, variant):
    """The same rule in the bicycle, exact-trig and per-block-exit variants
    (the last with blobs and a setpoint profile, done_frac 0.97, N=48)."""
    if variant == "bicycle":
        _nonfinite_solve(dev, dataclasses.replace(PROD, model="bicycle"))
    elif variant == "exact":
        _nonfinite_solve(dev, dataclasses.replace(PROD, trig="exact"))
    else:
        cfg = SolverConfig(n_steps=48, max_sqp_iters=22, tol_grad=1e-4,
                           done_frac=0.97)
        _nonfinite_solve(dev, cfg, with_extras=True)


@pytest.mark.parametrize("done_frac", [1.0, 0.97], ids=["per_lane", "tile"])
@pytest.mark.parametrize("model", ["diff_drive", "bicycle"])
def test_lanes_done_before_the_others_match_plain(dev, done_frac, model):
    """One block (B=128, the plain version's batch): lanes planted with
    NaN, inf and the overflowing coefficient resumed done beside running
    ones, which the plain version blends with act = 0 while the others
    run; the kernel must give the same outputs."""
    cfg = dataclasses.replace(PROD, done_frac=done_frac, model=model)
    B = solve_mega.TILE
    z0s, coeffs = _scen(dev, B, seed=12)
    ins = lane_inputs(z0s, coeffs, MPCParams().astype(torch.float32, dev),
                      cfg)
    lanes = [5, 40, 77, 100]
    planted = plant_nonfinite({"z": ins[0], "coeffs": ins[1]}, lanes)
    bad = (planted["z"], planted["coeffs"]) + tuple(ins[2:])
    done = torch.zeros(B, device=dev)
    done[lanes + [9, 60]] = 1.0
    resume = (done, torch.zeros_like(done), torch.full_like(done, 1e-6),
              torch.full_like(done, float("inf")))
    k = solve_mega.solve_mega_cuda(*bad, cfg, resume=resume)
    p = solve_mega.solve_mega_plain(*bad, cfg, resume=resume)
    clean = solve_mega.solve_mega_cuda(*ins, cfg, resume=resume)
    rec = nonfinite_agreement(k, p, clean, lanes, 1e-3)
    assert rec["ok"] and rec["planted_lanes_with_nan"] >= 3, rec


@pytest.mark.parametrize("done_frac", [1.0, 0.97], ids=["per_lane", "tile"])
def test_next_backward_witness_matches_plain(dev, done_frac):
    """`testing.next_backward_witness`: a lane done on a finite trajectory
    whose next backward overflows; the plain version blends it into NaN,
    and the kernel's probe of that backward must too, every output bit for
    bit."""
    ins, cfg = next_backward_witness(torch.float32, dev, done_frac)
    k = solve_mega.solve_mega_cuda(*ins, cfg)
    p = solve_mega.solve_mega_plain(*ins, cfg)
    for a, b in zip(k, p):
        assert torch.equal(a.isnan(), b.isnan())
        assert torch.equal(torch.nan_to_num(a), torch.nan_to_num(b))
    assert bool(p[0][..., WITNESS_LANE].isnan().any())


def _nonfinite_solve(dev, cfg, with_extras=False):
    z0s, coeffs = _scen(dev, 8192, seed=11)
    ins = lane_inputs(z0s, coeffs, MPCParams().astype(torch.float32, dev),
                      cfg)
    blobs = refs = None
    if with_extras:
        blobs = GaussianObstacles.from_sigmas(*(
            torch.tensor(a, dtype=torch.float32, device=dev)
            for a in numpy_blobs(11, 8192))).lane()
        refs = torch.tensor(numpy_refs(11, 8192, cfg.n_steps),
                            dtype=torch.float32, device=dev).permute(
                                1, 2, 0).contiguous()
    lanes = [4 + 811 * i for i in range(10)]
    planted = plant_nonfinite({"z": ins[0], "coeffs": ins[1]}, lanes)
    bad = (planted["z"], planted["coeffs"]) + tuple(ins[2:])
    kw = dict(blobs=blobs, refs=refs)
    k = solve_mega.solve_mega_cuda(*bad, cfg, **kw)
    p = solve_mega.solve_mega_plain(*bad, cfg, **kw)
    clean = solve_mega.solve_mega_cuda(*ins, cfg, **kw)
    if cfg.done_frac < 1.0:
        # under the per-block exit a planted lane moves the stop of its
        # block, so its block-mates take other iterations than on clean
        # inputs: they are held finite here and left out of the bit-for-bit
        # comparison with the clean run
        mates = torch.zeros(8192, dtype=torch.bool, device=dev)
        for i in lanes:
            mates[i - i % 128:i - i % 128 + 128] = True
        mates[lanes] = False
        assert all(bool(a[..., mates].isfinite().all()) for a in k)
        clean = tuple(torch.where(mates, a, c) for a, c in zip(k, clean))
    rec = nonfinite_agreement(k, p, clean, lanes, 1e-3)
    assert rec["ok"], rec
    assert rec["planted_lanes_with_nan"] > 0, rec


def test_route_launches_each_kernel_once_per_iteration(dev):
    z0s, coeffs = _scen(dev, 2048, seed=4)
    p = MPCParams().astype(torch.float32, dev)
    before = _launch_counts()
    res = batch_solve_lane(z0s, coeffs, p, ROUTE)
    torch.cuda.synchronize()
    its = int(res.n_iters.max())
    assert _launch_counts() == (before[0], before[1] + its, before[2] + its)
    assert float(res.converged.float().mean()) >= 0.99
    plain = solve_two_kernel(z0s, coeffs, p, ROUTE, plain=True)
    g = parity_gates(res.us.cpu(), res.cost.cpu(), res.converged.cpu(),
                     res.n_iters.cpu(), plain.us.cpu(), plain.cost.cpu(),
                     plain.converged.cpu(), plain.n_iters.cpu(), 30)
    assert g["ok"], g
    assert _launch_counts()[1:] == (before[1] + its, before[2] + its)


# the long-horizon configuration: N = 48 at the cap round(0.45 N) = 22,
# auto knobs (the long-horizon pair)
LONG = SolverConfig(n_steps=48, max_sqp_iters=22, tol_grad=1e-4)


def _gates(k, p, n_steps):
    return parity_gates(k[1].permute(2, 0, 1).cpu(), k[2].cpu(), k[3].cpu(),
                        k[4].cpu(), p[1].permute(2, 0, 1).cpu(), p[2].cpu(),
                        p[3].cpu(), p[4].cpu(), n_steps)


@pytest.mark.parametrize("case", ["tile_exit", "resume"])
def test_kernel_tile_exit_and_resume_match_plain(dev, case):
    """done_frac = 0.97 (the per-block exit) cold, and done_frac = 1
    resumed from a pass-1 result with some done lanes re-armed, against
    the plain version on the same 128-lane tiles."""
    z0s, coeffs = _scen(dev, 8192, seed=5)
    ins = lane_inputs(z0s, coeffs, MPCParams().astype(torch.float32, dev),
                      LONG)
    cfg, resume = LONG, None
    pass1 = dataclasses.replace(LONG, done_frac=0.97)
    if case == "tile_exit":
        cfg = pass1
    else:
        p1 = solve_mega.solve_mega_plain(*ins, pass1)
        done = p1[7].clone()
        done[::7] = 0.0
        resume = (done, p1[3], p1[6], p1[5])
        ins = ins[:5] + (p1[1],)
    k = solve_mega.solve_mega_cuda(*ins, cfg, resume=resume)
    p = solve_mega.solve_mega_plain(*ins, cfg, resume=resume)
    torch.cuda.synchronize()
    g = _gates(k, p, 48)
    assert g["ok"], g
    if case == "tile_exit":
        # tiles stopped with lanes not done, as on the plain side
        assert 0.0 < float((k[7] < 0.5).float().mean()) < 0.03
    else:
        was_done = resume[0] > 0.5
        assert bool((k[4][was_done] == 0).all())


def test_lockstep_loop_equals_per_thread_loop(dev):
    """The per-block loop at done_frac = 1 (`lockstep=True`) runs every
    lane as the per-thread loop does: the same outputs, bit for bit."""
    z0s, coeffs = _scen(dev, 1024, seed=7)
    ins = lane_inputs(z0s, coeffs, MPCParams().astype(torch.float32, dev),
                      LONG)
    before = solve_mega.launches
    lock = solve_mega.solve_mega_cuda(*ins, LONG, lockstep=True)
    thread = solve_mega.solve_mega_cuda(*ins, LONG)
    torch.cuda.synchronize()
    assert solve_mega.launches == before + 2
    for a, b in zip(lock, thread):
        assert torch.equal(a, b)


def test_long_horizon_compact_engaged(dev):
    """batch_solve_lane at N = 48 on the card runs the compact schedule:
    observed engaged (two kernel launches, a 1024-lane tail), converged,
    and at the gates against the plain compact schedule."""
    B = 16384
    z0s, coeffs = _scen(dev, B, seed=6)
    p = MPCParams().astype(torch.float32, dev)
    before = (solve_mega.launches, solve_mega.passes, solve_mega.tail_lanes)
    res = batch_solve_lane(z0s, coeffs, p, LONG)
    torch.cuda.synchronize()
    assert (solve_mega.launches - before[0], solve_mega.passes - before[1],
            solve_mega.tail_lanes - before[2]) == (2, 2, 1024)
    assert float(res.converged.float().mean()) >= 0.99
    ins = lane_inputs(z0s, coeffs, p, LONG)
    plain = solve_mega.solve_mega_scheduled(*ins, LONG, plain=True)
    g = parity_gates(res.us.cpu(), res.cost.cpu(), res.converged.cpu(),
                     res.n_iters.cpu(), plain[1].permute(2, 0, 1).cpu(),
                     plain[2].cpu(), plain[3].cpu(), plain[4].cpu(), 48)
    assert g["ok"], g


# K1 stages (e)-(g): the new variants of the solve kernel
NEW_VARIANTS = ["blobs_gn", "blobs_ddp", "bicycle_exact", "bicycle_fast_lf",
                "refs", "blobs_refs"]


def _variant_inputs(dev, variant, B, seed=8):
    """(config, kernel inputs, blobs, refs) of one new variant: blobs in
    `bench.py`'s layout (K=4), per-lane ramp profiles, the bicycle with
    the default or a per-lane wheelbase."""
    from mpc_ros_tpu_torch.models.obstacles import GaussianObstacles
    from mpc_ros_tpu_torch.testing import numpy_blobs, numpy_refs

    cfg = {"blobs_gn": dataclasses.replace(PROD, ddp=False, ls_iters=8),
           "bicycle_exact": dataclasses.replace(PROD, model="bicycle",
                                                trig="exact"),
           "bicycle_fast_lf": dataclasses.replace(PROD, model="bicycle",
                                                  trig="fast"),
           }.get(variant, PROD)
    leaves = ({"lf": torch.linspace(0.3, 0.8, B)}
              if variant == "bicycle_fast_lf" else {})
    p = MPCParams(**leaves).astype(torch.float32, dev)
    z0s, coeffs = _scen(dev, B, seed)
    ins = lane_inputs(z0s, coeffs, p, cfg)

    def t(a):
        return torch.tensor(a, dtype=torch.float32, device=dev)

    blobs = (GaussianObstacles.from_sigmas(
        *(t(a) for a in numpy_blobs(seed, B))).lane()
        if "blobs" in variant else None)
    refs = (t(numpy_refs(seed, B, cfg.n_steps)).permute(1, 2, 0)
            .contiguous() if "refs" in variant else None)
    return cfg, ins, blobs, refs


@pytest.mark.parametrize("B", [1024, 8192])
@pytest.mark.parametrize("variant", NEW_VARIANTS)
def test_new_kernel_variants_match_plain(dev, variant, B):
    """Blobs (GN and gated DDP), the bicycle (exact trig; fast trig with a
    per-lane wheelbase), a setpoint profile, and blobs with a profile:
    the kernel against its plain version at the `kernel_verify` gates."""
    cfg, ins, blobs, refs = _variant_inputs(dev, variant, B)
    before = solve_mega.launches
    k = solve_mega.solve_mega_cuda(*ins, cfg, blobs=blobs, refs=refs)
    p = solve_mega.solve_mega_plain(*ins, cfg, blobs=blobs, refs=refs)
    torch.cuda.synchronize()
    assert solve_mega.launches == before + 1
    g = _gates(k, p, cfg.n_steps)
    assert g["ok"], g


@pytest.mark.parametrize("variant", ["blobs_ddp", "bicycle_fast_lf"])
def test_blobs_and_bicycle_dispatch(dev, variant):
    """With blobs or the bicycle, "pallas" on CUDA tensors runs the XLA
    lane path (neither K4 nor K5 launches), and "auto" launches K1 once
    per solve."""
    from mpc_ros_tpu_torch.models.obstacles import GaussianObstacles

    cfg, ins, bl, _ = _variant_inputs(dev, variant, 1024)
    z0s, coeffs = _scen(dev, 1024, seed=8)
    p = MPCParams(**({"lf": torch.linspace(0.3, 0.8, 1024)}
                     if variant == "bicycle_fast_lf" else {})).astype(
        torch.float32, dev)
    blobs = (None if bl is None else GaussianObstacles(
        *(a.transpose(0, 1) for a in bl)))
    before = _launch_counts()
    res = batch_solve_lane(z0s, coeffs, p, cfg, blobs=blobs)
    torch.cuda.synchronize()
    assert _launch_counts() == (before[0] + 1, before[1], before[2])
    assert res.us.is_cuda and bool(torch.isfinite(res.us).all())
    route = dataclasses.replace(cfg, backward="pallas", ddp="auto",
                                ls_iters=None)
    res = batch_solve_lane(z0s, coeffs, p, route, blobs=blobs)
    torch.cuda.synchronize()
    assert _launch_counts() == (before[0] + 1, before[1], before[2])
    assert res.us.is_cuda and bool(torch.isfinite(res.us).all())


def test_refs_and_blobs_through_the_schedules(dev):
    """The sorted (N=30) and compact (N=48) schedules with per-lane blobs
    and profiles, kernel passes against plain passes, at the gates (the
    compact rule for compact)."""
    from mpc_ros_tpu_torch.models.obstacles import GaussianObstacles
    from mpc_ros_tpu_torch.testing import numpy_blobs, numpy_refs

    B = 2048
    for cfg, compact in (
            (dataclasses.replace(PROD, schedule="sorted", presolve_iters=3),
             False), (LONG, True)):
        z0s, coeffs = _scen(dev, B, seed=9)
        ins = lane_inputs(z0s, coeffs, MPCParams().astype(torch.float32,
                                                          dev), cfg)
        t = lambda a: torch.tensor(a, dtype=torch.float32, device=dev)
        blobs = GaussianObstacles.from_sigmas(
            *(t(a) for a in numpy_blobs(9, B))).lane()
        refs = t(numpy_refs(9, B, cfg.n_steps)).permute(1, 2, 0).contiguous()
        before = (solve_mega.launches, solve_mega.passes)
        k = solve_mega.solve_mega_scheduled(*ins, cfg, blobs=blobs,
                                            refs=refs)
        assert (solve_mega.launches - before[0],
                solve_mega.passes - before[1]) == (2, 2)
        p = solve_mega.solve_mega_scheduled(*ins, cfg, plain=True,
                                            blobs=blobs, refs=refs)
        torch.cuda.synchronize()
        g = parity_gates(k[1].permute(2, 0, 1).cpu(), k[2].cpu(),
                         k[3].cpu(), k[4].cpu(), p[1].permute(2, 0, 1).cpu(),
                         p[2].cpu(), p[3].cpu(), p[4].cpu(), cfg.n_steps,
                         compact=compact)
        assert g["ok"], g


# the route's matching variant of the whole-solve kernel: GN, 8 candidates,
# exact trig, the adaptive scale off
ROUTE_MEGA = SolverConfig(n_steps=30, max_sqp_iters=12, tol_grad=1e-4,
                          ddp=False, ls_iters=8, trig="exact",
                          scale_adaptive=False, backward="mega")


@pytest.mark.parametrize("variant", ["route_mega", "blobs_tile",
                                     "blobs_refs_tile"])
def test_remaining_variants_match_plain(dev, variant):
    """The variants no other test holds at B=8192: the route's matching
    variant, and the per-block exit (done_frac = 0.97) with blobs and with
    blobs and a profile, against the plain version on the same tiles (the
    numerics over the lanes converged on both sides, as phase 9 of
    chip_smoke.py holds them)."""
    B = 8192
    if variant == "route_mega":
        cfg, blobs, refs = ROUTE_MEGA, None, None
        z0s, coeffs = _scen(dev, B, seed=10)
        ins = lane_inputs(z0s, coeffs, MPCParams().astype(torch.float32,
                                                          dev), cfg)
    else:
        base = "blobs_refs" if "refs" in variant else "blobs_ddp"
        cfg, ins, blobs, refs = _variant_inputs(dev, base, B)
        cfg = dataclasses.replace(cfg, done_frac=0.97)
    k = solve_mega.solve_mega_cuda(*ins, cfg, blobs=blobs, refs=refs)
    p = solve_mega.solve_mega_plain(*ins, cfg, blobs=blobs, refs=refs)
    torch.cuda.synchronize()
    both = ((k[3] > 0.5) & (p[3] > 0.5)).cpu().numpy()
    g = parity_gates(k[1].permute(2, 0, 1).cpu(), k[2].cpu(), k[3].cpu(),
                     k[4].cpu(), p[1].permute(2, 0, 1).cpu(), p[2].cpu(),
                     p[3].cpu(), p[4].cpu(), cfg.n_steps,
                     lanes=None if variant == "route_mega" else both)
    assert g["ok"], g


def test_builds_have_no_spills_and_fit_shared_memory(dev):
    """The 17 (kernel, variant) pairs chip_smoke.py builds, and the line
    search at n_alpha = 3, build for sm_90a with no spills; each K1
    variant's knot ring fits a block's shared memory (227 KB) with at
    least two blocks resident per SM, and the line search's with three."""
    import re

    import chip_smoke
    from mpc_ros_tpu_torch.kernels import _build

    # every (kernel, variant) pair chip_smoke.py builds: the 15 variants of
    # the whole-solve kernel (n_ls, ddp, fast, adaptive, tile_exit, blobs,
    # setp, bicycle), the fused backward and the line search
    pairs = sorted(chip_smoke.build_pairs())
    assert len(pairs) == 17
    builds = _build.build_many(pairs + [("forward", (3,))])
    for key, (_, lines) in builds.items():
        spills = [int(n) for ln in lines
                  for n in re.findall(r"(\d+) bytes spill", ln)]
        assert spills, (key, lines)
        assert not any(spills), (key, lines)
    for v in (v for k, v in pairs if k == "solve_mega"):
        occ = solve_mega.occupancy(v)
        assert 0 < occ["smem_bytes_per_block"] <= 232448, (v, occ)
        assert occ["blocks_per_sm"] >= 2, (v, occ)
    for n_alpha in (8, 3):
        occ = forward.occupancy(n_alpha)
        assert occ["smem_bytes_per_block"] == 43008, occ
        assert occ["blocks_per_sm"] >= 3, occ


def test_diag_reads_the_last_line_search(dev):
    """The line-search diagnostic on the card holds what the plain
    version's holds: each lane's last alpha and cost before the step,
    and candidate costs within f32 rounding."""
    z0s, coeffs = _scen(dev, 1024, seed=8)
    ins = lane_inputs(z0s, coeffs, MPCParams().astype(torch.float32, dev),
                      PROD)
    dk = torch.full((6, 1024), float("nan"), device=dev)
    dp = dk.clone()
    k = solve_mega.solve_mega_cuda(*ins, PROD, diag=dk)
    p = solve_mega.solve_mega_plain(*ins, PROD, diag=dp)
    torch.cuda.synchronize()
    same = (k[4] == p[4]) & (k[3] == p[3])
    assert float(same.float().mean()) >= 0.99
    rel = ((dk - dp).abs() / (1.0 + dp.abs()))[:, same]
    assert float(rel[:5].max()) <= 1e-4
    assert float((dk[5, same] == dp[5, same]).float().mean()) >= 0.99


@pytest.mark.parametrize("route", ["batch_solve", "refs_fallback"])
def test_generic_engine_stays_on_the_card(dev, route):
    """`engine.batch_solve` (the batch-first `ilqr.solve`) on CUDA tensors
    computes on the card and agrees with the XLA lane path at the parity
    gates; per-knot profiles off the kernel rule (B=1,000) take the same
    engine and launch no kernel."""
    from mpc_ros_tpu_torch.engine import batch_solve

    B = 1024 if route == "batch_solve" else 1000
    z0s, coeffs = _scen(dev, B, seed=9)
    p = MPCParams().astype(torch.float32, dev)
    if route == "batch_solve":
        res = batch_solve(z0s, coeffs, p, PROD)
        ref = batch_solve_lane(z0s, coeffs, p,
                               dataclasses.replace(PROD, backward="xla"))
    else:
        refs = torch.tensor(numpy_refs(9, B, PROD.n_steps),
                            dtype=torch.float32, device=dev)
        before = solve_mega.launches
        res = batch_solve_lane(z0s, coeffs, p, PROD, refs=refs)
        assert solve_mega.launches == before
        ref = batch_solve(z0s, coeffs, p, PROD, refs=refs)
    assert res.us.is_cuda and res.cost.is_cuda
    g = parity_gates(res.us.cpu(), res.cost.cpu(), res.converged.cpu(),
                     res.n_iters.cpu(), ref.us.cpu(), ref.cost.cpu(),
                     ref.converged.cpu(), ref.n_iters.cpu(), PROD.n_steps)
    assert g["ok"], g


# The single-robot closed loop on the card (float32, the planner's and the
# tracker's configurations of tests/test_closed_loop.py and
# tests/test_trajectory_tracking.py) within the JAX envelopes.
LOOP = dict(dt=0.1, ref_vel=0.5, max_angvel=1.5, w_cte=300.0,
            w_angvel_d=10.0, w_accel_d=10.0)


@pytest.mark.parametrize("shape,max_cycles,mean_bar,max_bar", [
    ("infinity", 1200, 0.08, 0.25),
    ("epitrochoid", 2500, 0.10, 0.40),
    ("square", 1500, 0.08, 0.50),
])
def test_closed_loop_courses_on_the_card(dev, shape, max_cycles, mean_bar,
                                         max_bar):
    import numpy as np

    from mpc_ros_tpu_torch.config import PlannerConfig
    from mpc_ros_tpu_torch.planner import MPCPlanner
    from mpc_ros_tpu_torch.sim import get_shape, run_closed_loop

    plan = get_shape(shape)
    planner = MPCPlanner(MPCParams(**LOOP), SolverConfig(n_steps=20),
                         PlannerConfig(local_plan_length=2.5), device=dev)
    before = solve_mega.launches
    res = run_closed_loop(planner, plan, max_cycles=max_cycles)
    assert res.reached, f"{shape}: goal not reached in {max_cycles} cycles"
    d = np.array([np.min(np.hypot(plan[:, 0] - q[0], plan[:, 1] - q[1]))
                  for q in res.poses])
    assert d.mean() < mean_bar and d.max() < max_bar, (d.mean(), d.max())
    assert np.all(np.isfinite(res.records))
    assert planner.tracker._warm_dev.is_cuda
    assert solve_mega.launches == before


@pytest.mark.parametrize("shape,speed,mean_bar,max_bar", [
    ("infinity", 0.4, 0.25, 0.55),
    ("epitrochoid", 0.35, 0.25, 0.60),
    ("square", 0.35, 0.30, 0.80),
])
def test_timed_courses_on_the_card(dev, shape, speed, mean_bar, max_bar):
    import numpy as np

    from mpc_ros_tpu_torch.config import PlannerConfig
    from mpc_ros_tpu_torch.planner import TimedTrajectory, TrajectoryTracker
    from mpc_ros_tpu_torch.sim import get_shape
    from mpc_ros_tpu_torch.sim.simulator import run_trajectory_tracking

    traj = TimedTrajectory.from_path(get_shape(shape), speed)
    tracker = TrajectoryTracker(
        MPCParams(**{k: v for k, v in LOOP.items() if k != "ref_vel"}),
        SolverConfig(n_steps=20), PlannerConfig(local_plan_length=2.5),
        device=dev)
    res = run_trajectory_tracking(tracker, traj, max_cycles=4000)
    assert res.reached, f"{shape}: schedule end not reached"
    d = res.dist_to_ref
    assert d.mean() < mean_bar and d.max() < max_bar, (d.mean(), d.max())
    assert res.course_time_s < 1.15 * traj.duration + 2.0
    assert np.all(np.isfinite(res.records))
    assert tracker._warm_dev.is_cuda


# Fleet serving on the card (float32, N=20, 128 robots: one K1 launch per
# cycle for the whole fleet), the fleet of tests/test_fleet.py.
FLEET = dict(max_angvel=1.5, w_cte=300.0, w_angvel_d=10.0, w_accel_d=10.0)


def _fleet(kind, dev, B, **kw):
    from mpc_ros_tpu_torch.config import PlannerConfig
    from mpc_ros_tpu_torch.planner import DeviceFleetPlanner, FleetPlanner

    cls = DeviceFleetPlanner if kind == "device" else FleetPlanner
    fp = cls(MPCParams(**FLEET), SolverConfig(n_steps=20),
             PlannerConfig(local_plan_length=2.5), device=dev, **kw)
    fp.initialize(B)
    return fp


def test_fleet_reaches_every_goal_through_the_kernel(dev):
    """128 robots on the three courses (offset copies) reach every goal
    within xy_goal_tolerance, one K1 launch per cycle with a tracking
    robot."""
    import numpy as np

    from mpc_ros_tpu_torch.testing import fleet_courses, step_poses

    B = 128
    fp = _fleet("host", dev, B)
    plans = fleet_courses(B, ("infinity", "epitrochoid", "square"))
    poses = np.stack([p[0] for p in plans]).astype(float)
    assert fp.set_plans(plans, poses).all()
    fb = np.zeros((B, 2))
    done = np.zeros(B, bool)
    before, tracking_cycles = solve_mega.launches, 0
    for _ in range(2500):
        done |= fp.is_goal_reached(poses, fb)
        if done.all():
            break
        ok, cmds, info = fp.compute_velocity_commands(poses, fb)
        tracking_cycles += bool(np.isfinite(info.cost).any())
        assert np.isfinite(cmds).all()
        cmds[~(ok & ~done)] = 0.0
        fb = step_poses(poses, cmds, 0.1)
    assert done.all(), int(done.sum())
    goals = np.stack([p[-1] for p in plans])
    d = np.hypot(*(poses[:, :2] - goals[:, :2]).T)
    assert d.max() <= fp.planner_cfg.limits.xy_goal_tolerance + 1e-9
    assert solve_mega.launches - before == tracking_cycles > 0
    assert fp._warm.is_cuda and fp.params.w_cte.is_cuda


@pytest.mark.parametrize("wire", ["f32", "i16"])
def test_device_fleet_matches_host_on_the_card(dev, wire):
    """The device pipeline against the host pipeline on the card at the
    JAX package's bars (tests/test_fleet_device.py), one K1 launch per
    cycle each."""
    import numpy as np

    from mpc_ros_tpu_torch.testing import fleet_courses, step_poses

    B = 128
    host, fd = _fleet("host", dev, B), _fleet("device", dev, B, wire=wire)
    plans = fleet_courses(B, offset=3.0, stagger=37)
    poses = np.stack([p[0] for p in plans]).astype(float)
    for fp in (host, fd):
        assert fp.set_plans(plans, poses).all()
    fb = np.zeros((B, 2))
    for cyc in range(10):
        before = solve_mega.launches
        _, c_h, i_h = host.compute_velocity_commands(poses, fb)
        _, c_d, i_d = fd.compute_velocity_commands(poses, fb)
        assert solve_mega.launches - before == 2
        np.testing.assert_array_equal(i_h.states, i_d.states)
        dcur = np.abs(host._start - fd._carry["start"].cpu().numpy())
        dcmd = np.abs(c_h - c_d).max(axis=1)
        if wire == "f32":
            assert dcur.max() == 0 and dcmd.max() < 2e-3, (cyc, dcmd.max())
            tr = i_h.states == 0
            assert np.nanmax(np.abs(i_h.cte - i_d.cte)[tr]) < 1e-3
            assert np.nanmax(np.abs(i_h.etheta - i_d.etheta)[tr]) < 1e-3
            assert np.nanmax(np.abs(i_h.ref_vel - i_d.ref_vel)[tr]) < 1e-5
        else:
            assert dcur.max() <= 1 and (dcur > 0).sum() <= 3
            assert dcmd[dcur == 0].max() < 3e-3 and dcmd.max() < 3e-2
        fb = step_poses(poses, c_h, 0.1)
    assert fd._carry["warm"].is_cuda


def test_fleet_trajectory_device_pipeline_on_the_card(dev):
    """The fleet trajectory tracker's device pipeline against its host
    pipeline at B=128 (tests/test_trajectory_tracking.py's bars), one K1
    launch with per-knot setpoints (stage (f)) per cycle each."""
    import numpy as np

    from mpc_ros_tpu_torch.config import PlannerConfig
    from mpc_ros_tpu_torch.planner import (FleetTrajectoryTracker,
                                           TimedTrajectory)
    from mpc_ros_tpu_torch.testing import fleet_courses, step_poses

    B = 128
    trajs = [TimedTrajectory.from_path(p[:240], 0.35 + 0.001 * i)
             for i, p in enumerate(fleet_courses(B, offset=3.0))]
    pair = []
    for pipeline in ("host", "device"):
        tr = FleetTrajectoryTracker(
            MPCParams(dt=0.1, **FLEET), SolverConfig(n_steps=20),
            PlannerConfig(local_plan_length=2.5), pipeline=pipeline,
            device=dev)
        tr.set_trajectories(trajs)
        pair.append(tr)
    poses = np.stack([np.r_[t.xy[0], t.yaw[0]] for t in trajs])
    vs = np.zeros(B)
    for cyc in range(10):
        before = solve_mega.launches
        (c_h, l_h), (c_d, l_d) = (tr.compute(cyc * 0.1, poses.copy(), vs)
                                  for tr in pair)
        assert solve_mega.launches - before == 2
        assert np.abs(c_h - c_d).max() < 2e-3, cyc
        assert np.abs(l_h - l_d).max() < 1e-3, cyc
        vs = step_poses(poses, c_h, 0.1)[:, 0]
    assert pair[1]._warm_us.is_cuda


def test_fleet_entry_points_default_to_the_card(dev):
    from mpc_ros_tpu_torch.planner import (DeviceFleetPlanner, FleetPlanner,
                                           FleetTrajectoryTracker)

    for obj in (FleetPlanner(), DeviceFleetPlanner(),
                FleetTrajectoryTracker(MPCParams(), SolverConfig())):
        assert obj.device.type == "cuda" and obj.params.w_cte.is_cuda


# -- grid costmaps, the costmap routes and the supervisors (chip_smoke.py
# phases 32-34 at small B)

@pytest.mark.parametrize("sampling", ["spline_coeff", "spline", "bilinear"])
def test_grid_costmaps_take_the_xla_path_on_the_card(dev, sampling):
    """Grid maps on the card at B=256 (`bench.py --obstacles-grid`'s maps,
    cap 30): no kernel launch (grid maps take the XLA lane path, as in
    JAX) and the same lanes solved on the CPU in float32 within the
    single-pass gates. The spline surfaces converge >= 0.99; bilinear's
    unconverged lanes sit on cell kinks and are cost-converged (the JAX
    package's check, tests/test_obstacle_fit.py:150-158: doubling the cap
    moves their cost by < 0.1%), and a lane converged on one side only
    is held to that cost bar against the CPU in place of the
    convergence-match gates."""
    from mpc_ros_tpu_torch.models.obstacles import gaussian_blob_map

    B = 256
    cfg = dataclasses.replace(PROD, max_sqp_iters=30)
    z, c = _scen(dev, B, seed=32)
    gen = torch.Generator(device=dev).manual_seed(1)
    cen = 0.3 + 0.9 * torch.rand((B, 2), device=dev, generator=gen)
    omaps = gaussian_blob_map((cen[:, 0], cen[:, 1]), sigma=0.3,
                              weight=100.0, sampling=sampling, device=dev)
    p = MPCParams().astype(torch.float32, dev)
    before = _launch_counts()
    res = batch_solve_lane(z, c, p, cfg, omaps=omaps)
    torch.cuda.synchronize()
    assert _launch_counts() == before
    cpu = batch_solve_lane(z.cpu(), c.cpu(), MPCParams(), cfg,
                           omaps=omaps.to(device="cpu"))
    card = [res.us.cpu().numpy(), res.cost.cpu().numpy(),
            res.converged.cpu().numpy(), res.n_iters.cpu().numpy()]
    g = parity_gates(*card, cpu.us.numpy(), cpu.cost.numpy(),
                     cpu.converged.numpy(), cpu.n_iters.numpy(), cfg.n_steps)
    if sampling != "bilinear":
        assert float(res.converged.float().mean()) >= 0.99
        assert g["ok"], g
        return
    bad = ~res.converged
    if bool(bad.any()):
        r60 = batch_solve_lane(z, c, p, dataclasses.replace(
            cfg, max_sqp_iters=60), omaps=omaps)
        rel = ((res.cost - r60.cost).abs() / (1.0 + r60.cost.abs()))[bad]
        assert float(rel.max()) < 1e-3
    one_side = card[2] != cpu.converged.numpy()
    rel = (np.abs(card[1] - cpu.cost.numpy())
           / (1.0 + np.abs(cpu.cost.numpy())))
    lim = g["limits"]
    assert g["max_du"] <= lim["max_du"], g
    assert g["max_rel_dcost"] <= lim["max_rel_dcost"], g
    assert g["iters_match_frac"] >= lim["iters_match_frac"], g
    assert not one_side.any() or float(rel[one_side].max()) < 1e-3


def test_costmap_fleet_launches_k1_once_per_cycle(dev):
    """`FleetPlanner.set_costmaps` every cycle for 128 robots (host maps,
    one pinned upload, the fit on the card): the fitted blobs on the card
    and exactly one K1 launch per cycle, every command finite."""
    from mpc_ros_tpu_torch.config import PlannerConfig
    from mpc_ros_tpu_torch.models.obstacles import gaussian_blob_map
    from mpc_ros_tpu_torch.planner import FleetPlanner
    from mpc_ros_tpu_torch.testing import fleet_courses, step_poses

    B = 128
    plans = fleet_courses(B, offset=10.0, period=64)
    at = torch.tensor(np.stack([pl[40, :2] for pl in plans]),
                      dtype=torch.float32)
    maps = gaussian_blob_map((torch.full((B,), 0.2), torch.zeros(B)),
                             sigma=0.3, weight=50.0)
    maps = maps.replace(origin=maps.origin + at)
    fp = FleetPlanner(MPCParams(max_angvel=1.5, w_cte=300.0,
                                w_angvel_d=10.0, w_accel_d=10.0),
                      SolverConfig(n_steps=20),
                      PlannerConfig(local_plan_length=2.5), device=dev)
    fp.initialize(B)
    poses = np.stack([pl[0] for pl in plans]).astype(float)
    fb = np.zeros((B, 2))
    assert fp.set_plans(plans, poses).all()
    solve_mega.launches = 0
    for _ in range(4):
        fp.set_costmaps(maps)
        _, cmds, _ = fp.compute_velocity_commands(poses, fb)
        assert np.isfinite(cmds).all()
        fb = step_poses(poses, cmds, 0.1)
    assert solve_mega.launches == 4
    assert fp.world_obstacles.cx.is_cuda
    assert tuple(fp.world_obstacles.cx.shape) == (B, 4)


def test_device_fit_matches_host_on_the_card(dev):
    """`fit_gaussians_to_maps` on the card against the host greedy fit at
    the bar of tests/test_obstacle_fit.py:161, the test's own maps."""
    from mpc_ros_tpu_torch.models.obstacles import (ObstacleMap,
                                                    fit_gaussians_to_map,
                                                    fit_gaussians_to_maps,
                                                    gaussian_blob_map)

    ms = [gaussian_blob_map((0.8, 0.5), sigma=0.3, weight=100.0),
          gaussian_blob_map((-0.5, 1.0), sigma=0.5, weight=50.0),
          ObstacleMap.empty()]
    omaps = ObstacleMap(*(torch.stack([getattr(m, f) for m in ms]).to(dev)
                          for f in ("grid", "origin", "resolution",
                                    "weight")))
    fit = fit_gaussians_to_maps(omaps, 4)
    assert fit.cx.is_cuda
    for i, m in enumerate(ms):
        host = fit_gaussians_to_map(m, 4, refine=False)
        for nm, tol in (("cx", 1e-5), ("cy", 1e-5), ("gamma", 5e-4),
                        ("w", 1e-4)):
            h = getattr(host, nm).double()
            d = getattr(fit, nm)[i].double().cpu()
            assert float(((h - d).abs() / (1.0 + h.abs())).max()) < tol


def test_supervisors_recover_on_the_card(dev):
    """tests/test_recovery.py:189's lost-plan case around the card's
    `MPCPlanner`: the ladder replans once, the planner recovers, the
    command is finite and the warm carry stays on the card."""
    from mpc_ros_tpu_torch.config import PlannerConfig
    from mpc_ros_tpu_torch.planner import (MPCPlanner, RecoveryConfig,
                                           RecoveryState, RecoverySupervisor)

    planner = MPCPlanner(MPCParams(),
                         SolverConfig(n_steps=10, max_sqp_iters=8,
                                      backward="xla"),
                         PlannerConfig(), device=dev)
    planner.initialize()
    plan = np.stack([np.linspace(0, 3, 30), np.zeros(30), np.zeros(30)], 1)
    pose = np.array([0.0, 0.05, 0.0])
    sup = RecoverySupervisor(planner, RecoveryConfig(
        failures_to_recover=3, rotate_speed=0.4, rotate_cycles_max=5,
        max_rounds=2))
    assert sup.set_plan(plan, pose)
    ok, cmd, _ = planner.compute_velocity_commands(pose, (0.2, 0.0))
    ok, cmd = sup.on_cycle(ok, cmd, pose, (0.2, 0.0))
    assert ok
    planner.global_plan = None
    for _ in range(3):
        ok, cmd, _ = planner.compute_velocity_commands(pose, (0.2, 0.0))
        ok, cmd = sup.on_cycle(ok, cmd, pose, (0.2, 0.0))
    assert ok and sup.state is RecoveryState.NORMAL
    assert sup.stats.replans == 1 and np.isfinite(cmd).all()
    assert planner.tracker._warm_dev.is_cuda


# The single-robot cycles as captured CUDA graphs (solver/graphed.py)
# against the eager cycles on the card: phase 24's planner and the
# trajectory tracker in lockstep, bit for bit.
def _loop_planner(dev, graphed_cycle):
    from mpc_ros_tpu_torch.config import PlannerConfig
    from mpc_ros_tpu_torch.planner import MPCPlanner

    pl = MPCPlanner(MPCParams(**LOOP), SolverConfig(n_steps=20),
                    PlannerConfig(local_plan_length=2.5), device=dev)
    pl.initialize()
    pl.tracker._graphed = graphed_cycle
    return pl


def test_captured_planner_cycle_equals_eager_on_the_card(dev):
    """20 cycles of phase 24's course, a parameter reload at cycle 8, a
    costmap at 12 and one of the same shape at 16: the captured cycle
    equals the eager one bit for bit; the reload and the second costmap
    capture nothing; replays make no synchronizing call
    (`set_sync_debug_mode("error")` raises on one)."""
    from mpc_ros_tpu_torch.models.obstacles import gaussian_blob_map
    from mpc_ros_tpu_torch.sim import get_shape
    from mpc_ros_tpu_torch.solver import graphed
    from mpc_ros_tpu_torch.testing import lockstep_cycles, records_equal

    plan = get_shape("infinity")
    c = plan[25, :2]
    maps = [gaussian_blob_map((float(c[0]), float(c[1]) + d), sigma=0.3,
                              extent=8.0, weight=50.0) for d in (0.6, 0.5)]
    ours, eager = _loop_planner(dev, True), _loop_planner(dev, False)
    counts = {}

    def note(k):
        def f(pl):
            if pl is ours:
                counts[k] = graphed.captures
        return f

    events = {7: note(7), 8: lambda pl: pl.reconfigure(
        MPCParams(**dict(LOOP, w_cte=250.0, ref_vel=0.45))), 11: note(11),
        12: lambda pl: pl.set_costmap(maps[0]), 15: note(15),
        16: lambda pl: pl.set_costmap(maps[1])}
    a, b = lockstep_cycles([ours, eager], 20, plan=plan, events=events)
    rec = records_equal(a, b)
    assert rec["equal"], rec
    assert counts[11] == counts[7] and counts[15] == counts[11] + 1
    assert graphed.captures == counts[15]
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(3):
            ours.compute_velocity_commands(np.array(plan[3]), (0.3, 0.0))
    finally:
        torch.cuda.set_sync_debug_mode("default")


def test_captured_tracker_cycle_equals_eager_on_the_card(dev):
    from mpc_ros_tpu_torch.config import PlannerConfig
    from mpc_ros_tpu_torch.planner import TimedTrajectory, TrajectoryTracker
    from mpc_ros_tpu_torch.sim import get_shape
    from mpc_ros_tpu_torch.testing import lockstep_cycles, records_equal

    trs = [TrajectoryTracker(
        MPCParams(**{k: v for k, v in LOOP.items() if k != "ref_vel"}),
        SolverConfig(n_steps=20), PlannerConfig(local_plan_length=2.5),
        device=dev) for _ in range(2)]
    trs[1]._graphed = False
    traj = TimedTrajectory.from_path(get_shape("infinity"), 0.4)
    a, b = lockstep_cycles(trs, 20, traj=traj)
    rec = records_equal(a, b)
    assert rec["equal"], rec


# The program's spans (obs.span) on the card.
def _annotations(prof, path):
    """The names of a profiler's `user_annotation` ranges, in start order."""
    import json

    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())
    if isinstance(events, dict):
        events = events["traceEvents"]
    return [e["name"] for e in sorted(
        (e for e in events if e.get("cat") == "user_annotation"
         and e.get("ph") == "X"), key=lambda e: float(e["ts"]))]


def test_traced_serving_call_spans_on_the_card(dev, tmp_path):
    """After a warm-up call of the serving cell's shape (131,072 robots,
    N=30, 10 cycles), one traced call shows one `k1.dispatch` (holding
    `k1.prepare` and `k1.launch`) per cycle, and no kernel build and no
    graph capture."""
    from torch.profiler import ProfilerActivity, profile

    cycles = 10
    z0s, coeffs = _scen(dev, 131072, seed=3)
    p = MPCParams.reference_defaults().astype(torch.float32, dev)
    receding_horizon_rollout(z0s, coeffs, p, PROD, n_cycles=cycles)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        receding_horizon_rollout(z0s, coeffs, p, PROD, n_cycles=cycles)
        torch.cuda.synchronize()
    names = _annotations(prof, tmp_path / "trace.json")
    for n in ("serve.cycle", "serve.solve", "k1.dispatch", "k1.prepare",
              "k1.launch", "dispatch.lane_inputs", "dispatch.result"):
        assert names.count(n) == cycles, (n, names.count(n))
    assert names.count("serve.stack") == 1
    assert "kernels.build" not in names and "graphed.capture" not in names


def test_captured_planner_cycle_spans_on_the_card(dev):
    """After its warm-up (the capture), one captured planner cycle under a
    collector (no profiler): one prologue and one epilogue replay, one
    body replay per SQP iteration and a flag read after each but the
    last of a solve that reached the cap; no capture."""
    from mpc_ros_tpu_torch import obs
    from mpc_ros_tpu_torch.sim import get_shape

    plan = get_shape("infinity")
    pl = _loop_planner(dev, True)
    pl.set_plan(plan, np.array(plan[0]))
    for _ in range(3):
        ok, _, _ = pl.compute_velocity_commands(np.array(plan[0]),
                                                (0.0, 0.0))
    with obs.collect(obs.PhaseTimers()) as tm:
        ok, _, info = pl.compute_velocity_commands(np.array(plan[0]),
                                                   (0.0, 0.0))
    assert ok and info.tracking is not None
    assert info.tracking.solve is not None
    n = int(info.tracking.solve.n_iters)
    cap = pl.solver_cfg.max_sqp_iters
    c = {k: v["count"] for k, v in tm.summary().items()}
    assert c["planner.cycle"] == c["planner.track"] == 1
    assert c["graphed.prologue"] == c["graphed.epilogue"] == 1
    assert c["graphed.body"] == n
    assert c["sync.graphed_flag"] == (n if n < cap else n - 1)
    assert "graphed.capture" not in c and "kernels.build" not in c
