"""K1 on its persistent grid, where a thread whose lane is done takes the
next one, held bit for bit against one thread per lane and the lockstep
loop on the card (marker `cuda`; they skip without one): cold, warm and
resumed batches at the benchmark's weights (lanes at the SQP cap
included) from below the card's resident threads to sixteen times them,
the variants, and the fixtures whose done lanes blend while their tile
runs, which the grid solves again by tile (`retiled_tiles`). Run on the
card with `python -m pytest --noconftest tests/test_torch_k1_refill.py`.
"""

import dataclasses

import pytest
import torch

from mpc_ros_tpu_torch.config import MPCParams, SolverConfig
from mpc_ros_tpu_torch.engine import make_random_scenarios
from mpc_ros_tpu_torch.kernels import solve_mega
from mpc_ros_tpu_torch.models.obstacles import GaussianObstacles
from mpc_ros_tpu_torch.solver.batch_lane import lane_inputs
from mpc_ros_tpu_torch.testing import (k1_grid, next_backward_witness,
                                       numpy_blobs, numpy_refs,
                                       plant_nonfinite)

pytestmark = pytest.mark.cuda

# the benchmark's solver and weights (benchmark/configs/ref_nlp_n30.json)
CFG = SolverConfig(n_steps=30, max_sqp_iters=12, ls_iters=4, ddp=True,
                   tol_grad=1e-4, mu_init=1e-6, ddp_gate=2.5)
# a grid of 32 blocks: eight or more lanes per thread at small batches
SMALL_GRID = 32 * solve_mega.TILE


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _full_grid(dev):
    variant = solve_mega.resolve_knobs(CFG, torch.float32).variant
    blocks, n_sm = solve_mega._residency(variant, dev)
    return blocks * n_sm * solve_mega.TILE


def _inputs(dev, B, seed, cfg=CFG, params=None):
    g = torch.Generator(device=dev).manual_seed(seed)
    z0s, coeffs = make_random_scenarios(g, B)
    p = (params or MPCParams.reference_defaults()).astype(torch.float32, dev)
    return lane_inputs(z0s, coeffs, p, cfg)


def _bits_equal(x, y):
    return all(torch.equal(a.view(torch.int32), b.view(torch.int32))
               for a, b in zip(x, y))


def _both(ins, cfg, slots, **kw):
    """The grid's outputs and counts, and one thread per lane's."""
    with k1_grid(slots):
        grid = solve_mega.solve_mega_cuda(*ins, cfg, **kw)
    counts = (int(solve_mega.refilled_lanes), int(solve_mega.retiled_tiles))
    with k1_grid(0):
        lane = solve_mega.solve_mega_cuda(*ins, cfg, **kw)
    assert (solve_mega.refilled_lanes, solve_mega.retiled_tiles) == (0, 0)
    return grid, lane, counts


@pytest.mark.parametrize("size", ["below", "one", "sixteen", "ragged"])
@pytest.mark.parametrize("start", ["cold", "warm", "resume"])
def test_grid_equals_one_lane_per_thread_and_lockstep(dev, start, size):
    """The persistent grid at full residency against one thread per lane
    and (B % 128 == 0) the lockstep loop, every output bit for bit: B
    under the grid's threads, about one and sixteen times them, and a B
    that is not whole tiles; cold, warm-started (the cold controls shifted
    by a knot) and resumed (a 3-iteration pass, every seventh lane
    re-armed)."""
    slots = _full_grid(dev)
    B = {"below": 8192, "one": slots, "sixteen": 16 * slots,
         "ragged": 2 * slots + 77}[size]
    ins = _inputs(dev, B, seed=len(start) * 100 + B % 997)
    resume = None
    if start != "cold":
        first = solve_mega.solve_mega_cuda(
            *ins, dataclasses.replace(CFG, max_sqp_iters=3
                                      if start == "resume" else 12))
        if start == "warm":
            us = first[1]
            ins = ins[:5] + (torch.cat([us[1:], us[-1:]]).contiguous(),)
        else:
            done = first[7].clone()
            done[::7] = 0.0
            resume = (done, first[3], first[6], first[5])
            ins = ins[:5] + (first[1],)
    grid, lane, (refilled, retiled) = _both(ins, CFG, slots, resume=resume)
    assert _bits_equal(grid, lane)
    assert refilled == max(0, B - slots)
    if B % solve_mega.TILE == 0:
        lock = solve_mega.solve_mega_cuda(*ins, CFG, resume=resume,
                                          lockstep=True)
        assert _bits_equal(grid, lock)
    if start == "cold":
        assert retiled == 0
        if size == "sixteen":
            assert int((lane[4] == CFG.max_sqp_iters).sum()) > 0


def test_shape_rule_engages_the_grid(dev):
    """By the shape rule and the last call's pacing: the benchmark's cold
    batch (524,288 lanes, the cfg's weights) runs its first call one
    thread per lane and the next ones on the persistent grid; a batch of
    the same shape at `MPCParams()`'s weights, whose tiles wait little on
    their slowest lanes, goes back to one thread per lane after one call
    on the verdict before it; a fleet's 8,192 lanes never take the
    grid."""
    slots = _full_grid(dev)
    assert slots == solve_mega.refill_slots(
        524288, *solve_mega._residency(
            solve_mega.resolve_knobs(CFG, torch.float32).variant, dev))
    solve_mega._PACE.clear()
    cold = _inputs(dev, 524288, 3)
    counts = []
    for _ in range(3):
        out = solve_mega.solve_mega_cuda(*cold, CFG)
        torch.cuda.synchronize()
        counts.append((int(solve_mega.refilled_lanes),
                       int(solve_mega.retiled_tiles)))
    assert counts == [(0, 0)] + [(524288 - slots, 0)] * 2
    assert float(solve_mega.pace(out[4])) >= solve_mega.GRID_PACE
    soft = _inputs(dev, 524288, 4, params=MPCParams())
    counts = []
    for _ in range(3):
        out = solve_mega.solve_mega_cuda(*soft, CFG)
        torch.cuda.synchronize()
        counts.append(int(solve_mega.refilled_lanes))
    assert counts == [524288 - slots, 0, 0]
    assert float(solve_mega.pace(out[4])) < solve_mega.GRID_PACE
    for _ in range(2):
        solve_mega.solve_mega_cuda(*_inputs(dev, 8192, 4), CFG)
        torch.cuda.synchronize()
        assert solve_mega.refilled_lanes == 0


@pytest.mark.parametrize("variant", ["exact", "bicycle", "blobs", "setp",
                                     "blobs_setp", "gn8"])
def test_grid_variants_equal_one_lane_per_thread(dev, variant):
    """The exact-trig, bicycle (per-lane wheelbase), blob, setpoint and
    8-candidate GN variants on a 32-block grid, 8 lanes per thread: bit
    for bit one thread per lane."""
    B = 8 * SMALL_GRID
    cfg = {"exact": dataclasses.replace(CFG, trig="exact"),
           "bicycle": dataclasses.replace(CFG, model="bicycle"),
           "gn8": dataclasses.replace(CFG, ddp=False, ls_iters=8,
                                      scale_adaptive=False)}.get(variant, CFG)
    params = (MPCParams(lf=torch.linspace(0.3, 0.8, B))
              if variant == "bicycle" else MPCParams())
    ins = _inputs(dev, B, 21, cfg, params)

    def t(a):
        return torch.tensor(a, dtype=torch.float32, device=dev)

    blobs = (GaussianObstacles.from_sigmas(*(t(a) for a in numpy_blobs(
        21, B))).lane() if "blobs" in variant else None)
    refs = (t(numpy_refs(21, B, cfg.n_steps)).permute(1, 2, 0).contiguous()
            if "setp" in variant else None)
    grid, lane, (refilled, retiled) = _both(ins, cfg, SMALL_GRID,
                                            blobs=blobs, refs=refs)
    assert _bits_equal(grid, lane)
    assert (refilled, retiled) == (B - SMALL_GRID, 0)


def _tiled(ins, n):
    return tuple(torch.cat([a] * n, dim=-1).contiguous() for a in ins)


@pytest.mark.parametrize("fixture", ["nonfinite", "done_early", "witness"])
def test_grid_blends_done_lanes_as_their_tile(dev, fixture):
    """Lanes planted with NaN, inf and an overflowing coefficient (some
    resumed done beside running ones), and the next-backward witness,
    repeated over 64 tiles on a 32-block grid: bit for bit one thread per
    lane. A done lane that blends while its tile runs sends its tile to
    the second solve, so the fixtures with such lanes count re-solved
    tiles; the clean batch of the planted inputs counts none."""
    B = 64 * solve_mega.TILE
    resume = None
    cfg = CFG
    if fixture == "witness":
        ins, cfg = next_backward_witness(torch.float32, dev)
        ins = _tiled(ins, 64)
    else:
        clean = _inputs(dev, B, 12, params=MPCParams())
        _, _, (_, clean_retiled) = _both(clean, cfg, SMALL_GRID)
        assert clean_retiled == 0
        lanes = [5 + 131 * i for i in range(60)]
        planted = plant_nonfinite({"z": clean[0], "coeffs": clean[1]}, lanes)
        ins = (planted["z"], planted["coeffs"]) + tuple(clean[2:])
        if fixture == "done_early":
            done = torch.zeros(B, device=dev)
            done[lanes[::2] + [9, 60, 1000, 4000]] = 1.0
            resume = (done, torch.zeros_like(done),
                      torch.full_like(done, 1e-6),
                      torch.full_like(done, float("inf")))
    grid, lane, (refilled, retiled) = _both(ins, cfg, SMALL_GRID,
                                            resume=resume)
    assert _bits_equal(grid, lane)
    assert refilled == B - SMALL_GRID
    assert any(bool(a.isnan().any()) for a in lane)
    if fixture != "nonfinite":
        assert retiled > 0
