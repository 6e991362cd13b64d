"""K1's persistent grid on the CPU, and the shape rule that engages it.

`csrc/solve_mega.cu` is compiled with g++ behind host stand-ins for the
CUDA runtime (`tests/cuda_emulation`: each block's threads are std::threads,
each warp one thread wide) and called with `solve_mega`'s own buffers. The
persistent grid, where a thread whose lane is done takes the next one, is
held bit for bit against the same source's one-thread-per-lane launch and
its lockstep loop. With one-thread warps this checks the slot-indexed
working set, the order of claims, the tiles' bookkeeping and their second
solve; the warp-aggregated claim, the `alive` ballot and the probe beside
running warp-mates run only on the card (`tests/test_torch_k1_refill.py`).
The cases: cold, warm and resumed batches at the benchmark's
weights, the blob, setpoint and bicycle variants, copies that land as late
as the card may let them, and the fixtures whose done lanes blend while
their tile runs (which the grid's second kernel solves again by tile). The
grid's counts, `refilled_lanes` and `retiled_tiles`, are checked with them.
The per-tile exit's blocks started at another tile (`solve_mega.tile_shift`)
solve the same tiles bit for bit.
"""

import ctypes
import dataclasses
import re
import shutil
import subprocess
from pathlib import Path

import pytest
import torch

from mpc_ros_tpu_torch.config import MPCParams, SolverConfig
from mpc_ros_tpu_torch.engine import make_random_scenarios
from mpc_ros_tpu_torch.kernels import _build, solve_mega
from mpc_ros_tpu_torch.models.obstacles import GaussianObstacles
from mpc_ros_tpu_torch.solver.batch_lane import lane_inputs
from mpc_ros_tpu_torch.testing import (k1_grid, next_backward_witness,
                                       numpy_blobs, numpy_refs,
                                       plant_nonfinite)

EMULATION = Path(__file__).resolve().parent / "cuda_emulation"
# the benchmark's solver and weights (benchmark/configs/ref_nlp_n30.json)
CFG = SolverConfig(n_steps=30, max_sqp_iters=12, ls_iters=4, ddp=True,
                   tol_grad=1e-4, mu_init=1e-6, ddp_gate=2.5)
# a one-block grid over a batch that is not whole tiles: 7.8 lanes a thread
SLOTS, B = 128, 1000


def _variant(cfg, blobs=None, refs=None, lockstep=False):
    kn = solve_mega._knobs_for(cfg, torch.float32, blobs, refs)
    return dataclasses.replace(kn, lockstep=lockstep)


VARIANTS = {
    "prod": (_variant(CFG).variant, False),
    "late": (_variant(CFG).variant, True),
    "lockstep": (_variant(CFG, lockstep=True).variant, False),
    "extras": ((4, True, True, True, False, True, True, False), False),
    "bicycle": (_variant(dataclasses.replace(
        CFG, model="bicycle", trig="exact")).variant, False),
}


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    """Every variant the tests launch, compiled at once (one g++ each)."""
    out = tmp_path_factory.mktemp("k1_emulated")
    src = re.sub(r"(\w+)<<<(.*?)>>>\((\w+)\);", r"emu_launch(\1, \2, \3);",
                 (_build.CSRC / "solve_mega.cu").read_text(), flags=re.S)
    (out / "solve_mega.cpp").write_text(src)
    shutil.copy(_build.CSRC / "tiles.cuh", out)
    shutil.copy(EMULATION / "async_copy.cuh", out)
    jobs = {}
    for name, (variant, late) in VARIANTS.items():
        flags = [f for f in _build.KERNELS["solve_mega"].flags(variant)
                 if f.startswith("-D")] + (["-DEMU_LATE"] if late else [])
        so = out / f"{name}.so"
        jobs[name] = (so, subprocess.Popen(
            ["g++", "-std=c++20", "-O1", "-ffp-contract=off", "-pthread",
             "-shared", "-fPIC", "-I", str(EMULATION), *flags,
             str(out / "solve_mega.cpp"), "-o", str(so)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    built = {}
    for name, (so, proc) in jobs.items():
        log, _ = proc.communicate()
        assert proc.returncode == 0, log[-4000:]
        lib = ctypes.CDLL(str(so))
        fn = lib.mpc_solve_mega_f32
        fn.argtypes = list(_build.KERNELS["solve_mega"].argtypes)
        fn.restype = ctypes.c_int
        built[name] = fn
    return built


def _launch(fn, ins, cfg, slots, resume=None, blobs=None, refs=None,
            lockstep=False, shift=0, err_want=0):
    """One launch as `solve_mega._cuda_launch` makes it, on CPU tensors:
    the outputs (NaN-filled, so that a lane left unwritten shows) and the
    grid's counts (refilled lanes, re-solved tiles). `shift`: the tile the
    per-tile exit's blocks start at; `err_want`: the launcher's return."""
    kn = _variant(cfg, blobs, refs, lockstep)
    ins = [a.contiguous() for a in ins]
    T, Bn, P = kn.T, ins[0].shape[-1], ins[1].shape[0]
    res = None if resume is None else torch.stack(list(resume))
    opt = [res, refs] + ([None] * 4 if blobs is None else list(blobs))
    ss, us, outs = solve_mega.outputs(T, Bn, slots, "cpu")
    for o in [ss, us] + outs:
        o.fill_(float("nan"))
    scratch = [torch.empty(s) for s in solve_mega.scratch_shapes(
        T, kn.n_ls, slots or Bn)]
    work = tiles = None
    if slots:
        work = torch.empty(solve_mega.work_rows(T, kn.n_blobs, kn.has_setp),
                           slots)
        tiles = torch.full((solve_mega.tile_words(Bn),), -1,
                           dtype=torch.int32)

    def p(a):
        return ctypes.c_void_p(None if a is None else a.data_ptr())

    err = fn(*[p(a) for a in ins + opt + [ss, us] + outs + [None] + scratch
               + [work, tiles]],
             P, Bn, T, kn.max_iters, kn.n_done_needed, kn.n_blobs, slots,
             shift, kn.sign, kn.tol_grad, kn.tol_cost_eff, kn.mu_min, kn.mu_max,
             kn.mu_factor, kn.ddp_gate, *(int(v) for v in kn.variant), None)
    assert err == err_want, err
    counts = (0, 0) if tiles is None else (int(tiles[1]), int(tiles[2]))
    return (ss, us, *outs), counts


def _bits_equal(x, y):
    return all(torch.equal(a.contiguous().view(torch.int32),
                           b.contiguous().view(torch.int32))
               for a, b in zip(x, y))


def _inputs(n, seed, cfg=CFG, params=None):
    z0s, coeffs = make_random_scenarios(torch.Generator().manual_seed(seed),
                                        n)
    p = params or MPCParams.reference_defaults()
    return lane_inputs(z0s, coeffs, p.astype(torch.float32,
                                              torch.device("cpu")), cfg)


def test_shape_rule_engages_the_grid_from_the_residency():
    """The persistent grid holds every thread the card keeps resident and
    engages at REFILL_LANES_PER_SLOT lanes a thread: the benchmark's batch
    (524,288 lanes on 132 SMs of 2 blocks) takes it, the serving batch
    (131,072) and a fleet (1,024) do not; a variant that fits no block
    never takes it."""
    slots = 2 * 132 * solve_mega.TILE
    assert solve_mega.REFILL_LANES_PER_SLOT == 8
    assert solve_mega.refill_slots(524288, 2, 132) == slots == 33792
    assert solve_mega.refill_slots(8 * slots, 2, 132) == slots
    assert solve_mega.refill_slots(8 * slots - 1, 2, 132) == 0
    assert solve_mega.refill_slots(131072, 2, 132) == 0
    assert solve_mega.refill_slots(1024, 2, 132) == 0
    assert solve_mega.refill_slots(10 ** 7, 0, 132) == 0
    assert solve_mega.refill_slots(1024, 1, 1) == 128


class _Event:
    def __init__(self, done):
        self.done = done

    def query(self):
        return self.done


def test_grid_pays_where_tiles_wait_on_their_slowest_lanes():
    """The pacing of a call: the mean of each whole tile's most iterations
    over (the mean iterations + 1). The next call of its shape takes the
    grid at GRID_PACE or more; a copy still in flight keeps the verdict
    before it, and a shape not seen yet runs one thread per lane."""
    T = solve_mega.TILE
    iters = torch.cat([torch.full((T - 1,), 4.0), torch.tensor([12.0]),
                       torch.full((T,), 3.0), torch.full((7,), 9.0)])
    want = ((12.0 + 3.0) / 2) / (float(iters.mean()) + 1.0)
    assert abs(float(solve_mega.pace(iters)) - want) < 1e-6
    assert abs(float(solve_mega.pace(torch.full((2 * T,), 5.0))) - 5 / 6) < 1e-6
    assert not solve_mega.grid_pays(None)
    for host, pays in ((1.74, True), (1.5, True), (1.19, False)):
        seen = {"event": _Event(True), "host": torch.tensor(host),
                "pays": not pays}
        assert solve_mega.grid_pays(seen) is pays and seen["pays"] is pays
    seen = {"event": _Event(False), "host": torch.tensor(1.74),
            "pays": False}
    assert not solve_mega.grid_pays(seen)


def test_grid_choice_keys_the_verdict_by_variant_horizon_and_batch(
        monkeypatch):
    """The launcher's choice: a batch the shape rule lets on runs one
    thread per lane until a call of the same variant, horizon and batch
    has paced at GRID_PACE or more, another horizon or batch keeps its own
    verdict, a per-tile exit is never asked, and `testing.k1_grid`
    replaces the choice and puts the rule back."""
    monkeypatch.setattr(solve_mega, "_residency", lambda v, d: (2, 132))
    monkeypatch.setattr(solve_mega, "_PACE", {})
    dev = torch.device("cpu")
    kn = _variant(CFG)
    key, slots = solve_mega._grid_choice(kn, 524288, dev)
    assert slots == 0 and key == (kn.variant, kn.T, 524288, None)
    solve_mega._PACE[key] = {"event": _Event(True),
                             "host": torch.tensor(1.74), "pays": False}
    assert solve_mega._grid_choice(kn, 524288, dev) == (key, 33792)
    longer = _variant(dataclasses.replace(CFG, n_steps=48))
    assert solve_mega._grid_choice(longer, 524288, dev)[1] == 0
    assert solve_mega._grid_choice(kn, 2 * 524288, dev)[1] == 0
    assert solve_mega._grid_choice(kn, 131072, dev) == (None, 0)
    rule = solve_mega._grid_choice
    with k1_grid(256):
        assert solve_mega._grid_choice(kn, 1000, dev) == (None, 256)
    assert solve_mega._grid_choice is rule


def test_grid_buffers():
    """The grid's buffers: the working set's rows, the int buffer's head
    and two words a tile, and lane-major outputs under batch-minor views
    (one thread per lane keeps them batch-minor)."""
    assert solve_mega.work_rows(29) == 30 * 8 + 29 * 2
    assert solve_mega.work_rows(29, 4, True) == 30 * 8 + 29 * 2 + 90 + 16
    assert solve_mega.tile_words(1000) == 3 + 2 * 8
    ss, us, outs = solve_mega.outputs(29, 1000, 0, "cpu")
    assert ss.is_contiguous() and us.is_contiguous()
    assert ss.shape == (30, 8, 1000) and us.shape == (29, 2, 1000)
    ss, us, outs = solve_mega.outputs(29, 1000, 128, "cpu")
    assert ss.shape == (30, 8, 1000) and ss.stride() == (8, 1, 240)
    assert us.shape == (29, 2, 1000) and us.stride() == (8, 1, 240)
    assert us.data_ptr() == ss[1, 6:].data_ptr()
    assert [o.stride() for o in outs] == [(6,)] * 6
    assert outs[1].data_ptr() - outs[0].data_ptr() == 4


@pytest.mark.parametrize("case", ["cold", "warm", "resume", "late",
                                  "extras", "bicycle"])
def test_emulated_grid_equals_one_lane_per_thread(libs, case):
    """The grid (one block, 1,000 lanes) against one thread per lane, every
    output bit for bit, with its counts: every lane past the first grid's
    refilled, no tile solved again on clean inputs (a lane resumed done
    blends while its tile runs, so the resumed batch may re-solve some)."""
    name = case if case in ("extras", "bicycle") else "prod"
    cfg = {"bicycle": dataclasses.replace(CFG, model="bicycle",
                                          trig="exact")}.get(case, CFG)
    ins = _inputs(B, 31, cfg, None if case != "extras" else MPCParams())
    kw = {}
    if case in ("warm", "resume"):
        first, _ = _launch(libs["prod"], ins, dataclasses.replace(
            CFG, max_sqp_iters=12 if case == "warm" else 3), 0)
        if case == "warm":
            us = first[1]
            ins = ins[:5] + (torch.cat([us[1:], us[-1:]]).contiguous(),)
        else:
            done = first[7].clone()
            done[::7] = 0.0
            kw["resume"] = (done, first[3], first[6], first[5])
            ins = ins[:5] + (first[1].contiguous(),)
    if case == "extras":
        kw["blobs"] = GaussianObstacles.from_sigmas(*(
            torch.tensor(a, dtype=torch.float32)
            for a in numpy_blobs(31, B))).lane()
        kw["refs"] = torch.tensor(numpy_refs(31, B, cfg.n_steps),
                                  dtype=torch.float32).permute(
                                      1, 2, 0).contiguous()
    grid, (refilled, retiled) = _launch(
        libs["late" if case == "late" else name], ins, cfg, SLOTS, **kw)
    lane, _ = _launch(libs[name], ins, cfg, 0, **kw)
    assert _bits_equal(grid, lane)
    assert not any(bool(a.isnan().any()) for a in lane)
    assert refilled == B - SLOTS
    if case != "resume":
        assert retiled == 0
    if case == "cold":
        assert int((lane[4] == CFG.max_sqp_iters).sum()) > 0
        whole = tuple(torch.cat([a, a[..., :24]], -1) for a in ins)
        lock, _ = _launch(libs["lockstep"], whole, cfg, 0, lockstep=True)
        grid, _ = _launch(libs["prod"], whole, cfg, SLOTS)
        assert _bits_equal(grid, lock)


@pytest.mark.parametrize("fixture", ["nonfinite", "done_early", "witness"])
def test_emulated_grid_blends_done_lanes_as_their_tile(libs, fixture):
    """Lanes planted with NaN, inf and an overflowing coefficient (half of
    them resumed done beside running ones), and the next-backward witness
    repeated over 8 tiles: the grid bit for bit one thread per lane. A
    done lane that blends while its tile outlives it sends the tile to the
    second kernel, which the fixtures with such lanes count."""
    resume = None
    cfg = CFG
    if fixture == "witness":
        ins, cfg = next_backward_witness(torch.float32)
        ins = tuple(torch.cat([a] * 8, -1).contiguous() for a in ins)
    else:
        clean = _inputs(1024, 12, params=MPCParams())
        lanes = [5 + 97 * i for i in range(10)]
        planted = plant_nonfinite({"z": clean[0], "coeffs": clean[1]},
                                  lanes)
        ins = (planted["z"], planted["coeffs"]) + tuple(clean[2:])
        if fixture == "done_early":
            done = torch.zeros(1024)
            done[lanes[::2] + [9, 60, 500]] = 1.0
            resume = (done, torch.zeros_like(done),
                      torch.full_like(done, 1e-6),
                      torch.full_like(done, float("inf")))
    grid, (refilled, retiled) = _launch(libs["prod"], ins, cfg, SLOTS,
                                        resume=resume)
    lane, _ = _launch(libs["prod"], ins, cfg, 0, resume=resume)
    assert _bits_equal(grid, lane)
    assert refilled == 1024 - SLOTS
    assert any(bool(a.isnan().any()) for a in lane)
    if fixture != "nonfinite":
        assert retiled > 0


def test_emulated_tile_exit_shift_moves_blocks_not_results(libs):
    """The per-tile exit (done_frac 0.97, 4 tiles) with its blocks started
    at tiles 1 and 3 (block b solves tile (b + shift) mod 4): every output
    bit for bit the unshifted launch's, tiles stopped with lanes not done.
    The launcher refuses a shift outside [0, tiles) and any shift on one
    thread per lane; `tile_shift` spreads a batch's launches over its
    tiles."""
    cfg = dataclasses.replace(CFG, done_frac=0.97)
    assert _variant(cfg).variant == VARIANTS["lockstep"][0]
    ins = _inputs(4 * solve_mega.TILE, 17, cfg)
    base, _ = _launch(libs["lockstep"], ins, cfg, 0)
    assert not any(bool(a.isnan().any()) for a in base)
    assert int((base[7] < 0.5).sum()) > 0
    for shift in (1, 3):
        got, _ = _launch(libs["lockstep"], ins, cfg, 0, shift=shift)
        assert _bits_equal(got, base)
    _launch(libs["lockstep"], ins, cfg, 0, shift=4, err_want=100001)
    _launch(libs["lockstep"], ins, cfg, 0, shift=-1, err_want=100001)
    _launch(libs["prod"], ins, CFG, 0, shift=1, err_want=100001)
    before = solve_mega.tile_launches
    shifts = [solve_mega.tile_shift(1024) for _ in range(256)]
    assert solve_mega.tile_launches == before + 256
    assert all(0 <= k < 1024 for k in shifts)
    assert len(set(shifts)) == 256
    assert len(set(shifts[::4])) == 64
