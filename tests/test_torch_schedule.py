"""Resume state, the per-tile exit of `done_frac < 1`, and the sorted and
compact schedules of the whole-solve kernel's plain version, against the
JAX package's megakernel and its schedules run in Pallas interpret mode on
the same numpy inputs.

B = 384 is three 128-lane tiles on both sides (`_pick_sub(384, ...)` is 1,
and the port's tile is `solve_mega.TILE`), so the per-tile exit and the
compact schedule compare lane by lane. In f64 every lane converges alike
in the same number of iterations and the controls agree to 1e-8, or to
twice the port's own response to a one-ulp change of z0 where a lane sits
on an active-set near-tie (the bar of tests/test_torch_lane_xla.py). In
f32 the solves are held to the `kernel_verify` gates. Compact engagement
is read from the port's own counters (`solve_mega.passes`, `tail_lanes`).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_ros_tpu.config import MPCParams as JMPCParams
from mpc_ros_tpu.config import SolverConfig as JSolverConfig
from mpc_ros_tpu.kernels import solve_pallas as jsp
from mpc_ros_tpu.kernels.backward_fused_pallas import pack_params as jpack
from mpc_ros_tpu_torch.config import MPCParams, SolverConfig
from mpc_ros_tpu_torch.kernels import solve_mega
from mpc_ros_tpu_torch.kernels.pack import pack_params
from mpc_ros_tpu_torch.testing import (numpy_scenarios, scaled_weights,
                                       torch_threads)
from mpc_ros_tpu_torch.verify import parity_gates

HARD = dict(pose_scale=0.8, curve_scale=0.6)



@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these tests run many small ops, and the suite
    runs in several processes at once (`testing.torch_threads`)."""
    with torch_threads(1):
        yield

def _inputs(seed, B, n_steps, lane_weights=False, **draw):
    """Batch-last numpy inputs (zT, cT, lb, ub, u0) and the MPCParams
    leaves."""
    z0, coeffs = numpy_scenarios(seed, B, **draw)
    leaves = dataclasses.asdict(JMPCParams())
    if lane_weights:
        leaves.update(scaled_weights(leaves, B))
    lb = np.full((2, B), -1.0)
    return ([z0.T.copy(), coeffs.T.copy(), lb, -lb,
             np.zeros((n_steps - 1, 2, B))], leaves)


def _jax(fn, arrays, leaves, kw, f64, resume=None):
    dt = jnp.float64 if f64 else jnp.float32
    zT, cT, lb, ub, u0 = (jnp.asarray(a, dt) for a in arrays)
    B = zT.shape[-1]
    extra = {} if resume is None else {
        "resume": tuple(jnp.asarray(r, dt) for r in resume)}
    out = fn(zT, cT, jpack(JMPCParams(**leaves), B, dt), lb, ub, u0,
             JSolverConfig(**kw), dtype=dt, interpret=True, **extra)
    return [np.asarray(a) for a in out]


def _port(fn, arrays, leaves, kw, f64, resume=None):
    dt = torch.float64 if f64 else torch.float32
    zT, cT, lb, ub, u0 = (torch.tensor(a, dtype=dt) for a in arrays)
    B = zT.shape[-1]
    p = MPCParams.from_numpy({k: np.asarray(v) for k, v in leaves.items()})
    extra = {} if resume is None else {
        "resume": tuple(torch.tensor(r, dtype=dt) for r in resume)}
    out = fn(zT, cT, pack_params(p, B, dt), lb, ub, u0, SolverConfig(**kw),
             **extra)
    return [a.numpy() for a in out]


def _ulp_dus(fn, arrays, leaves, kw, ours, resume=None):
    """The largest |dus| of the port's f64 solve under a one-ulp change of
    z0: the batch's own f64 noise floor."""
    worst = 0.0
    for k in range(2):
        flip = np.random.default_rng(100 + k).choice([-1.0, 1.0],
                                                     size=arrays[0].shape)
        moved = [arrays[0] * (1.0 + 2.0 ** -52 * flip)] + arrays[1:]
        out = _port(fn, moved, leaves, kw, True, resume)
        worst = max(worst, float(np.abs(out[1] - ours[1]).max()))
    return worst


def _assert_lanes(ref, ours, ulp):
    """The f64 bars: conv and iterations equal on every lane, controls and
    states within max(1e-8, twice the one-ulp response)."""
    np.testing.assert_array_equal(ours[3], ref[3])       # conv
    np.testing.assert_array_equal(ours[4], ref[4])       # iters
    np.testing.assert_array_equal(ours[7], ref[7])       # done
    bar = max(1e-8, 2.0 * ulp)
    assert np.abs(ours[1] - ref[1]).max() <= bar, (ours, ulp)
    assert np.abs(ours[0] - ref[0]).max() <= bar
    np.testing.assert_allclose(ours[2], ref[2], rtol=1e-10)


def _gates(ref, ours, n_steps):
    mv = lambda us: np.moveaxis(us, -1, 0)
    return parity_gates(mv(ours[1]), ours[2], ours[3], ours[4],
                        mv(ref[1]), ref[2], ref[3], ref[4], n_steps)


def _counters():
    return solve_mega.passes, solve_mega.tail_lanes


def test_resume_matches_interpret_f64():
    """Pass 2 of a two-pass solve: u0 is pass 1's controls and the resume
    state (done, conv, mu, gnorm) pass 1's; the cost is recomputed by the
    initial rollout, iterations restart at 0, done lanes never update."""
    arrays, leaves = _inputs(0, 128, 12, **HARD)
    kw1 = dict(n_steps=12, max_sqp_iters=3, trig="exact")
    p1 = _jax(jsp.solve_pallas, arrays, leaves, kw1, True)
    resume = (p1[7], p1[3], p1[6], p1[5])
    assert 0.0 < p1[7].mean() < 1.0, p1[7].mean()    # some lanes done
    arrays2 = arrays[:4] + [p1[1]]
    kw = dict(n_steps=12, max_sqp_iters=9, trig="exact")
    ref = _jax(jsp.solve_pallas, arrays2, leaves, kw, True, resume)
    fn = solve_mega.solve_mega_plain
    ours = _port(fn, arrays2, leaves, kw, True, resume)
    _assert_lanes(ref, ours, _ulp_dus(fn, arrays2, leaves, kw, ours, resume))
    was_done = p1[7] > 0.5
    assert (ours[4][was_done] == 0).all()
    np.testing.assert_array_equal(ours[1][..., was_done],
                                  p1[1][..., was_done])
    assert ours[3].mean() > 0.9


def test_done_frac_tile_exit_matches_interpret_f64():
    """done_frac = 0.5 at B = 384: each 128-lane tile stops once 64 of its
    lanes are done, on both sides alike, and earlier than the full run."""
    arrays, leaves = _inputs(1, 384, 12)
    kw = dict(n_steps=12, max_sqp_iters=20, tol_grad=1e-9, trig="exact",
              done_frac=0.5)
    ref = _jax(jsp.solve_pallas, arrays, leaves, kw, True)
    fn = solve_mega.solve_mega_plain
    ours = _port(fn, arrays, leaves, kw, True)
    _assert_lanes(ref, ours, _ulp_dus(fn, arrays, leaves, kw, ours))
    full = _port(fn, arrays, leaves, dict(kw, done_frac=1.0), True)
    it_part = ours[4].reshape(3, 128).max(axis=1)
    it_full = full[4].reshape(3, 128).max(axis=1)
    assert (it_part <= it_full).all() and (it_part < it_full).any()
    assert it_part.max() < 20
    assert np.isfinite(ours[1]).all()
    # a stopped tile's undone lanes keep their iterate and report it
    assert 0.5 <= ours[7].reshape(3, 128).mean(axis=1).min() < 1.0


@pytest.mark.parametrize("f64", [True, False], ids=["f64", "f32"])
def test_compact_matches_interpret(f64):
    """The compact schedule (pass 1 at done_frac = 0.9, a 96-lane need
    padded to a 128-lane tail, pass 2 resumed) against JAX's
    `_solve_compact`: lane by lane in f64, at the gates in f32 (GN, where
    f32 leaves stragglers at N = 12)."""
    arrays, leaves = _inputs(2, 384, 12, **HARD)
    kw = dict(n_steps=12, max_sqp_iters=12, schedule="compact",
              compact_frac=0.9, compact_tail=0.25)
    kw.update(dict(trig="exact", tol_grad=1e-9) if f64 else
              dict(ddp=False, ls_iters=8, tol_grad=1e-4))
    ref = _jax(jsp.solve_pallas_scheduled, arrays, leaves, kw, f64)
    fn = solve_mega.solve_mega_scheduled
    before = _counters()
    ours = _port(fn, arrays, leaves, kw, f64)
    passes, tail = (a - b for a, b in zip(_counters(), before))
    assert (passes, tail) == (2, 128)
    assert 0 < int(solve_mega.last_need) <= 128
    if f64:
        _assert_lanes(ref, ours, _ulp_dus(fn, arrays, leaves, kw, ours))
    else:
        g = _gates(ref, ours, 12)
        assert g["ok"], g
    # the tail's fresh budget: at most 12 + 12 iterations per lane
    assert ours[4].max() <= 24 and np.isfinite(ours[1]).all()


def test_compact_pair_rescue_matches_interpret_f32():
    """The long-horizon pair (N = 38, f32, auto knobs): pass 1 at gate 1.5
    and mu floor 1e-2, the rescue at gate 0.75 with twice the budget, and
    stalled lanes (done, unconverged) re-entering with done cleared, mu
    reset to the weight-scaled floor and gnorm at +inf. No lane stalls
    naturally at this size, so both sides mark the same pass-1 lanes
    stalled (every 16th converged lane, per-lane weights x{0.5, 1, 4}) —
    the rescue must re-solve them alike."""
    arrays, leaves = _inputs(4, 384, 38, lane_weights=True, **HARD)
    kw = dict(n_steps=38, max_sqp_iters=6, tol_grad=1e-4, schedule="auto",
              compact_frac=0.9, compact_tail=0.25)
    assert SolverConfig(**kw)._long_horizon_pair(torch.float32, False)
    mark = np.arange(384) % 16 == 3

    def stall_pass_one(solve, to_numpy, where):
        calls = []

        def wrapped(*a, **k):
            out = list(solve(*a, **k))
            if not calls:
                done, conv = to_numpy(out[7]) > 0.5, to_numpy(out[3]) > 0.5
                out[3] = where(mark & done & conv, out[3])
                calls.append(mark & done & conv)
            else:
                calls.append(None)
            return tuple(out)
        return wrapped, calls

    j_solve, j_calls = stall_pass_one(
        jsp.solve_pallas, np.asarray,
        lambda m, c: jnp.where(jnp.asarray(m), 0.0, c).astype(c.dtype))
    t_solve, t_calls = stall_pass_one(
        solve_mega.solve_mega, lambda t: t.numpy(),
        lambda m, c: torch.where(torch.from_numpy(m), 0.0, c))
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(jsp, "solve_pallas", j_solve)
        mp.setattr(solve_mega, "solve_mega", t_solve)
        ref = _jax(jsp.solve_pallas_scheduled, arrays, leaves, kw, False)
        before = _counters()
        ours = _port(solve_mega.solve_mega_scheduled, arrays, leaves, kw,
                     False)
    finally:
        mp.undo()
    assert len(j_calls) == len(t_calls) == 2
    passes, tail = (a - b for a, b in zip(_counters(), before))
    assert (passes, tail) == (2, 128)
    stalled = t_calls[0]
    assert stalled.sum() >= 16 and (j_calls[0] == stalled).all()
    # every lane that needed the rescue fit in the tail, and the stalled
    # ones were re-solved to a certificate
    assert stalled.sum() < int(solve_mega.last_need) <= 128
    assert (ours[3][stalled] > 0.5).all() and (ours[4][stalled] > 0).all()
    g = _gates(ref, ours, 38)
    assert g["ok"], g
    assert ours[3].mean() >= 0.99 and np.isfinite(ours[1]).all()


def test_sorted_matches_interpret_f64():
    """The sorted two passes: 3 presolve iterations, the stable sort
    (done lanes first, the rest by gnorm), the resumed continuation and
    the unsort, lane by lane (with done_frac = 1 a lane's result does not
    depend on the tile the sort puts it in)."""
    arrays, leaves = _inputs(3, 384, 12)
    kw = dict(n_steps=12, max_sqp_iters=8, schedule="sorted",
              presolve_iters=3, trig="exact", tol_grad=1e-9)
    ref = _jax(jsp.solve_pallas_scheduled, arrays, leaves, kw, True)
    fn = solve_mega.solve_mega_scheduled
    before = _counters()
    ours = _port(fn, arrays, leaves, kw, True)
    assert _counters() == (before[0] + 2, before[1])
    _assert_lanes(ref, ours, _ulp_dus(fn, arrays, leaves, kw, ours))
    assert ours[4].max() <= 8


@pytest.mark.parametrize("n_steps, compact", [(38, True), (34, False),
                                              (12, False)])
def test_auto_schedule_resolution(monkeypatch, n_steps, compact):
    """"auto" resolves to the compact schedule at n_steps > 36 and to the
    single pass below, as `solve_pallas_scheduled` does."""
    calls = []
    orig = solve_mega._solve_compact

    def spy(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    monkeypatch.setattr(solve_mega, "_solve_compact", spy)
    arrays, leaves = _inputs(5, 128, n_steps)
    kw = dict(n_steps=n_steps, max_sqp_iters=2, ls_iters=2, tol_grad=1e-3,
              schedule="auto")
    before = _counters()
    _port(solve_mega.solve_mega_scheduled, arrays, leaves, kw, False)
    assert len(calls) == int(compact)
    # B = 128 is one tile: the compact call runs the single pass
    assert _counters() == (before[0] + 1, before[1])


def test_tile_exit_needs_whole_tiles():
    arrays, leaves = _inputs(6, 200, 8)
    kw = dict(n_steps=8, max_sqp_iters=2, done_frac=0.5)
    with pytest.raises(ValueError, match="B % 128"):
        _port(solve_mega.solve_mega_plain, arrays, leaves, kw, False)
    # done_frac = 1 takes any batch
    _port(solve_mega.solve_mega_plain, arrays, leaves,
          dict(kw, done_frac=1.0), False)


@pytest.mark.parametrize("compact", [False, True], ids=["single", "compact"])
def test_parity_gates_compact_rule(compact):
    """`kernel_verify`'s compact branch: numerics only over lanes whose
    iteration counts match, at twice the du tolerance and 5e-4 d-cost."""
    rng = np.random.default_rng(0)
    B, n = 1000, 48
    us_b = rng.normal(size=(B, n - 1, 2))
    us_a = us_b + 1e-4
    cost = np.full(B, 10.0)
    conv = np.ones(B)
    it_b = np.full(B, 5.0)
    it_a = it_b.copy()
    # a lane that stopped one iteration apart, mid-path
    us_a[3] += 0.05
    it_a[3] += 1.0
    g = parity_gates(us_a, cost, conv, it_a, us_b, cost, conv, it_b, n,
                     compact=compact)
    assert g["ok"] == compact, g
    assert g["compared_frac"] == (0.999 if compact else 1.0)
    assert g["limits"]["max_du"] == pytest.approx(
        2e-3 * 47 / 29 * (2.0 if compact else 1.0))
    # the same difference on an iteration-matched lane breaks both rules
    it_a[3] -= 1.0
    g = parity_gates(us_a, cost, conv, it_a, us_b, cost, conv, it_b, n,
                     compact=compact)
    assert not g["ok"], g
