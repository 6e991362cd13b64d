"""Gaussian-blob obstacles in the port against the JAX package, on the same
numpy inputs (`mpc_ros_tpu_torch.testing.numpy_blobs`, `bench.py`'s
obstacle layout):

* the blob terms and `GaussianObstacles` in f64, to 1e-12;
* the XLA lane path with blobs (Gauss-Newton and gated DDP) against JAX
  `batch_solve_lane(backward="xla")` in f64: conv and iterations equal on
  every lane, controls within max(1e-8, twice the port's own response to
  a one-ulp change of z0) — the bar of tests/test_torch_lane_xla.py;
* K1 stage (e), `solve_mega_plain(blobs=...)`, against the JAX megakernel
  in Pallas interpret mode in f64, at the same bar;
* the compact schedule with per-lane blobs at N=48 and B=384 (three
  128-lane tiles on both sides) against JAX's compact schedule in
  interpret mode, lane by lane in f64;
* serving with one blob per robot against JAX `receding_horizon_rollout`
  in f64 (both on their XLA lane paths): the closed loop's controls to
  1e-7.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_ros_tpu.config import MPCParams as JMPCParams
from mpc_ros_tpu.config import SolverConfig as JSolverConfig
from mpc_ros_tpu.engine.receding import receding_horizon_rollout as jroll
from mpc_ros_tpu.kernels import solve_pallas as jsp
from mpc_ros_tpu.kernels.backward_fused_pallas import pack_params as jpack
from mpc_ros_tpu.models import obstacles as jobs
from mpc_ros_tpu.solver import batch_lane as jbl
from mpc_ros_tpu_torch.config import MPCParams, SolverConfig
from mpc_ros_tpu_torch.engine import receding_horizon_rollout
from mpc_ros_tpu_torch.kernels import solve_mega
from mpc_ros_tpu_torch.kernels.pack import pack_params
from mpc_ros_tpu_torch.models import obstacles
from mpc_ros_tpu_torch.solver import batch_lane as tbl
from mpc_ros_tpu_torch.testing import (numpy_blobs, numpy_scenarios,
                                       torch_threads)
from mpc_ros_tpu_torch.verify import parity_gates

TOL = 1e-12
B = 128
N = 12
F64 = (jnp.float64, torch.float64)



@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these tests run many small ops, and the suite
    runs in several processes at once (`testing.torch_threads`)."""
    with torch_threads(1):
        yield

def _t(a, dtype=torch.float64):
    return torch.tensor(np.asarray(a), dtype=dtype)


def _jblobs(arrays, dtype):
    return jobs.GaussianObstacles.from_sigmas(
        *(jnp.asarray(a, dtype) for a in arrays))


def _tblobs(arrays, dtype):
    return obstacles.GaussianObstacles.from_sigmas(
        *(_t(a, dtype) for a in arrays))


# ------------------------------------------------------------ blob terms


def test_blob_terms_match():
    """blob_terms_bl, blob_concave_bl and blob_cost in f64, on points near
    and far from the blobs (K=3, lane-major)."""
    rng = np.random.default_rng(0)
    arrays = numpy_blobs(0, 64, n_blobs=3)
    arrays[0][:, 1] = rng.uniform(-1.0, 2.0, 64)      # a second live blob
    jl = _jblobs(arrays, jnp.float64).lane()
    tl = _tblobs(arrays, torch.float64).lane()
    x = rng.uniform(-0.5, 2.0, size=(5, 64))
    y = rng.uniform(-0.5, 2.0, size=(5, 64))
    ref = jobs.blob_terms_bl(*jl, jnp.asarray(x), jnp.asarray(y))
    ours = obstacles.blob_terms_bl(*tl, _t(x), _t(y))
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=TOL)
    np.testing.assert_allclose(
        obstacles.blob_concave_bl(*tl, _t(x), _t(y)).numpy(),
        np.asarray(jobs.blob_concave_bl(*jl, jnp.asarray(x),
                                        jnp.asarray(y))), rtol=0, atol=TOL)
    # one scenario's total penalty over points (..., 2)
    one_j = jobs.GaussianObstacles(*(jnp.asarray(a[3]) for a in (
        arrays[0], arrays[1], 1.0 / (2.0 * arrays[2] ** 2), arrays[3])))
    one_t = obstacles.GaussianObstacles(*(_t(a[3]) for a in (
        arrays[0], arrays[1], 1.0 / (2.0 * arrays[2] ** 2), arrays[3])))
    xy = rng.uniform(0.0, 1.5, size=(7, 4, 2))
    assert abs(float(obstacles.blob_cost(one_t, _t(xy)))
               - float(jobs.blob_cost(one_j, jnp.asarray(xy)))) <= TOL


def test_gaussian_obstacles_to_frame_and_lane():
    arrays = numpy_blobs(1, 16)
    jb = _jblobs(arrays, jnp.float64)
    tb = _tblobs(arrays, torch.float64)
    assert tb.n_blobs == jb.n_blobs == 4
    for a, b in zip(tb.lane(), jb.lane()):
        assert a.is_contiguous() and tuple(a.shape) == (4, 16)
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for pose in ((0.3, -0.2, 0.7), (-1.0, 2.0, -2.5)):
        fj = jb.to_frame(jnp.asarray(pose))
        ft = tb.to_frame(torch.tensor(pose, dtype=torch.float64))
        for name in ("cx", "cy", "gamma", "w"):
            np.testing.assert_allclose(getattr(ft, name).numpy(),
                                       np.asarray(getattr(fj, name)),
                                       rtol=0, atol=TOL)
    # a single scenario's (K,) leaves lane as (K, 1)
    one = obstacles.GaussianObstacles.from_sigmas(
        _t([0.5, 1.0]), _t([0.2, 0.4]), 0.3, 100.0)
    assert [tuple(a.shape) for a in one.lane()] == [(2, 1)] * 4
    np.testing.assert_allclose(one.gamma.numpy(), 1.0 / 0.18)


# -------------------------------------------------------- XLA lane path


def _lane_both(kw, seed, blobs_arrays, dtypes=F64, batch=B):
    """The JAX and the port's batch_solve_lane on one numpy batch with
    blobs; in f64 the port's one-ulp response `ulp_dus` too."""
    z0, coeffs = numpy_scenarios(seed, batch)
    jdt, tdt = dtypes
    r_j = jbl.batch_solve_lane(
        jnp.asarray(z0, jdt), jnp.asarray(coeffs, jdt),
        JMPCParams().astype(jdt), JSolverConfig(**kw),
        blobs=_jblobs(blobs_arrays, jdt))
    cfg = SolverConfig(**kw)
    tb = _tblobs(blobs_arrays, tdt)
    r_t = tbl.batch_solve_lane(_t(z0, tdt), _t(coeffs, tdt), MPCParams(),
                               cfg, blobs=tb)
    r_t.ulp_dus = 0.0
    if tdt == torch.float64:
        for k in range(2):
            flip = np.random.default_rng(100 + k).choice([-1.0, 1.0],
                                                         size=z0.shape)
            r_u = tbl.batch_solve_lane(_t(z0 * (1.0 + 2.0 ** -52 * flip)),
                                       _t(coeffs), MPCParams(), cfg,
                                       blobs=tb)
            r_t.ulp_dus = max(r_t.ulp_dus,
                              float((r_u.us - r_t.us).abs().max()))
    return r_j, r_t


def _assert_f64_bars(r_j, r_t):
    np.testing.assert_array_equal(r_t.converged.numpy(),
                                  np.asarray(r_j.converged))
    np.testing.assert_array_equal(r_t.n_iters.numpy(),
                                  np.asarray(r_j.n_iters))
    dus = float(np.abs(r_t.us.numpy() - np.asarray(r_j.us)).max())
    assert dus <= max(1e-8, 2.0 * r_t.ulp_dus), (dus, r_t.ulp_dus)
    np.testing.assert_allclose(r_t.cost.numpy(), np.asarray(r_j.cost),
                               rtol=1e-10)


@pytest.mark.parametrize("ddp", [False, True], ids=["gn", "gated_ddp"])
def test_xla_path_with_blobs_matches_jax_f64(ddp):
    """Two blobs per lane, one live; under DDP the gate resolves with
    obstacles (2.5 capped to 0.75) and the concave blob curvature joins on
    the lanes past it."""
    kw = dict(n_steps=N, max_sqp_iters=20, backward="xla", ddp=ddp)
    r_j, r_t = _lane_both(kw, 1, numpy_blobs(3, B, n_blobs=2))
    _assert_f64_bars(r_j, r_t)
    assert r_t.converged.numpy().mean() > 0.95
    # the blobs move the solution: it is not the obstacle-free one
    free = tbl.batch_solve_lane(*(_t(a) for a in numpy_scenarios(1, B)),
                                MPCParams(), SolverConfig(**kw))
    assert float((free.us - r_t.us).abs().max()) > 1e-2


def test_pallas_with_blobs_runs_the_xla_path(monkeypatch):
    """The two-kernel route takes no blobs: "pallas" with blobs runs the
    XLA lane path with the route's knobs (GN, 8 candidates), on both
    sides, held to the gates in f32."""
    def boom(*a, **kw):
        raise AssertionError("the two-kernel route must not run")

    monkeypatch.setattr(tbl, "solve_two_kernel", boom)
    monkeypatch.setattr(tbl, "solve_mega_scheduled", boom)
    kw = dict(n_steps=N, max_sqp_iters=12, backward="pallas", tol_grad=1e-4)
    r_j, r_t = _lane_both(kw, 2, numpy_blobs(4, B),
                          dtypes=(jnp.float32, torch.float32))
    g = parity_gates(r_t.us.numpy(), r_t.cost.numpy(),
                     r_t.converged.numpy(), r_t.n_iters.numpy(),
                     np.asarray(r_j.us), np.asarray(r_j.cost),
                     np.asarray(r_j.converged), np.asarray(r_j.n_iters), N)
    assert g["ok"], g


# ------------------------------------------------------ K1 stage (e)


def _kernel_inputs(seed, batch, n_steps):
    z0, coeffs = numpy_scenarios(seed, batch)
    lb = np.full((2, batch), -1.0)
    return [z0.T.copy(), coeffs.T.copy(), lb, -lb,
            np.zeros((n_steps - 1, 2, batch))]


def _jax_mega(fn, arrays, blob_arrays, kw):
    zT, cT, lb, ub, u0 = (jnp.asarray(a, jnp.float64) for a in arrays)
    out = fn(zT, cT, jpack(JMPCParams(), zT.shape[-1], jnp.float64), lb, ub,
             u0, JSolverConfig(**kw), dtype=jnp.float64, interpret=True,
             blobs=_jblobs(blob_arrays, jnp.float64).lane())
    return [np.asarray(a) for a in out]


def _port_mega(fn, arrays, blob_arrays, kw):
    zT, cT, lb, ub, u0 = (_t(a) for a in arrays)
    out = fn(zT, cT, pack_params(MPCParams(), zT.shape[-1], torch.float64),
             lb, ub, u0, SolverConfig(**kw),
             blobs=_tblobs(blob_arrays, torch.float64).lane())
    return [a.numpy() for a in out]


def _assert_mega_lanes(fn, arrays, blob_arrays, kw, ref, ours):
    """conv, iterations and done equal on every lane; controls and states
    within max(1e-8, twice the port's one-ulp response), which is only
    computed where 1e-8 is exceeded."""
    np.testing.assert_array_equal(ours[3], ref[3])
    np.testing.assert_array_equal(ours[4], ref[4])
    np.testing.assert_array_equal(ours[7], ref[7])
    worst = max(np.abs(ours[1] - ref[1]).max(), np.abs(ours[0] - ref[0]).max())
    if worst > 1e-8:
        ulp = 0.0
        for k in range(2):
            flip = np.random.default_rng(100 + k).choice(
                [-1.0, 1.0], size=arrays[0].shape)
            moved = [arrays[0] * (1.0 + 2.0 ** -52 * flip)] + arrays[1:]
            out = _port_mega(fn, moved, blob_arrays, kw)
            ulp = max(ulp, float(np.abs(out[1] - ours[1]).max()))
        assert worst <= 2.0 * ulp, (worst, ulp)
    np.testing.assert_allclose(ours[2], ref[2], rtol=1e-10)


def test_plain_kernel_with_blobs_matches_interpret_f64():
    """K1 stage (e) under gated DDP: the blob cost at every knot, the blob
    expansion in the stage and terminal values, the concave part past the
    gate, the obstacle mu floor and gate."""
    arrays = _kernel_inputs(5, B, N)
    blob_arrays = numpy_blobs(6, B)
    kw = dict(n_steps=N, max_sqp_iters=20, ddp=True, trig="exact")
    fn_j, fn_t = jsp.solve_pallas, solve_mega.solve_mega_plain
    ref = _jax_mega(fn_j, arrays, blob_arrays, kw)
    ours = _port_mega(fn_t, arrays, blob_arrays, kw)
    _assert_mega_lanes(fn_t, arrays, blob_arrays, kw, ref, ours)
    assert ref[3].mean() > 0.95


def test_compact_with_blobs_matches_interpret_f64():
    """N=48, cap 22, B=384 with per-lane blobs: the compact schedule (no
    long-horizon pair with obstacles: gate 0.75, mu floor 1e-6) gathers
    each tail lane's own blobs. Lane by lane against JAX's
    `_solve_compact`; compaction engaged (two passes, a 128-lane tail)."""
    n = 48
    arrays = _kernel_inputs(7, 384, n)
    blob_arrays = numpy_blobs(8, 384)
    kw = dict(n_steps=n, max_sqp_iters=22, trig="exact")
    ref = _jax_mega(jsp.solve_pallas_scheduled, arrays, blob_arrays, kw)
    before = (solve_mega.passes, solve_mega.tail_lanes)
    fn = solve_mega.solve_mega_scheduled
    ours = _port_mega(fn, arrays, blob_arrays, kw)
    assert (solve_mega.passes - before[0],
            solve_mega.tail_lanes - before[1]) == (2, 128)
    assert int(solve_mega.last_need) > 0
    _assert_mega_lanes(fn, arrays, blob_arrays, kw, ref, ours)
    # the tail got lanes whose blobs differ from their pass-2 neighbours'
    assert len(np.unique(blob_arrays[0][:, 0])) == 384


# -------------------------------------------------------------- serving


def test_serving_with_blobs_matches_jax_f64():
    """One blob per robot (`bench.py --serving --obstacles`' field), 3
    warm-started cycles, both sides on their XLA lane paths in f64: the
    applied controls and plant states to 1e-7 and the iteration counts
    equal, cycle by cycle."""
    z0, coeffs = numpy_scenarios(9, B)
    blob_arrays = numpy_blobs(10, B, n_blobs=1)
    kw = dict(n_steps=N, max_sqp_iters=20, tol_grad=1e-7)
    tr_j = jroll(jnp.asarray(z0), jnp.asarray(coeffs),
                 JMPCParams().astype(jnp.float64), JSolverConfig(**kw),
                 n_cycles=3, blobs=_jblobs(blob_arrays, jnp.float64))
    tr_t = receding_horizon_rollout(_t(z0), _t(coeffs), MPCParams(),
                                    SolverConfig(**kw), n_cycles=3,
                                    blobs=_tblobs(blob_arrays,
                                                  torch.float64))
    np.testing.assert_allclose(tr_t.us.numpy(), np.asarray(tr_j.us),
                               rtol=0, atol=1e-7)
    np.testing.assert_allclose(tr_t.zs.numpy(), np.asarray(tr_j.zs),
                               rtol=0, atol=1e-7)
    np.testing.assert_array_equal(tr_t.iters.numpy(), np.asarray(tr_j.iters))
    assert float(tr_t.converged.double().mean()) > 0.95
