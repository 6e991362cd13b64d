"""Grid costmaps through the port's solvers against the JAX package's, in
float64 on the same numpy inputs (grids built once in numpy, each
scenario's obstacle ahead of it on its path):

* `ilqr.solve(omap=...)` for the three samplings: one scenario unbatched
  against JAX `ilqr.solve`, and a batch with one map per lane against
  `jax.vmap` of it;
* `batch_solve_lane(omaps=...)` on the XLA lane path for the three
  samplings against JAX `batch_solve_lane(backward="xla")`;
* `backward="mega"` with grid maps in float32 at a kernel shape takes the
  XLA lane path, as in JAX: no K1 launch, the XLA path's result bit for
  bit.

The bar is ROADMAP Queue 3 item 5's noise-floor rule: equal iterations
and convergence on every lane, controls within max(1e-8, twice the larger
of the two solvers' responses to a one-ulp change of z0), cost to rtol
1e-10.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_ros_tpu.config import MPCParams as JMPCParams
from mpc_ros_tpu.config import SolverConfig as JSolverConfig
from mpc_ros_tpu.models import obstacles as jobs
from mpc_ros_tpu.solver import batch_lane as jbl
from mpc_ros_tpu.solver import ilqr as jilqr
from mpc_ros_tpu_torch.config import MPCParams, SolverConfig
from mpc_ros_tpu_torch.models import obstacles
from mpc_ros_tpu_torch.solver import batch_lane as tbl
from mpc_ros_tpu_torch.solver import ilqr
from mpc_ros_tpu_torch.testing import numpy_scenarios, torch_threads

N = 12
B = 8
CELLS = 32
EXTENT = 4.0
SAMPLINGS = ("bilinear", "spline", "spline_coeff")
KW = dict(n_steps=N, max_sqp_iters=30, ddp=True)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these tests run many small ops, and the suite
    runs in several processes at once (`testing.torch_threads`)."""
    with torch_threads(1):
        yield


def numpy_maps(seed: int, batch: int):
    """(batch, CELLS, CELLS) grids of one Gaussian bump (sigma 0.3) ahead
    of the robot on its first metre, the map centred on it; origin,
    resolution and weight per map."""
    rng = np.random.default_rng(seed)
    xs = np.linspace(-EXTENT / 2, EXTENT / 2, CELLS)
    X, Y = np.meshgrid(xs, xs)
    cx = rng.uniform(0.25, 0.7, (batch, 1, 1))
    cy = rng.uniform(-0.15, 0.15, (batch, 1, 1))
    g = np.exp(-((X - cx) ** 2 + (Y - cy) ** 2) / (2 * 0.3 ** 2))
    origin = np.full((batch, 2), -EXTENT / 2)
    res = np.full(batch, EXTENT / (CELLS - 1))
    weight = np.full(batch, 50.0)
    return g, origin, res, weight


def both_maps(arrays, sampling, one: int = -1):
    """The JAX and the port's map (batched, or map `one` alone)."""
    leaves = arrays if one < 0 else tuple(a[one] for a in arrays)
    jm = jobs.ObstacleMap(*(jnp.asarray(a) for a in leaves),
                          sampling=sampling)
    tm = obstacles.ObstacleMap(*(torch.tensor(np.asarray(a))
                                 for a in leaves), sampling=sampling)
    if sampling == "spline_coeff":
        jm, tm = jm.with_spline_coeffs(), tm.with_spline_coeffs()
    return jm, tm


def one_ulp_response(run, z0, out):
    """The largest |d us| of `run` (z0 -> result) when z0 moves by one
    ulp, over two sign patterns."""
    worst = 0.0
    for k in range(2):
        flip = np.random.default_rng(100 + k).choice([-1.0, 1.0],
                                                     size=z0.shape)
        moved = run(z0 * (1.0 + 2.0 ** -52 * flip))
        worst = max(worst, float(np.abs(np.asarray(moved.us)
                                        - np.asarray(out.us)).max()))
    return worst


def assert_noise_floor(ref, ours, run, jrun, z0):
    np.testing.assert_array_equal(ours.n_iters.numpy(),
                                  np.asarray(ref.n_iters))
    np.testing.assert_array_equal(ours.converged.numpy(),
                                  np.asarray(ref.converged))
    dus = float(np.abs(ours.us.numpy() - np.asarray(ref.us)).max())
    if dus > 1e-8:
        ulp = max(one_ulp_response(run, z0, ours),
                  one_ulp_response(jrun, z0, ref))
        assert dus <= 2.0 * ulp, (dus, ulp)
    np.testing.assert_allclose(ours.cost.numpy(), np.asarray(ref.cost),
                               rtol=1e-10)


@pytest.mark.parametrize("sampling", SAMPLINGS)
def test_ilqr_solve_with_grid_maps_matches_jax_f64(sampling):
    """`ilqr.solve(omap=...)`: a batch, one map per lane, against the JAX
    solve mapped over the scenarios, then scenario 0 unbatched with its
    own map."""
    z0, coeffs = numpy_scenarios(1, B)
    arrays = numpy_maps(2, B)
    jm, tm = both_maps(arrays, sampling)
    jcfg, cfg = JSolverConfig(**KW), SolverConfig(**KW)
    jp = JMPCParams().astype(jnp.float64)
    jsolve = jax.jit(jax.vmap(
        lambda z, c, m: jilqr.solve(z, c, jp, jcfg, omap=m)))

    def run(z):
        return ilqr.solve(torch.tensor(z), torch.tensor(coeffs), MPCParams(),
                          cfg, omap=tm)

    def jrun(z):
        return jsolve(jnp.asarray(z), jnp.asarray(coeffs), jm)

    ours, ref = run(z0), jrun(z0)
    assert ours.converged.all() and np.asarray(ref.converged).all()
    assert_noise_floor(ref, ours, run, jrun, z0)

    jm1, tm1 = both_maps(arrays, sampling, one=0)
    jsolve1 = jax.jit(lambda z, c, m: jilqr.solve(z, c, jp, jcfg, omap=m))

    def run1(z):
        return ilqr.solve(torch.tensor(z), torch.tensor(coeffs[0]),
                          MPCParams(), cfg, omap=tm1)

    def jrun1(z):
        return jsolve1(jnp.asarray(z), jnp.asarray(coeffs[0]), jm1)

    one = run1(z0[0])
    assert one.us.shape == (N - 1, 2)
    assert_noise_floor(jrun1(z0[0]), one, run1, jrun1, z0[0])
    # the map bends the plan: the unobstructed solve differs
    free = ilqr.solve(torch.tensor(z0), torch.tensor(coeffs), MPCParams(),
                      cfg)
    assert float((free.us - ours.us).abs().max()) > 1e-3


@pytest.mark.parametrize("sampling", SAMPLINGS)
def test_lane_path_with_grid_maps_matches_jax_f64(sampling):
    """`batch_solve_lane(omaps=...)` on the XLA lane path against JAX's,
    16 lanes with a map each."""
    batch = 2 * B
    z0, coeffs = numpy_scenarios(3, batch)
    jm, tm = both_maps(numpy_maps(4, batch), sampling)
    kw = dict(KW, backward="xla")
    jcfg, cfg = JSolverConfig(**kw), SolverConfig(**kw)
    jp = JMPCParams().astype(jnp.float64)

    def run(z):
        return tbl.batch_solve_lane(torch.tensor(z), torch.tensor(coeffs),
                                    MPCParams(), cfg, omaps=tm)

    def jrun(z):
        return jbl.batch_solve_lane(jnp.asarray(z), jnp.asarray(coeffs), jp,
                                    jcfg, omaps=jm)

    ours, ref = run(z0), jrun(z0)
    assert float(ours.converged.double().mean()) >= 0.9
    assert_noise_floor(ref, ours, run, jrun, z0)


def test_mega_backward_with_grid_maps_takes_the_xla_path(monkeypatch):
    """Float32 at a kernel shape (B=128) with `backward="mega"`: grid maps
    never take K1 (the JAX rule): the kernel's schedule is not entered
    and the result is the XLA lane path's bit for bit."""
    def refuse(*a, **kw):
        raise AssertionError("K1 entered with grid maps")

    monkeypatch.setattr(tbl, "solve_mega_scheduled", refuse)
    z0, coeffs = numpy_scenarios(5, 128)
    _, tm = both_maps(numpy_maps(6, 128), "spline_coeff")
    tm = tm.to(torch.float32)
    f32 = dict(dtype=torch.float32)
    out = {}
    for backward in ("mega", "xla"):
        out[backward] = tbl.batch_solve_lane(
            torch.tensor(z0, **f32), torch.tensor(coeffs, **f32),
            MPCParams(), SolverConfig(n_steps=N, backward=backward),
            omaps=tm)
    for f in ("us", "cost", "n_iters", "converged"):
        assert torch.equal(getattr(out["mega"], f), getattr(out["xla"], f))
