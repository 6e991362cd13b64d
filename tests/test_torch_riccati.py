"""The port's horizon-parallel Riccati (`ops/scan.py`, `solver/riccati.py`,
`ilqr.backward_pass_parallel`, `SolverConfig.horizon_parallel`) against
the JAX package's on the same numpy inputs, in float64:

* the associative scan against a sequential fold of a non-commutative
  operator (matrix products), forward and reverse;
* `combine`, `make_elements` (with and without the clamped-dimension
  elimination), `parallel_gains` and `parallel_gains_boxed` (saturated
  and unsaturated, per-lane mu) to 1e-10, at T in {8, 30}, the JAX
  functions mapped over the batch with `jax.vmap`;
* `backward_pass_parallel` to 1e-10 against JAX's, and against the
  port's sequential control-limited pass at `tests/test_riccati.py`'s
  bars;
* `ilqr.solve(horizon_parallel=True)` against JAX `batch_solve` at the
  noise-floor rule of tests/test_torch_ilqr.py, and against the port's
  sequential solve at `tests/test_riccati.py`'s bar (1e-6 on us).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_ros_tpu.config import MPCParams as JMPCParams
from mpc_ros_tpu.config import SolverConfig as JSolverConfig
from mpc_ros_tpu.engine.batch import batch_solve as jbatch_solve
from mpc_ros_tpu.solver import ilqr as jilqr
from mpc_ros_tpu.solver import riccati as jriccati
from mpc_ros_tpu_torch.config import MPCParams, SolverConfig
from mpc_ros_tpu_torch.ops.scan import associative_scan
from mpc_ros_tpu_torch.solver import ilqr, riccati
from mpc_ros_tpu_torch.testing import numpy_scenarios, torch_threads

F64 = torch.float64
TOL = 1e-10


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with torch_threads(1):
        yield


def _t(a):
    return torch.tensor(np.asarray(a), dtype=F64)


def _close(ours, ref, tol=TOL):
    ours = ours.numpy() if isinstance(ours, torch.Tensor) else ours
    ref = np.asarray(ref)
    assert ours.shape == ref.shape, (ours.shape, ref.shape)
    scale = max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(ours - ref).max()) if ref.size else 0.0
    assert err <= tol * scale, err


def random_lqr(T, batch=3, n=8, m=2, seed=0):
    """`tests/test_riccati.py::random_lqr` with a batch in front."""
    rng = np.random.default_rng(seed)
    A = np.eye(n) + 0.1 * rng.normal(size=(batch, T, n, n))
    B = 0.1 * rng.normal(size=(batch, T, n, m))
    l_s = rng.normal(size=(batch, T, n))
    l_u = rng.normal(size=(batch, T, m))
    M = rng.normal(size=(batch, T, n, n)) * 0.3
    l_ss = np.einsum("btij,btkj->btik", M, M) + np.eye(n) * 0.5
    Lu = rng.normal(size=(batch, T, m, m)) * 0.3
    l_uu = np.einsum("btij,btkj->btik", Lu, Lu) + np.eye(m) * 1.0
    l_us = 0.2 * rng.normal(size=(batch, T, m, n))
    MT = rng.normal(size=(batch, n, n)) * 0.3
    V_ss = np.einsum("bij,bkj->bik", MT, MT) + np.eye(n) * 0.5
    V_s = rng.normal(size=(batch, n))
    return A, B, l_s, l_u, l_ss, l_uu, l_us, V_s, V_ss


# ---------------------------------------------------------------- the scan


@pytest.mark.parametrize("T", [1, 2, 3, 8, 17])
@pytest.mark.parametrize("reverse", [False, True])
def test_scan_matches_sequential_fold(T, reverse):
    rng = np.random.default_rng(T)
    mats = _t(rng.normal(size=(2, T, 3, 3)) * 0.5 + np.eye(3))

    def op(a, b):
        return (a[0] @ b[0],)

    (out,) = associative_scan(op, (mats,), reverse=reverse, dim=1)
    ref = np.empty((2, T, 3, 3))
    m = mats.numpy()
    if reverse:
        acc = m[:, T - 1]
        ref[:, T - 1] = acc
        for t in range(T - 2, -1, -1):
            acc = acc @ m[:, t]          # op(later, earlier)
            ref[:, t] = acc
    else:
        acc = m[:, 0]
        ref[:, 0] = acc
        for t in range(1, T):
            acc = acc @ m[:, t]
            ref[:, t] = acc
    _close(out, ref, 1e-12)


# ------------------------------------------------------ elements and gains


@pytest.mark.parametrize("T", [8, 30])
def test_combine_and_elements_match_jax(T):
    prob = random_lqr(T, seed=T)
    rng = np.random.default_rng(T + 1)
    free = (rng.uniform(size=(3, T, 2)) > 0.4).astype(float)
    d_c = (1.0 - free) * rng.normal(size=(3, T, 2)) * 0.3
    jmake = jax.vmap(jriccati.make_elements)
    for kw in ({}, {"free": free, "d_c": d_c}):
        ours = riccati.make_elements(*(_t(a) for a in prob),
                                     **{k: _t(v) for k, v in kw.items()})
        if kw:
            ref = jax.vmap(lambda *a: jriccati.make_elements(
                *a[:9], free=a[9], d_c=a[10]))(
                *(jnp.asarray(a) for a in prob), jnp.asarray(free),
                jnp.asarray(d_c))
        else:
            ref = jmake(*(jnp.asarray(a) for a in prob))
        for a, b in zip(ours, ref):
            _close(a, b)
        # one combination of the later half onto the earlier
        e2 = riccati.LQRElement(*(x[:, 1:] for x in ours))
        e1 = riccati.LQRElement(*(x[:, :-1] for x in ours))
        je2 = jriccati.LQRElement(*(x[:, 1:] for x in ref))
        je1 = jriccati.LQRElement(*(x[:, :-1] for x in ref))
        for a, b in zip(riccati.combine(e2, e1), jriccati.combine(je2, je1)):
            _close(a, b)


@pytest.mark.parametrize("T", [8, 30])
def test_parallel_gains_match_jax(T):
    prob = random_lqr(T, seed=40 + T)
    ours = riccati.parallel_gains(*(_t(a) for a in prob))
    ref = jax.vmap(jriccati.parallel_gains)(*(jnp.asarray(a) for a in prob))
    for a, b in zip(ours, ref):
        _close(a, b)


def _boxed_case(T, saturated: bool, seed: int):
    prob = random_lqr(T, seed=seed)
    rng = np.random.default_rng(seed + 1)
    if saturated:
        lb, ub = np.array([-0.3, -0.2]), np.array([0.25, 0.35])
        us = rng.uniform(-0.3, 0.35, size=(3, T, 2))
    else:
        lb, ub = np.full(2, -1e9), np.full(2, 1e9)
        us = np.zeros((3, T, 2))
    return prob, lb, ub, us


@pytest.mark.parametrize("T", [8, 30])
@pytest.mark.parametrize("saturated", [False, True])
def test_parallel_gains_boxed_match_jax(T, saturated):
    prob, lb, ub, us = _boxed_case(T, saturated, 70 + T)
    mu = np.array([0.0, 1e-3, 0.5])
    lbd, ubd = lb[None, None] - us, ub[None, None] - us
    ours = riccati.parallel_gains_boxed(
        *(_t(a) for a in prob), _t(lbd), _t(ubd), mu=_t(mu), n_sweeps=12)
    ref = jax.vmap(lambda *a: jriccati.parallel_gains_boxed(
        *a[:11], mu=a[11], n_sweeps=12))(
        *(jnp.asarray(a) for a in prob), jnp.asarray(lbd), jnp.asarray(ubd),
        jnp.asarray(mu))
    for a, b in zip(ours, ref):
        _close(a, b)
    if saturated:
        assert float((ours[4] == 0).sum()) >= 5, "not saturated enough"


@pytest.mark.parametrize("T", [9, 33])
def test_backward_pass_parallel_matches_jax_and_sequential(T):
    """Against JAX's at 1e-10; against the port's sequential control-
    limited pass under saturation at mu = 0 at tests/test_riccati.py's
    bars (1e-8)."""
    prob, lb, ub, us = _boxed_case(T, True, 7 + T)
    lbB, ubB = np.tile(lb, (3, 1)), np.tile(ub, (3, 1))
    mu = np.zeros(3)
    ours = ilqr.backward_pass_parallel(
        *(_t(a) for a in prob), _t(us), _t(lbB), _t(ubB), _t(mu),
        n_sweeps=12)
    ref = jax.vmap(lambda *a: jilqr.backward_pass_parallel(
        *a, n_sweeps=12))(
        *(jnp.asarray(a) for a in prob), jnp.asarray(us), jnp.asarray(lbB),
        jnp.asarray(ubB), jnp.asarray(mu))
    for a, b in zip(ours, ref):
        _close(a, b)
    seq = ilqr.backward_pass(*(_t(a) for a in prob), _t(us), _t(lbB),
                             _t(ubB), _t(mu))
    for a, b in zip(ours, seq):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-8,
                                   atol=1e-8)


# ---------------------------------------------------------------- the solve


def _one_ulp_response(run, z0, out):
    worst = 0.0
    for k in range(2):
        flip = np.random.default_rng(100 + k).choice([-1.0, 1.0],
                                                     size=z0.shape)
        moved = run(z0 * (1.0 + 2.0 ** -52 * flip))
        worst = max(worst, float(np.abs(np.asarray(moved.us)
                                        - np.asarray(out.us)).max()))
    return worst


def test_horizon_parallel_solve_matches_jax_f64():
    """Equal iterations and convergence on every lane; controls within
    max(1e-8, twice the larger one-ulp response of the two solvers)."""
    B, N = 16, 12
    z0, coeffs = numpy_scenarios(3, B)
    kw = dict(n_steps=N, max_sqp_iters=30, horizon_parallel=True)
    jcfg, cfg = JSolverConfig(**kw), SolverConfig(**kw)
    jp = JMPCParams().astype(jnp.float64)
    tp = MPCParams().astype(F64)

    def jrun(z):
        return jbatch_solve(jnp.asarray(z), jnp.asarray(coeffs), jp, jcfg)

    def run(z):
        return ilqr.solve(_t(z), _t(coeffs), tp, cfg)

    ref, ours = jrun(z0), run(z0)
    np.testing.assert_array_equal(ours.n_iters.numpy(),
                                  np.asarray(ref.n_iters))
    np.testing.assert_array_equal(ours.converged.numpy(),
                                  np.asarray(ref.converged))
    dus = float(np.abs(ours.us.numpy() - np.asarray(ref.us)).max())
    if dus > 1e-8:
        ulp = max(_one_ulp_response(run, z0, ours),
                  _one_ulp_response(jrun, z0, ref))
        assert dus <= 2.0 * ulp, (dus, ulp)
    np.testing.assert_allclose(ours.cost.numpy(), np.asarray(ref.cost),
                               rtol=1e-10)


def test_horizon_parallel_solve_matches_sequential():
    """`tests/test_riccati.py::test_solver_with_horizon_parallel_matches_
    sequential` on the port: an interior problem, N=40, 1e-6 on us."""
    z0 = _t([0.0, 0.0, 0.0, 0.3, 0.05, -0.0997])
    coeffs = _t([0.05, -0.1, 0.2, -0.02])
    p = MPCParams(w_cte=100.0, w_vel=100.0, w_angvel_d=10.0,
                  w_accel_d=10.0).astype(F64)
    r_seq = ilqr.solve(z0, coeffs, p, SolverConfig(n_steps=40,
                                                   tol_grad=1e-9))
    reads = riccati.host_reads
    r_par = ilqr.solve(z0, coeffs, p, SolverConfig(
        n_steps=40, tol_grad=1e-9, horizon_parallel=True))
    assert bool(r_par.converged)
    assert riccati.host_reads > reads
    np.testing.assert_allclose(r_par.us.numpy(), r_seq.us.numpy(),
                               atol=1e-6)


def test_horizon_parallel_refuses_ddp():
    with pytest.raises(ValueError):
        ilqr.solve(_t(np.zeros(6)), _t(np.zeros(4)),
                   MPCParams().astype(F64),
                   SolverConfig(n_steps=8, horizon_parallel=True, ddp=True))
