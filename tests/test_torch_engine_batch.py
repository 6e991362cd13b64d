"""The registry-generic batch engine (`engine/batch.py`: `batch_solve`,
`batch_solve_swept`) and the paths that run on it — `batch_solve_lane`
with per-knot profiles off the kernel route, the tuning sweep of a custom
family — against the JAX package's on the same numpy inputs, in float64;
and a `model_from_step` family (a speed-coupled tricycle) solved with the
gated DDP against Gauss-Newton, as tests/test_ddp.py holds it.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_ros_tpu.config import MPCParams as JMPCParams
from mpc_ros_tpu.config import SolverConfig as JSolverConfig
from mpc_ros_tpu.engine import sweep as jsweep
from mpc_ros_tpu.engine.batch import batch_solve as jbatch_solve
from mpc_ros_tpu.engine.batch import batch_solve_swept as jbatch_swept
from mpc_ros_tpu.models.base import model_from_step as jmodel_from_step
from mpc_ros_tpu.models.obstacles import GaussianObstacles as JBlobs
from mpc_ros_tpu.ops.poly import polyeval as jpolyeval
from mpc_ros_tpu.solver.batch_lane import batch_solve_lane as jbatch_lane
from mpc_ros_tpu_torch.config import MPCParams, SolverConfig
from mpc_ros_tpu_torch.engine import (batch_solve, batch_solve_lane,
                                      batch_solve_swept, sweep)
from mpc_ros_tpu_torch.models.base import model_from_step
from mpc_ros_tpu_torch.models.obstacles import GaussianObstacles
from mpc_ros_tpu_torch.ops.poly import polyeval
from mpc_ros_tpu_torch.testing import (numpy_blobs, numpy_refs,
                                       numpy_scenarios, scaled_weights,
                                       torch_threads)
from test_torch_ilqr import assert_f64_bars

B = 48
N = 12
F64 = torch.float64



@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these tests run many small ops, and the suite
    runs in several processes at once (`testing.torch_threads`)."""
    with torch_threads(1):
        yield

def _t(a, dtype=F64):
    return torch.tensor(np.asarray(a), dtype=dtype)


def _lane_leaves(batch):
    full = {k: np.full(batch, float(v))
            for k, v in dataclasses.asdict(JMPCParams()).items()}
    full.update(scaled_weights(dataclasses.asdict(JMPCParams()), batch))
    full["lf"] = np.linspace(0.4, 0.6, batch)
    return full


def _same(run, jrun, z0):
    """The port's solve `run(z0)` against JAX's `jrun(z0)` at the f64 bars
    of tests/test_torch_ilqr.py (controls within max(1e-8, twice the
    larger one-ulp response))."""
    ours, ref = run(z0), jrun(z0)
    assert_f64_bars(ref, ours, run, z0, jrun)
    return ours


def test_batch_solve_profiles_with_blobs_matches_jax():
    """Obstacle-aware trajectory tracking: per-lane profiles and blobs
    composed, with a warm start, gated DDP."""
    z0, coeffs = numpy_scenarios(21, B)
    refs = numpy_refs(22, B, N)
    bl = numpy_blobs(23, B, 2)
    u0 = np.random.default_rng(24).normal(size=(B, N - 1, 2)) * 0.3
    kw = dict(n_steps=N, max_sqp_iters=30, ddp=True)
    ours = _same(
        lambda z: batch_solve(
            _t(z), _t(coeffs), MPCParams(), SolverConfig(**kw),
            u_init=_t(u0), refs=_t(refs),
            blobs=GaussianObstacles.from_sigmas(*(_t(a) for a in bl))),
        lambda z: jbatch_solve(
            jnp.asarray(z), jnp.asarray(coeffs),
            JMPCParams().astype(jnp.float64), JSolverConfig(**kw),
            u_init=jnp.asarray(u0), refs=jnp.asarray(refs),
            blobs=JBlobs.from_sigmas(*(jnp.asarray(a) for a in bl))), z0)
    assert float(ours.converged.double().mean()) > 0.95


@pytest.mark.parametrize("model", ["diff_drive", "bicycle"])
def test_batch_solve_swept_matches_jax(model):
    """Every MPCParams leaf per lane (weights scaled x{0.5, 1, 4}, the
    wheelbase varied), mapped per lane through the DDP Hessians."""
    z0, coeffs = numpy_scenarios(25, B)
    leaves = _lane_leaves(B)
    kw = dict(n_steps=N, max_sqp_iters=30, ddp=True, model=model)
    _same(lambda z: batch_solve_swept(
              _t(z), _t(coeffs), MPCParams.from_numpy(leaves, dtype=F64),
              SolverConfig(**kw)),
          lambda z: jbatch_swept(
              jnp.asarray(z), jnp.asarray(coeffs),
              JMPCParams(**{k: jnp.asarray(v) for k, v in leaves.items()}),
              JSolverConfig(**kw)), z0)


@pytest.mark.parametrize("params", ["shared", "lane"])
def test_batch_solve_lane_profiles_off_the_kernel_route(params):
    """`batch_solve_lane(refs=..., blobs=...)` in f64 (off the kernel
    rule) takes the JAX package's fallback: shared params through
    `batch_solve`, per-lane params mapped per lane; blobs compose."""
    z0, coeffs = numpy_scenarios(26, B)
    refs = numpy_refs(27, B, N)
    bl = numpy_blobs(28, B, 2)
    leaves = _lane_leaves(B) if params == "lane" else {}
    kw = dict(n_steps=N, max_sqp_iters=30, backward="xla")
    _same(lambda z: batch_solve_lane(
              _t(z), _t(coeffs), MPCParams.from_numpy(leaves, dtype=F64),
              SolverConfig(**kw), refs=_t(refs),
              blobs=GaussianObstacles.from_sigmas(*(_t(a) for a in bl))),
          lambda z: jbatch_lane(
              jnp.asarray(z), jnp.asarray(coeffs),
              JMPCParams(**{k: jnp.asarray(v) for k, v in leaves.items()}
                         ).astype(jnp.float64),
              JSolverConfig(**kw), refs=jnp.asarray(refs),
              blobs=JBlobs.from_sigmas(*(jnp.asarray(a) for a in bl))), z0)


def _tricycle_steps():
    """A mildly speed-coupled steering family, written once per package."""
    def jstep(z, u, coeffs, dt, sign, p):
        x, y, th, v, cte, eth = (z[..., i] for i in range(6))
        w, a = u[..., 0], u[..., 1]
        dt = jnp.asarray(dt, z.dtype)
        dth = w * (1.0 + 0.1 * v) * dt
        return jnp.stack([x + v * jnp.cos(th) * dt, y + v * jnp.sin(th) * dt,
                          th + dth, v + a * dt,
                          (jpolyeval(coeffs, x) - y)
                          + sign * v * jnp.sin(eth) * dt, eth + dth], axis=-1)

    def tstep(z, u, coeffs, dt, sign, p):
        x, y, th, v, cte, eth = (z[..., i] for i in range(6))
        w, a = u[..., 0], u[..., 1]
        dt = torch.as_tensor(dt, dtype=z.dtype, device=z.device)
        dth = w * (1.0 + 0.1 * v) * dt
        return torch.stack([x + v * torch.cos(th) * dt,
                            y + v * torch.sin(th) * dt, th + dth, v + a * dt,
                            (polyeval(coeffs, x) - y)
                            + sign * v * torch.sin(eth) * dt, eth + dth],
                           dim=-1)

    jmodel_from_step("tricycle_ddp_test", jstep,
                     lambda p, dtype: (jnp.asarray([-1.0, -1.0], dtype),
                                       jnp.asarray([1.0, 1.0], dtype)),
                     allow_override=True)
    model_from_step("tricycle_ddp_test", tstep,
                    lambda p, dtype, device=None: (
                        torch.tensor([-1.0, -1.0], dtype=dtype,
                                     device=device),
                        torch.tensor([1.0, 1.0], dtype=dtype,
                                     device=device)),
                    allow_override=True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_custom_family_ddp_against_gn(dtype):
    """tests/test_ddp.py's tricycle: gated DDP converges on >= 98% of the
    lanes and reaches Gauss-Newton's optimum (relative cost < 1e-4) in no
    more iterations on average; in f64 the DDP solve equals JAX's."""
    _tricycle_steps()
    z0, coeffs = numpy_scenarios(29, 64)
    kw = dict(n_steps=N, max_sqp_iters=40, ls_iters=5, tol_grad=1e-4,
              model="tricycle_ddp_test")
    gn = batch_solve(_t(z0, dtype), _t(coeffs, dtype), MPCParams(),
                     SolverConfig(**kw, ddp=False))
    ddp = batch_solve(_t(z0, dtype), _t(coeffs, dtype), MPCParams(),
                      SolverConfig(**kw, ddp=True))
    assert float(ddp.converged.double().mean()) >= 0.98
    rel = (ddp.cost - gn.cost).abs() / (1.0 + gn.cost.abs())
    assert float(rel.max()) < 1e-4
    assert float(ddp.n_iters.double().mean()) <= float(
        gn.n_iters.double().mean())
    if dtype == torch.float64:
        _same(lambda z: batch_solve(_t(z), _t(coeffs), MPCParams(),
                                    SolverConfig(**kw, ddp=True)),
              lambda z: jbatch_solve(jnp.asarray(z), jnp.asarray(coeffs),
                                     JMPCParams().astype(jnp.float64),
                                     JSolverConfig(**kw, ddp=True)), z0)


def test_tuning_sweep_of_a_custom_family(monkeypatch):
    """A sweep over the tricycle (a family the lane solver does not take)
    runs on `batch_solve_swept` in both packages: the same winner and
    per-candidate means."""
    _tricycle_steps()
    n_scen = 64
    z0, coeffs = numpy_scenarios(30, n_scen)
    monkeypatch.setattr(
        jsweep, "make_random_scenarios",
        lambda key, n, dtype: (jnp.asarray(z0, dtype),
                               jnp.asarray(coeffs, dtype)))
    monkeypatch.setattr(
        sweep, "make_random_scenarios",
        lambda gen, n, dtype: (torch.tensor(z0, dtype=dtype),
                               torch.tensor(coeffs, dtype=dtype)))
    leaves = {k: np.full(2, float(v))
              for k, v in dataclasses.asdict(JMPCParams()).items()}
    leaves["w_cte"] = np.array([100.0, 400.0])
    kw = dict(n_steps=N, max_sqp_iters=30, model="tricycle_ddp_test")
    import jax

    ref = jsweep.tuning_sweep(
        jax.random.PRNGKey(0),
        JMPCParams(**{k: jnp.asarray(v) for k, v in leaves.items()}),
        n_scen, JSolverConfig(**kw), dtype=jnp.float64)
    ours = sweep.tuning_sweep(
        torch.Generator().manual_seed(0),
        MPCParams.from_numpy(leaves, dtype=F64), n_scen,
        SolverConfig(**kw), dtype=F64)
    assert ours.best_index == ref.best_index
    np.testing.assert_allclose(ours.mean_cost.numpy(),
                               np.asarray(ref.mean_cost), rtol=1e-10)
    np.testing.assert_allclose(ours.mean_iters.numpy(),
                               np.asarray(ref.mean_iters), rtol=1e-14)
