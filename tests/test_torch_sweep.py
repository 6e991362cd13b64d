"""The port's Monte-Carlo weight-tuning sweep (`engine/sweep.py`) against
the JAX package's, both fed the same numpy scenarios (each package's
`make_random_scenarios` patched to return them) and the same numpy
candidate weights; and the candidate sampler's distribution."""

import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_ros_tpu.config import MPCParams as JMPCParams
from mpc_ros_tpu.config import SolverConfig as JSolverConfig
from mpc_ros_tpu.engine import sweep as jsweep
from mpc_ros_tpu_torch.config import MPCParams, SolverConfig
from mpc_ros_tpu_torch.engine import sweep
from mpc_ros_tpu_torch.testing import (numpy_scenarios, torch_threads,
                                       WEIGHT_NAMES)

N_CAND = 4
N_SCEN = 256
KW = dict(n_steps=20, max_sqp_iters=12, tol_grad=1e-4)



@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these tests run many small ops, and the suite
    runs in several processes at once (`testing.torch_threads`)."""
    with torch_threads(1):
        yield

def _candidates():
    rng = np.random.default_rng(3)
    base = dataclasses.asdict(JMPCParams())
    leaves = {k: np.full(N_CAND, float(v)) for k, v in base.items()}
    for name in WEIGHT_NAMES:
        leaves[name] = leaves[name] * np.exp(
            rng.uniform(-math.log(3.0), math.log(3.0), N_CAND))
    # one extreme candidate that the convergence bar should exclude
    leaves["w_angvel"][2] *= 40.0
    return leaves


@pytest.mark.parametrize("presort", [False, True],
                         ids=["unsorted", "presorted"])
def test_sweep_matches_jax(monkeypatch, presort):
    z0, coeffs = numpy_scenarios(4, N_SCEN)
    f32 = jnp.float32
    monkeypatch.setattr(
        jsweep, "make_random_scenarios",
        lambda key, n, dtype: (jnp.asarray(z0, dtype),
                               jnp.asarray(coeffs, dtype)))
    monkeypatch.setattr(
        sweep, "make_random_scenarios",
        lambda gen, n, dtype: (torch.tensor(z0, dtype=dtype),
                               torch.tensor(coeffs, dtype=dtype)))
    leaves = _candidates()
    import jax

    ref = jsweep.tuning_sweep(
        jax.random.PRNGKey(0),
        JMPCParams(**{k: jnp.asarray(v, f32) for k, v in leaves.items()}),
        N_SCEN, JSolverConfig(**KW), presort=presort)
    ours = sweep.tuning_sweep(
        torch.Generator().manual_seed(0),
        MPCParams.from_numpy(leaves, dtype=torch.float32), N_SCEN,
        SolverConfig(**KW), presort=presort)
    assert ours.best_index == ref.best_index
    # per-candidate means of solves held to the kernel_verify gates:
    # relative cost <= 1e-4, converged fraction within the flip gate
    np.testing.assert_allclose(ours.mean_cost.numpy(),
                               np.asarray(ref.mean_cost), rtol=1e-4)
    np.testing.assert_allclose(ours.converged_frac.numpy(),
                               np.asarray(ref.converged_frac), atol=0.002)
    np.testing.assert_allclose(ours.mean_terminal_cte.numpy(),
                               np.asarray(ref.mean_terminal_cte), rtol=1e-3,
                               atol=1e-6)
    np.testing.assert_allclose(ours.mean_iters.numpy(),
                               np.asarray(ref.mean_iters), atol=0.25)
    best = ours.best_params()
    assert float(best.w_cte) == pytest.approx(leaves["w_cte"][ours.best_index])


def test_sample_weight_candidates_log_uniform():
    base = MPCParams()
    c1 = sweep.sample_weight_candidates(torch.Generator().manual_seed(7),
                                        4096, base)
    c2 = sweep.sample_weight_candidates(torch.Generator().manual_seed(7),
                                        4096, base)
    for name in WEIGHT_NAMES:
        a = getattr(c1, name)
        torch.testing.assert_close(a, getattr(c2, name), rtol=0, atol=0)
        logf = torch.log(a / getattr(base, name))
        assert a.shape == (4096,) and a.dtype == torch.float32
        assert float(logf.abs().max()) <= math.log(3.0) + 1e-6
        # uniform on [-log 3, log 3]: mean 0, variance (log 3)^2 / 3
        assert abs(float(logf.mean())) < 0.05
        assert float(logf.var()) == pytest.approx(math.log(3.0) ** 2 / 3,
                                                  rel=0.1)
    # the other leaves are broadcast, unperturbed
    assert (c1.dt == base.dt).all() and c1.dt.shape == (4096,)


def test_sweep_falls_back_to_most_converged():
    """With a one-iteration cap no candidate reaches the 99% bar: the best
    is the most converged, not index 0."""
    cands = sweep.sample_weight_candidates(torch.Generator().manual_seed(1),
                                           2, MPCParams())
    sw = sweep.tuning_sweep(torch.Generator().manual_seed(2), cands, 128,
                            SolverConfig(n_steps=12, max_sqp_iters=1))
    assert float(sw.converged_frac.max()) < 0.99
    assert sw.best_index == int(torch.argmax(sw.converged_frac))


def test_sweep_off_the_lane_rule(monkeypatch):
    """3 candidates x 100 scenarios (300 lanes, not a multiple of 128) run
    on `batch_solve_swept` in both packages: in f64 the same scores, the
    same winner, equal iteration counts and convergence."""
    n_scen = 100
    z0, coeffs = numpy_scenarios(6, n_scen)
    monkeypatch.setattr(
        jsweep, "make_random_scenarios",
        lambda key, n, dtype: (jnp.asarray(z0, dtype),
                               jnp.asarray(coeffs, dtype)))
    monkeypatch.setattr(
        sweep, "make_random_scenarios",
        lambda gen, n, dtype: (torch.tensor(z0, dtype=dtype),
                               torch.tensor(coeffs, dtype=dtype)))
    leaves = {k: v[:3] for k, v in _candidates().items()}
    kw = dict(n_steps=12, max_sqp_iters=20)
    import jax

    ref = jsweep.tuning_sweep(
        jax.random.PRNGKey(0),
        JMPCParams(**{k: jnp.asarray(v) for k, v in leaves.items()}),
        n_scen, JSolverConfig(**kw), dtype=jnp.float64)
    ours = sweep.tuning_sweep(
        torch.Generator().manual_seed(0),
        MPCParams.from_numpy(leaves, dtype=torch.float64), n_scen,
        SolverConfig(**kw), dtype=torch.float64)
    assert ours.best_index == ref.best_index
    np.testing.assert_allclose(ours.mean_cost.numpy(),
                               np.asarray(ref.mean_cost), rtol=1e-10)
    # means of equal per-lane counts, summed in different orders
    np.testing.assert_allclose(ours.converged_frac.numpy(),
                               np.asarray(ref.converged_frac), rtol=1e-14)
    np.testing.assert_allclose(ours.mean_iters.numpy(),
                               np.asarray(ref.mean_iters), rtol=1e-14)
    np.testing.assert_allclose(ours.mean_terminal_cte.numpy(),
                               np.asarray(ref.mean_terminal_cte), rtol=1e-8)
