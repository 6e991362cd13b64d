"""The port's batch_solve_lane (on CPU tensors "auto" is the XLA lane
path, as in the JAX package) against the JAX package's lane solver
(backward="xla") on the same numpy scenarios, held to the solver parity
gates."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_ros_tpu.config import MPCParams as JMPCParams
from mpc_ros_tpu.config import SolverConfig as JSolverConfig
from mpc_ros_tpu.engine.batch import analytic_u_init as janalytic
from mpc_ros_tpu.solver.batch_lane import batch_solve_lane as jsolve
from mpc_ros_tpu_torch.config import MPCParams, SolverConfig
from mpc_ros_tpu_torch.engine import (analytic_u_init, batch_solve,
                                      make_random_scenarios)
from mpc_ros_tpu_torch.solver import ilqr
from mpc_ros_tpu_torch.solver.batch_lane import batch_solve_lane
from mpc_ros_tpu_torch.testing import (numpy_refs, numpy_scenarios,
                                       scaled_weights, torch_threads)
from mpc_ros_tpu_torch.verify import parity_gates

B = 128
N = 12



@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these tests run many small ops, and the suite
    runs in several processes at once (`testing.torch_threads`)."""
    with torch_threads(1):
        yield

def _solve_both(kw, leaves=None, u_init=None, seed=0):
    z0, coeffs = numpy_scenarios(seed, B)
    leaves = leaves or {}
    f32 = jnp.float32
    jp = JMPCParams(**leaves).astype(f32)
    r_j = jsolve(jnp.asarray(z0, f32), jnp.asarray(coeffs, f32), jp,
                 JSolverConfig(backward="xla", **kw),
                 u_init=None if u_init is None else jnp.asarray(u_init, f32))
    p = MPCParams.from_numpy({k: np.asarray(v) for k, v in leaves.items()},
                             dtype=torch.float32)
    t = lambda a: torch.tensor(a, dtype=torch.float32)
    r_t = batch_solve_lane(t(z0), t(coeffs), p, SolverConfig(**kw),
                           u_init=None if u_init is None else t(u_init))
    return r_j, r_t


def _gates(r_j, r_t):
    return parity_gates(r_t.us.numpy(), r_t.cost.numpy(),
                        r_t.converged.numpy(), r_t.n_iters.numpy(),
                        np.asarray(r_j.us), np.asarray(r_j.cost),
                        np.asarray(r_j.converged), np.asarray(r_j.n_iters),
                        N)


PROD = dict(n_steps=N, max_sqp_iters=12, ls_iters=4, tol_grad=1e-4)


def test_production_config_matches_jax_lane_solver():
    r_j, r_t = _solve_both(PROD)
    g = _gates(r_j, r_t)
    assert g["ok"], g
    assert tuple(r_t.us.shape) == (B, N - 1, 2)
    assert tuple(r_t.zs.shape) == (B, N, 6)
    assert r_t.n_iters.dtype == torch.int32
    assert r_t.converged.dtype == torch.bool
    np.testing.assert_allclose(r_t.control.numpy(), r_t.us[:, 0].numpy())
    # zs is the state rollout of us: same gate as the controls
    du = np.abs(r_t.zs.numpy() - np.asarray(r_j.zs)).max()
    assert du <= 2e-3, du


def test_gn_exact_trig_lane_weights_match_jax_lane_solver():
    leaves = scaled_weights(dataclasses.asdict(JMPCParams()), B)
    r_j, r_t = _solve_both(dict(PROD, ddp=False, ls_iters=8, trig="exact"),
                           leaves=leaves, seed=3)
    g = _gates(r_j, r_t)
    assert g["ok"], g


def test_u_init_is_clipped_and_analytic_init_matches():
    z0, coeffs = numpy_scenarios(4, B)
    cfg_kw = dict(PROD)
    # the analytic cold start equals the JAX package's (f64)
    jp = JMPCParams(max_angvel=np.linspace(0.5, 1.5, B)).astype(jnp.float64)
    p = MPCParams.from_numpy({"max_angvel": np.linspace(0.5, 1.5, B)})
    ours = analytic_u_init(torch.tensor(z0), torch.tensor(coeffs), p,
                           SolverConfig(**cfg_kw))
    ref = janalytic(jnp.asarray(z0), jnp.asarray(coeffs), jp,
                    JSolverConfig(**cfg_kw))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-12)
    # an out-of-bounds warm start is clipped to the bounds on both sides
    u_init = np.random.default_rng(0).normal(size=(B, N - 1, 2)) * 3.0
    r_j, r_t = _solve_both(cfg_kw, u_init=u_init, seed=4)
    g = _gates(r_j, r_t)
    assert g["ok"], g


def test_random_scenarios_distribution():
    gen = torch.Generator().manual_seed(0)
    z0s, coeffs = make_random_scenarios(gen, 20000)
    assert z0s.shape == (20000, 6) and coeffs.shape == (20000, 4)
    assert z0s.dtype == torch.float32
    np.testing.assert_allclose(coeffs.std(0).numpy(),
                               [0.1, 0.2, 0.25, 0.05], rtol=0.05)
    v0 = z0s[:, 3]
    assert 0.0 <= float(v0.min()) and float(v0.max()) <= 0.8
    assert abs(float(v0.mean()) - 0.4) < 0.01
    assert torch.all(z0s[:, :3] == 0)
    np.testing.assert_allclose(
        float((z0s[:, 4] - coeffs[:, 0]).std()), 0.09, rtol=0.05)
    # the same seed gives the same draws
    z2, c2 = make_random_scenarios(torch.Generator().manual_seed(0), 20000)
    assert torch.equal(z0s, z2) and torch.equal(coeffs, c2)


@pytest.mark.parametrize("kw,exc,match", [
    (dict(omaps=object(), refs=object()), ValueError, "megakernel path"),
    (dict(model="tricycle"), ValueError, "lane-specialized families"),
    (dict(solve="horizon_parallel"), None, None),
    (dict(solve="horizon_parallel", ddp=True), ValueError,
     "not supported with horizon_parallel"),
], ids=["omaps_refs", "unknown_model", "ilqr_horizon_parallel",
        "ilqr_ddp_horizon_parallel"])
def test_unported_paths_raise(kw, exc, match):
    """Grid obstacle maps with per-knot profiles refuse as the JAX package
    does (grid maps themselves run: tests/test_torch_grid_solve.py); a
    family the lane stages are not specialized for raises; the single-
    scenario solver keeps the JAX package's refusal of DDP under
    horizon_parallel. The horizon-parallel backward itself is ported
    (`exc` None: it runs and returns finite controls;
    tests/test_torch_riccati.py holds it against JAX)."""
    z0, coeffs = numpy_scenarios(0, B)
    solve = kw.pop("solve", None)
    cfg_kw = {k: kw.pop(k) for k in ("backward", "model", "ddp") if k in kw}
    if solve is not None:
        cfg_kw["horizon_parallel"] = True
        if exc is None:
            res = ilqr.solve(torch.tensor(z0), torch.tensor(coeffs),
                             MPCParams(), SolverConfig(n_steps=N, **cfg_kw))
            assert res.us.shape == (B, N - 1, 2)
            assert bool(torch.isfinite(res.us).all())
            return
        with pytest.raises(exc, match=match):
            ilqr.solve(torch.tensor(z0), torch.tensor(coeffs), MPCParams(),
                       SolverConfig(n_steps=N, **cfg_kw), **kw)
        return
    with pytest.raises(exc, match=match):
        batch_solve_lane(torch.tensor(z0), torch.tensor(coeffs), MPCParams(),
                         SolverConfig(n_steps=N, **cfg_kw), **kw)


@pytest.mark.parametrize("backward", ["xla", "auto"],
                         ids=["refs_xla", "refs"])
def test_refs_off_the_kernel_route(backward):
    """Per-knot setpoint profiles off the kernel route (f64 here) run on
    the registry-generic engine, as in the JAX package: the result is
    `engine.batch_solve`'s bit for bit, and it tracks the profile (its
    terminal speed moves toward the profile's last knot)."""
    z0, coeffs = (torch.tensor(a) for a in numpy_scenarios(0, B))
    refs = torch.tensor(numpy_refs(1, B, N, noise=0.0))
    cfg = SolverConfig(n_steps=N, max_sqp_iters=20, backward=backward)
    res = batch_solve_lane(z0, coeffs, MPCParams(), cfg, refs=refs)
    direct = batch_solve(z0, coeffs, MPCParams(), cfg, refs=refs)
    for f in ("us", "zs", "cost", "converged", "n_iters"):
        assert torch.equal(getattr(res, f), getattr(direct, f)), f
    assert float(res.converged.double().mean()) > 0.95
    scalar = batch_solve_lane(z0, coeffs, MPCParams(), cfg)
    v_end = refs[:, -1, 2]
    assert float((res.zs[:, -1, 3] - v_end).abs().mean()) < float(
        (scalar.zs[:, -1, 3] - v_end).abs().mean())
