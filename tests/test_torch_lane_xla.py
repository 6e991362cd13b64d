"""The port's lane-major SQP loop against the JAX package's, on the same
numpy inputs: the XLA-path stages in f64 to 1e-12, the XLA lane path end
to end (f64: conv and iterations equal on every lane, |dus| <= 1e-8; f32
at N=30: the solver parity gates), the two-kernel route (port on the CPU,
the plain kernels, against JAX with both Pallas kernels in interpret
mode), the backward dispatch rule, and serving through both loops."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mpc_ros_tpu.kernels.backward_fused_pallas as jbfp
import mpc_ros_tpu.kernels.forward_pallas as jfp
from mpc_ros_tpu.config import MPCParams as JMPCParams
from mpc_ros_tpu.config import SolverConfig as JSolverConfig
from mpc_ros_tpu.engine.receding import receding_horizon_rollout as jroll
from mpc_ros_tpu.models.costs import scaled_solver_knobs as jknobs
from mpc_ros_tpu.solver import batch_lane as jbl
from mpc_ros_tpu_torch.config import MPCParams, SolverConfig
from mpc_ros_tpu_torch.engine import receding_horizon_rollout
from mpc_ros_tpu_torch.kernels.solve_mega import solve_mega_plain
from mpc_ros_tpu_torch.models.costs import scaled_solver_knobs
from mpc_ros_tpu_torch.solver import batch_lane as tbl
from mpc_ros_tpu_torch.testing import (numpy_scenarios, scaled_weights,
                                       torch_threads)
from mpc_ros_tpu_torch.verify import parity_gates

B = 128
N = 12
T = N - 1
F64 = (jnp.float64, torch.float64)
F32 = (jnp.float32, torch.float32)



@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these tests run many small ops, and the suite
    runs in several processes at once (`testing.torch_threads`)."""
    with torch_threads(1):
        yield

def _lane_leaves():
    return scaled_weights(dataclasses.asdict(JMPCParams()), B)


def _params(leaves, dtypes):
    jdt, tdt = dtypes
    jp = JMPCParams(**leaves).astype(jdt)
    tp = MPCParams.from_numpy({k: np.asarray(v) for k, v in leaves.items()},
                              dtype=tdt)
    return jp, tp


def _close(a, b, tol=1e-12):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    scale = max(1.0, float(np.abs(b).max()))
    err = float(np.abs(a - b).max())
    assert err <= tol * scale, (err, scale)


# ------------------------------------------------------------ stages, f64


@pytest.fixture(scope="module")
def stage_inputs():
    rng = np.random.default_rng(0)
    z0, coeffs = numpy_scenarios(0, B)
    us = rng.normal(size=(T, 2, B)) * 0.4
    s0 = np.concatenate([z0.T, np.zeros((2, B))])
    leaves = _lane_leaves()
    jp, tp = _params(leaves, F64)
    ssj, costj = jbl._rollout_and_cost(jnp.asarray(s0), jnp.asarray(us),
                                       jnp.asarray(coeffs.T), 0.1, 1.0, jp,
                                       jnp.float64, T)
    return dict(s0=s0, us=us, cT=coeffs.T.copy(), jp=jp, tp=tp,
                ss=np.asarray(ssj), cost=np.asarray(costj),
                lb=-rng.uniform(0.4, 1.2, size=(2, B)),
                ub=rng.uniform(0.4, 1.2, size=(2, B)),
                mu=10.0 ** rng.uniform(-6.0, 0.0, size=B),
                mask=(rng.uniform(size=B) > 0.5).astype(np.float64), rng=rng)


def _t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def _dt():
    return torch.tensor(0.1, dtype=torch.float64)


def test_rollout_and_terminal_match(stage_inputs):
    si = stage_inputs
    ss, cost = tbl._rollout_and_cost(_t(si["s0"]), _t(si["us"]), _t(si["cT"]),
                                     _dt(), 1.0, si["tp"], torch.float64, T)
    _close(ss, si["ss"])
    _close(cost, si["cost"])
    ref = jbl._terminal_bl(jnp.asarray(si["ss"][-1]), si["jp"], jnp.float64)
    ours = tbl._terminal_bl(_t(si["ss"][-1]), si["tp"], torch.float64)
    for a, b in zip(ours, ref):
        _close(a, b)


def test_boxqp_and_inv2_match(stage_inputs):
    rng = stage_inputs["rng"]
    L = rng.normal(size=(2, 2, B))
    Q = np.einsum("ikb,jkb->ijb", L, L) + 0.1 * np.eye(2)[:, :, None]
    q = rng.normal(size=(2, B)) * 2.0
    lb = -rng.uniform(0.1, 1.0, size=(2, B))
    ub = rng.uniform(0.1, 1.0, size=(2, B))
    Qus = rng.normal(size=(2, 8, B))
    ref = jbl._boxqp_bl(*(jnp.asarray(a) for a in (Q, q, lb, ub, Qus)))
    ours = tbl._boxqp_bl(*(_t(a) for a in (Q, q, lb, ub, Qus)))
    for a, b in zip(ours, ref):
        _close(a, b)
    free = np.asarray(ref[1])
    assert 0.1 < free.mean() < 0.9          # both clamped and free dims
    _close(tbl._inv2_bl(_t(Q)), jbl._inv2_bl(jnp.asarray(Q)))


@pytest.mark.parametrize("mode", ["gn", "ddp_mask_scaled"])
def test_backward_matches(stage_inputs, mode):
    si = stage_inputs
    ddp = mode != "gn"
    jp, tp = si["jp"], si["tp"]
    V_s, V_ss = jbl._terminal_bl(jnp.asarray(si["ss"][-1]), jp, jnp.float64)
    _, _, j_inv, _ = jknobs(JSolverConfig(), jp, jnp.float64)
    _, _, t_inv, _ = scaled_solver_knobs(SolverConfig(), tp, torch.float64)
    np.testing.assert_allclose(t_inv.numpy(), np.asarray(j_inv), rtol=0,
                               atol=1e-15)
    kw_j = dict(ddp=ddp, ddp_mask=jnp.asarray(si["mask"]) if ddp else None,
                inv_scale=j_inv if ddp else None)
    kw_t = dict(ddp=ddp, ddp_mask=_t(si["mask"]) if ddp else None,
                inv_scale=t_inv if ddp else None)
    args = ("ss", "us", "cT")
    ref = jbl._backward_bl(*(jnp.asarray(si[k]) for k in args), 0.1, 1.0, jp,
                           V_s, V_ss, jnp.asarray(si["lb"]),
                           jnp.asarray(si["ub"]), jnp.asarray(si["mu"]),
                           **kw_j)
    ours = tbl._backward_bl(*(_t(si[k]) for k in args), _dt(), 1.0, tp,
                            _t(V_s), _t(V_ss), _t(si["lb"]), _t(si["ub"]),
                            _t(si["mu"]), **kw_t)
    for a, b in zip(ours, ref):
        _close(a, b)


def test_forward_multi_alpha_matches(stage_inputs):
    si = stage_inputs
    jp, tp = si["jp"], si["tp"]
    V_s, V_ss = jbl._terminal_bl(jnp.asarray(si["ss"][-1]), jp, jnp.float64)
    ks, Ks, _, _, _ = jbl._backward_bl(
        jnp.asarray(si["ss"]), jnp.asarray(si["us"]), jnp.asarray(si["cT"]),
        0.1, 1.0, jp, V_s, V_ss, jnp.asarray(si["lb"]),
        jnp.asarray(si["ub"]), jnp.asarray(si["mu"]))
    alphas = 0.5 ** np.arange(8.0)
    ref = jbl._forward_multi_alpha_bl(
        jnp.asarray(si["ss"]), jnp.asarray(si["us"]), ks, Ks,
        jnp.asarray(alphas), jnp.asarray(si["cT"]), 0.1, 1.0,
        jnp.asarray(si["lb"]), jnp.asarray(si["ub"]), jp, jnp.float64)
    ours = tbl._forward_multi_alpha_bl(
        _t(si["ss"]), _t(si["us"]), _t(ks), _t(Ks), _t(alphas), _t(si["cT"]),
        _dt(), 1.0, _t(si["lb"]), _t(si["ub"]), tp, torch.float64)
    for a, b in zip(ours, ref):
        _close(a, b)


# ------------------------------------------------------------- end to end


def solve_both(kw, dtypes, leaves=None, u_init=None, seed=0, n=N, jkw=None,
               batch=B):
    """The JAX and the port solve of one numpy batch; in f64 the port
    also solves it with z0 moved by one ulp (`r_t.ulp_dus`: the largest
    |dus| that moves, the batch's own f64 noise floor)."""
    z0, coeffs = numpy_scenarios(seed, batch)
    jdt, tdt = dtypes
    jp, tp = _params(leaves or {}, dtypes)
    r_j = jbl.batch_solve_lane(
        jnp.asarray(z0, jdt), jnp.asarray(coeffs, jdt), jp,
        JSolverConfig(n_steps=n, **(jkw or kw)),
        u_init=None if u_init is None else jnp.asarray(u_init, jdt))
    t = lambda a: torch.tensor(a, dtype=tdt)
    cfg = SolverConfig(n_steps=n, **kw)
    u0 = None if u_init is None else t(u_init)
    r_t = tbl.batch_solve_lane(t(z0), t(coeffs), tp, cfg, u_init=u0)
    if tdt == torch.float64:
        r_t.ulp_dus = 0.0
        for k in range(2):
            flip = np.random.default_rng(100 + k).choice([-1.0, 1.0],
                                                         size=z0.shape)
            r_u = tbl.batch_solve_lane(t(z0 * (1.0 + 2.0 ** -52 * flip)),
                                       t(coeffs), tp, cfg, u_init=u0)
            r_t.ulp_dus = max(r_t.ulp_dus,
                              float((r_u.us - r_t.us).abs().max()))
    return r_j, r_t


def assert_f64_bars(r_j, r_t):
    """Every lane converges alike in the same number of iterations, and
    the controls agree to 1e-8 — or, where the batch holds a lane on an
    active-set near-tie, to twice the port's own response to a one-ulp
    change of z0 (measured 0.7-1.4e-8 on one or two lanes of 128 at
    N=12: such a lane's answer moves that far under any rounding change,
    while the median lane moves ~1e-16)."""
    np.testing.assert_array_equal(r_t.converged.numpy(),
                                  np.asarray(r_j.converged))
    np.testing.assert_array_equal(r_t.n_iters.numpy(),
                                  np.asarray(r_j.n_iters))
    dus = float(np.abs(r_t.us.numpy() - np.asarray(r_j.us)).max())
    assert dus <= max(1e-8, 2.0 * r_t.ulp_dus), (dus, r_t.ulp_dus)
    np.testing.assert_allclose(r_t.cost.numpy(), np.asarray(r_j.cost),
                               rtol=1e-10)


def gates(r_j, r_t, n=N):
    return parity_gates(r_t.us.numpy(), r_t.cost.numpy(),
                        r_t.converged.numpy(), r_t.n_iters.numpy(),
                        np.asarray(r_j.us), np.asarray(r_j.cost),
                        np.asarray(r_j.converged), np.asarray(r_j.n_iters), n)


XLA = dict(backward="xla", max_sqp_iters=12)
U_INIT = np.random.default_rng(5).normal(size=(B, T, 2)) * 3.0


@pytest.mark.parametrize("case", ["gn", "ddp", "lane_weights", "done_frac",
                                  "u_init"])
def test_xla_path_matches_jax_f64(case):
    kw = dict(XLA, ddp=case != "gn")
    extra = {}
    if case == "lane_weights":
        extra["leaves"] = _lane_leaves()
        kw["scale_adaptive"] = True
    if case == "done_frac":
        kw["done_frac"] = 0.9
    if case == "u_init":
        extra["u_init"] = U_INIT           # out of bounds: clipped
    r_j, r_t = solve_both(kw, F64, seed=1, **extra)
    assert_f64_bars(r_j, r_t)
    assert r_t.us.dtype == torch.float64 and r_t.n_iters.dtype == torch.int32
    if case == "done_frac":
        conv = r_t.converged.numpy().mean()
        assert 0.9 <= conv < 1.0, conv      # the loop stopped early
    else:
        assert r_t.converged.numpy().mean() > 0.95


def test_xla_path_matches_jax_f32_n30():
    kw = dict(XLA, tol_grad=1e-4)
    r_j, r_t = solve_both(kw, F32, seed=2, n=30)
    g = gates(r_j, r_t, n=30)
    assert g["ok"], g
    assert r_t.converged.float().mean() >= 0.99


def _interpret(monkeypatch):
    """Run the JAX package's two Pallas kernels in interpret mode, by
    patching its modules' attributes for the duration of one test."""
    orig_b = jbfp.backward_fused_pallas
    orig_f = jfp.forward_pallas
    monkeypatch.setattr(jbfp, "backward_fused_pallas", lambda *a, **kw:
                        orig_b(*a, **{**kw, "interpret": True}))
    monkeypatch.setattr(jfp, "forward_pallas", lambda *a, **kw:
                        orig_f(*a, **{**kw, "interpret": True}))


def test_two_kernel_route_matches_jax_interpret(monkeypatch):
    _interpret(monkeypatch)
    kw = dict(backward="pallas", max_sqp_iters=10, tol_grad=1e-4)
    r_j, r_t = solve_both(kw, F32, seed=3)
    g = gates(r_j, r_t)
    assert g["ok"], g
    assert r_t.converged.float().mean() >= 0.99


# ---------------------------------------------------------------- dispatch


def _boom(*a, **kw):
    raise AssertionError("this route must not run")


def test_auto_on_cpu_runs_the_xla_path(monkeypatch):
    monkeypatch.setattr(tbl, "solve_mega_scheduled", _boom)
    monkeypatch.setattr(tbl, "solve_two_kernel", _boom)
    r_j, r_t = solve_both(dict(max_sqp_iters=12), F64, seed=4,
                          jkw=dict(max_sqp_iters=12, backward="xla"))
    assert_f64_bars(r_j, r_t)


def test_mega_runs_the_plain_megakernel(monkeypatch):
    monkeypatch.setattr(tbl, "LaneSQP", _boom)
    z0, coeffs = numpy_scenarios(4, B)
    cfg = SolverConfig(n_steps=N, max_sqp_iters=6, backward="mega")
    t = lambda a: torch.tensor(a, dtype=torch.float32)
    res = tbl.batch_solve_lane(t(z0), t(coeffs), MPCParams(), cfg)
    ins = tbl.lane_inputs(t(z0), t(coeffs), MPCParams(), cfg)
    us = solve_mega_plain(*ins, cfg)[1]
    torch.testing.assert_close(res.us, us.permute(2, 0, 1), rtol=0, atol=0)


PALLAS = dict(backward="pallas", max_sqp_iters=12, tol_grad=1e-4)


@pytest.mark.parametrize("off", ["b100", "f64"])
def test_pallas_off_the_kernels_runs_xla_with_route_knobs(monkeypatch, off):
    monkeypatch.setattr(tbl, "solve_two_kernel", _boom)
    if off == "f64":
        # f64 leaves the kernels; the loop matches JAX "pallas" at the f64
        # bars (in f64, "xla"'s auto knobs are GN with 8 candidates too)
        r_j, r_t = solve_both(dict(PALLAS, tol_grad=None), F64, seed=6)
        assert_f64_bars(r_j, r_t)
        return
    # B % 128 != 0 leaves the kernels in f32: the route's knobs (GN, 8
    # candidates) on the XLA loop match JAX "pallas" at the parity gates;
    # the solve is the XLA loop's with those knobs named, not with "xla"'s
    # auto knobs (gated DDP, 4 candidates)
    r_j, r_t = solve_both(PALLAS, F32, seed=6, batch=100)
    g = gates(r_j, r_t)
    assert g["ok"], g
    z0, coeffs = numpy_scenarios(6, 100)
    t = lambda a: torch.tensor(a, dtype=torch.float32)

    def port(**kw):
        cfg = SolverConfig(n_steps=N, **dict(PALLAS, **kw))
        return tbl.batch_solve_lane(t(z0), t(coeffs), MPCParams(), cfg).us

    assert torch.equal(r_t.us, port(backward="xla", ddp=False, ls_iters=8))
    assert not torch.equal(r_t.us, port(backward="xla"))
    for n_steps in (12, 48):
        route = SolverConfig(n_steps=n_steps, backward="pallas")
        xla = SolverConfig(n_steps=n_steps, backward="xla")
        assert route.ls_for(torch.float32) == 8
        assert not route.ddp_for(torch.float32)
        assert route.mu_init_for(torch.float32) == 1e-6   # no long-horizon
    assert SolverConfig(n_steps=48).mu_init_for(torch.float32) == 1e-2
    assert xla.ls_for(torch.float32) == 4 and xla.ddp_for(torch.float32)


def test_pallas_with_explicit_ddp_raises():
    z0, coeffs = numpy_scenarios(0, B)
    with pytest.raises(ValueError, match="two-kernel"):
        tbl.batch_solve_lane(
            torch.tensor(z0, dtype=torch.float32),
            torch.tensor(coeffs, dtype=torch.float32), MPCParams(),
            SolverConfig(n_steps=N, backward="pallas", ddp=True))


# ---------------------------------------------------------------- serving


@pytest.mark.parametrize("backward,dtypes", [("pallas", F32), ("xla", F64)],
                         ids=["pallas_f32", "xla_f64"])
def test_serving_matches_jax(monkeypatch, backward, dtypes):
    """Three warm-started cycles through each loop, held cycle by cycle to
    the parity gates. "xla" runs in f64: in f32 the closed loop carries
    the two XLA implementations' rounding differences into the next
    cycle's problem (1.9e-5 in the plant state at cycle 2, one lane of 128
    then differs by 1.08e-4 in relative cost against the gate's 1e-4,
    made for two solves of the same inputs), while in f64 the loops agree
    to ~2e-9."""
    _interpret(monkeypatch)
    jdt, tdt = dtypes
    z0, coeffs = numpy_scenarios(11, B)
    kw = dict(n_steps=N, max_sqp_iters=12, tol_grad=1e-4, backward=backward)
    tr_j = jroll(jnp.asarray(z0, jdt), jnp.asarray(coeffs, jdt),
                 JMPCParams().astype(jdt), JSolverConfig(**kw), n_cycles=3)
    t = lambda a: torch.tensor(a, dtype=tdt)
    tr_t = receding_horizon_rollout(t(z0), t(coeffs), MPCParams().astype(tdt),
                                    SolverConfig(**kw), n_cycles=3)
    assert float(tr_t.converged.float().mean()) >= 0.999
    assert tr_t.us.dtype == tdt
    for c in range(3):
        # the JAX trace carries no convergence flags: the port's flags
        # stand on both sides; the cost-flip gate still applies
        conv = tr_t.converged[c].numpy()
        g = parity_gates(tr_t.us[c].numpy()[:, None, :],
                         tr_t.costs[c].numpy(), conv, tr_t.iters[c].numpy(),
                         np.asarray(tr_j.us[c])[:, None, :],
                         np.asarray(tr_j.costs[c]), conv,
                         np.asarray(tr_j.iters[c]), N)
        assert g["ok"], (c, g)
        dz = float(np.abs(tr_t.zs[c].numpy() - np.asarray(tr_j.zs[c])).max())
        assert dz <= (2e-3 if tdt == torch.float32 else 1e-8), (c, dz)
