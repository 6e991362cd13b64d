"""The port's single-scenario SQP solver (`solver/ilqr.py`, batch-first)
and its box QP (`solver/boxqp.py`) against the JAX package's on the same
numpy inputs, in float64:

* each stage — the augmented rollout, the linearization and cost
  expansion (with blobs and per-knot setpoints), the terminal expansion,
  the autodiff dynamics Hessians (per-lane params mapped per lane), the
  control-limited backward pass (Gauss-Newton and gated DDP), the
  multi-alpha forward pass and the trajectory cost — to 1e-12, the JAX
  single-scenario functions mapped over the batch with `jax.vmap`;
* `solve_boxqp_2d` on random, fully clamped and tied problems: the same
  step, free set and masked inverse (the 1e-12 per clamped dimension and
  the first least violation, the JAX module's selection);
* `solve` end to end — diff-drive GN and DDP, the bicycle, blobs,
  setpoint profiles, a warm start and per-lane scaled weights — against
  JAX `batch_solve` (the vmapped `ilqr.solve`): equal `n_iters` and
  `converged` on every lane, controls within max(1e-8, twice the larger
  of the two solvers' responses to a one-ulp change of z0) (ROADMAP
  Queue 3 item 5), cost to rtol 1e-10; one scenario unbatched against
  JAX `solve_jit`;
* the port's scipy oracle (`solver/oracle.py::solve_oracle`, held to
  the JAX oracle in tests/test_torch_supervisors.py) at the bars of
  `tests/test_solver.py`, and float32 against float64 within 1e-3.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_ros_tpu.config import MPCParams as JMPCParams
from mpc_ros_tpu.config import SolverConfig as JSolverConfig
from mpc_ros_tpu.engine.batch import batch_solve as jbatch_solve
from mpc_ros_tpu.engine.batch import batch_solve_swept as jbatch_swept
from mpc_ros_tpu.models.base import get_model as jget_model
from mpc_ros_tpu.models.obstacles import GaussianObstacles as JBlobs
from mpc_ros_tpu.solver import boxqp as jboxqp
from mpc_ros_tpu.solver import ilqr as jilqr
from mpc_ros_tpu_torch.config import MPCParams, SolverConfig
from mpc_ros_tpu_torch.models.base import get_model
from mpc_ros_tpu_torch.models.obstacles import GaussianObstacles
from mpc_ros_tpu_torch.solver import boxqp, ilqr
from mpc_ros_tpu_torch.solver.oracle import solve_oracle
from mpc_ros_tpu_torch.testing import (numpy_blobs, numpy_refs,
                                       numpy_scenarios, scaled_weights,
                                       torch_threads)

B = 32
N = 12
T = N - 1
TOL = 1e-12
F64 = torch.float64



@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these tests run many small ops, and the suite
    runs in several processes at once (`testing.torch_threads`)."""
    with torch_threads(1):
        yield

def _t(a, dtype=F64):
    return torch.tensor(np.asarray(a), dtype=dtype)


def _close(ours, ref, tol=TOL):
    ours = ours.numpy() if isinstance(ours, torch.Tensor) else ours
    ref = np.asarray(ref)
    assert ours.shape == ref.shape, (ours.shape, ref.shape)
    scale = max(1.0, float(np.abs(ref).max()))
    assert float(np.abs(ours - ref).max()) <= tol * scale


def _lane_leaves(batch=B):
    """Every MPCParams leaf (B,): the weights scaled per lane x{0.5, 1, 4},
    the wheelbase varied."""
    full = {k: np.full(batch, float(v))
            for k, v in dataclasses.asdict(JMPCParams()).items()}
    full.update(scaled_weights(dataclasses.asdict(JMPCParams()), batch))
    full["lf"] = np.linspace(0.4, 0.6, batch)
    return full


def _params(leaves=None):
    """(JAX params, port params) in f64: shared defaults, or (B,) leaves."""
    if leaves is None:
        return JMPCParams().astype(jnp.float64), MPCParams().astype(F64)
    return (JMPCParams(**{k: jnp.asarray(v) for k, v in leaves.items()}),
            MPCParams.from_numpy(leaves, dtype=F64))


def _jp_lane(leaves):
    """The in_axes of a JAX MPCParams with every leaf mapped."""
    return JMPCParams(**{k: 0 for k in leaves})


# ------------------------------------------------------------ stage inputs


@pytest.fixture(scope="module")
def stage():
    """A mid-solve state of every lane: a random clipped control sequence,
    its rollout, random gains; per-lane params, blobs and profiles."""
    rng = np.random.default_rng(7)
    z0, coeffs = numpy_scenarios(2, B)
    us = np.clip(rng.normal(size=(B, T, 2)) * 0.6, -1.0, 1.0)
    ks = rng.normal(size=(B, T, 2)) * 0.2
    Ks = rng.normal(size=(B, T, 2, 8)) * 0.3
    Ks[..., 4] = 0.0
    blobs = numpy_blobs(4, B, 2)
    refs = numpy_refs(5, B, N)
    return dict(z0=z0, coeffs=coeffs, us=us, ks=ks, Ks=Ks, blobs=blobs,
                refs=refs, leaves=_lane_leaves())


def _rollouts(st, model, leaves):
    jp, tp = _params(leaves)
    jm, tm = jget_model(model), get_model(model)
    p_ax = None if leaves is None else _jp_lane(leaves)
    j = jax.vmap(lambda z, u, c, p: jilqr._rollout_aug(
        z, u, c, jnp.asarray(p.dt), 1.0, jm, p), in_axes=(0, 0, 0, p_ax))(
        jnp.asarray(st["z0"]), jnp.asarray(st["us"]),
        jnp.asarray(st["coeffs"]), jp)
    t = ilqr._rollout_aug(_t(st["z0"]), _t(st["us"]), _t(st["coeffs"]),
                          torch.as_tensor(tp.dt, dtype=F64), 1.0, tm, tp)
    return j, t, jp, tp, p_ax


@pytest.mark.parametrize("model,lanes", [("diff_drive", False),
                                         ("bicycle", True)],
                         ids=["diff_drive", "bicycle_lane_params"])
def test_rollout_linearization_and_hessians(stage, model, lanes):
    """The rollout, the per-stage Jacobians and cost quadratics (with blobs
    and profiles), the terminal expansion and the autodiff Hessians."""
    st = stage
    leaves = st["leaves"] if lanes else None
    jss, tss, jp, tp, p_ax = _rollouts(st, model, leaves)
    _close(tss, jss)
    jm, tm = jget_model(model), get_model(model)
    jb = JBlobs.from_sigmas(*(jnp.asarray(a) for a in st["blobs"]))
    tb = GaussianObstacles.from_sigmas(*(_t(a) for a in st["blobs"]))
    jus, tus = jnp.asarray(st["us"]), _t(st["us"])
    jc, tc = jnp.asarray(st["coeffs"]), _t(st["coeffs"])
    tdt = torch.as_tensor(tp.dt, dtype=F64)
    for blobs, refs in ((False, False), (True, True)):
        jout = jax.vmap(
            lambda s, u, c, p, b, r: jilqr._linearize_and_expand(
                s, u, c, p, jnp.asarray(p.dt), 1.0, jm, None,
                b if blobs else None, r if refs else None),
            in_axes=(0, 0, 0, p_ax, 0, 0))(jss, jus, jc, jp, jb,
                                           jnp.asarray(st["refs"]))
        tout = ilqr._linearize_and_expand(
            tss, tus, tc, tp, tdt, 1.0, tm, None, tb if blobs else None,
            _t(st["refs"]) if refs else None)
        for a, b in zip(tout, jout):
            _close(a, b)
        jV = jax.vmap(lambda s, p, b, r: jilqr._terminal_expansion(
            s, p, None, b if blobs else None, r if refs else None),
            in_axes=(0, p_ax, 0, 0))(jss[:, -1], jp, jb,
                                     jnp.asarray(st["refs"])[:, -1])
        tV = ilqr._terminal_expansion(tss[:, -1], tp, None,
                                      tb if blobs else None,
                                      _t(st["refs"])[:, -1] if refs else None)
        for a, b in zip(tV, jV):
            _close(a, b)
    jH = jax.vmap(lambda s, u, c, p: jilqr.step_hessians(
        s, u, c, jnp.asarray(p.dt), 1.0, jm, p),
        in_axes=(0, 0, 0, p_ax))(jss, jus, jc, jp)
    tH = ilqr.step_hessians(tss, tus, tc, tdt, 1.0, tm, tp)
    assert tH.shape == (B, T, 8, 10, 10) and tH.dtype == F64
    _close(tH, jH)


@pytest.mark.parametrize("mode", ["gn", "ddp"])
def test_backward_and_forward_passes(stage, mode):
    """The control-limited backward pass (with the per-lane DDP gate, mu
    and weight-scale normalization), the multi-alpha forward pass and the
    trajectory cost with blobs and profiles."""
    st = stage
    leaves = st["leaves"]
    jss, tss, jp, tp, p_ax = _rollouts(st, "diff_drive", leaves)
    jm, tm = jget_model("diff_drive"), get_model("diff_drive")
    jus, tus = jnp.asarray(st["us"]), _t(st["us"])
    jc, tc = jnp.asarray(st["coeffs"]), _t(st["coeffs"])
    tdt = torch.as_tensor(tp.dt, dtype=F64)
    jb = JBlobs.from_sigmas(*(jnp.asarray(a) for a in st["blobs"]))
    tb = GaussianObstacles.from_sigmas(*(_t(a) for a in st["blobs"]))
    jr, tr = jnp.asarray(st["refs"]), _t(st["refs"])
    rng = np.random.default_rng(11)
    mu = 10.0 ** rng.uniform(-6, 0, size=B)
    gate = (rng.uniform(size=B) < 0.5).astype(np.float64)
    iscl = 1.0 / np.maximum(1.0, sum(leaves[k] for k in (
        "w_cte", "w_etheta", "w_vel", "w_angvel", "w_accel", "w_angvel_d",
        "w_accel_d")) / 470.0)
    lb = np.broadcast_to(np.array([-1.0, -1.0]), (B, 2))
    ddp = mode == "ddp"

    def jback(s, u, c, p, m, g, i, b, r):
        A, Bm, ls, lu, lss, luu, lus = jilqr._linearize_and_expand(
            s, u, c, p, jnp.asarray(p.dt), 1.0, jm, None, b, r)
        Vs, Vss = jilqr._terminal_expansion(s[-1], p, None, b, r[-1])
        H = jilqr.step_hessians(s, u, c, jnp.asarray(p.dt), 1.0, jm, p) \
            if ddp else None
        return jilqr.backward_pass(A, Bm, ls, lu, lss, luu, lus, Vs, Vss, u,
                                   -jnp.ones(2), jnp.ones(2), m, H=H,
                                   ddp_gate_val=g if ddp else None,
                                   inv_scale=i)

    jout = jax.vmap(jback, in_axes=(0, 0, 0, p_ax, 0, 0, 0, 0, 0))(
        jss, jus, jc, jp, jnp.asarray(mu), jnp.asarray(gate),
        jnp.asarray(iscl), jb, jr)
    lin = ilqr._linearize_and_expand(tss, tus, tc, tp, tdt, 1.0, tm, None,
                                     tb, tr)
    Vs, Vss = ilqr._terminal_expansion(tss[:, -1], tp, None, tb, tr[:, -1])
    H = ilqr.step_hessians(tss, tus, tc, tdt, 1.0, tm, tp) if ddp else None
    tout = ilqr.backward_pass(*lin, Vs, Vss, tus, _t(lb), _t(-lb), _t(mu),
                              H=H, ddp_gate_val=_t(gate) if ddp else None,
                              inv_scale=_t(iscl))
    for a, b in zip(tout, jout):
        _close(a, b)

    alphas = 0.5 ** np.arange(5)
    jf = jax.vmap(lambda s, u, k, K, z, c, p, b, r:
                  jilqr.forward_pass_multi_alpha(
                      s, u, k, K, jnp.asarray(alphas), z, c, p,
                      jnp.asarray(p.dt), -jnp.ones(2), jnp.ones(2), 1.0, jm,
                      None, b, r),
                  in_axes=(0, 0, 0, 0, 0, 0, p_ax, 0, 0))(
        jss, jus, jnp.asarray(st["ks"]), jnp.asarray(st["Ks"]),
        jnp.asarray(st["z0"]), jc, jp, jb, jr)
    tf = ilqr.forward_pass_multi_alpha(
        tss, tus, _t(st["ks"]), _t(st["Ks"]), _t(alphas), _t(st["z0"]), tc,
        tp, tdt, _t(lb), _t(-lb), 1.0, tm, None, tb, tr)
    for a, b in zip(tf, jf):
        _close(a, b)


def test_boxqp_matches_random_clamped_and_tied():
    """Random SPD problems with random boxes; fully clamped ones (the
    unconstrained step far outside a small box); tied ones (q = 0 with a
    box edge at 0, where the free and the clamped combination both hold
    with zero violation and the 1e-12 per clamped dimension decides)."""
    rng = np.random.default_rng(3)
    n = 600
    L = rng.normal(size=(n, 2, 2))
    Q = L @ np.swapaxes(L, -1, -2) + 0.1 * np.eye(2)
    q = rng.normal(size=(n, 2)) * 3.0
    lb = -rng.uniform(0.05, 1.5, size=(n, 2))
    ub = rng.uniform(0.05, 1.5, size=(n, 2))
    q[200:400] *= 1e3                       # clamped on both dims
    q[400:] = 0.0                           # the optimum d = 0 ...
    lb[400:500, 0] = 0.0                    # ... on a box edge: ties
    ub[500:, 1] = 0.0
    jout = jax.vmap(jboxqp.solve_boxqp_2d)(*(jnp.asarray(a) for a in
                                             (Q, q, lb, ub)))
    tout = boxqp.solve_boxqp_2d(*(_t(a) for a in (Q, q, lb, ub)))
    for a, b in zip(tout, jout):
        _close(a, b)
    free = tout[1].numpy()
    assert (free[200:400] == 0).all()
    assert (free[400:] == 1).all()          # ties prefer the free combo
    _close(boxqp.inv2(_t(Q)), jboxqp.inv2(jnp.asarray(Q)))


# -------------------------------------------------------------- end to end


def _one_ulp_response(run, z0, out):
    """The largest |d us| of a solve (`run`: z0 -> result with .us) when z0
    moves by one ulp."""
    worst = 0.0
    for k in range(2):
        flip = np.random.default_rng(100 + k).choice([-1.0, 1.0],
                                                     size=z0.shape)
        moved = run(z0 * (1.0 + 2.0 ** -52 * flip))
        worst = max(worst, float(np.abs(np.asarray(moved.us)
                                        - np.asarray(out.us)).max()))
    return worst


def assert_f64_bars(ref, ours, run=None, z0=None, jrun=None):
    """Equal iterations and convergence on every lane, controls within
    max(1e-8, twice the response to a one-ulp change of z0), cost to rtol
    1e-10. The response is the larger of the two solvers' own (`run`,
    `jrun`): a lane on an active-set near-tie moves by a quantum of ~5e-9
    under a one-ulp change on either side, and the two sides may sit two
    quanta apart."""
    np.testing.assert_array_equal(ours.n_iters.numpy(),
                                  np.asarray(ref.n_iters))
    np.testing.assert_array_equal(ours.converged.numpy(),
                                  np.asarray(ref.converged))
    dus = float(np.abs(ours.us.numpy() - np.asarray(ref.us)).max())
    if dus > 1e-8:
        ulp = _one_ulp_response(run, z0, ours)
        if jrun is not None:
            ulp = max(ulp, _one_ulp_response(jrun, z0, ref))
        assert dus <= 2.0 * ulp, (dus, ulp)
    np.testing.assert_allclose(ours.cost.numpy(), np.asarray(ref.cost),
                               rtol=1e-10)


CASES = ["gn", "ddp", "bicycle", "blobs", "refs", "u_init", "lane_weights"]


@pytest.mark.parametrize("case", CASES)
def test_solve_matches_jax_f64(case):
    z0, coeffs = numpy_scenarios(1, B)
    kw = dict(n_steps=N, max_sqp_iters=30, ddp=case != "gn")
    if case == "bicycle":
        kw["model"] = "bicycle"
    jx, tx = {}, {}
    if case == "blobs":
        bl = numpy_blobs(2, B, 2)
        jx["blobs"] = JBlobs.from_sigmas(*(jnp.asarray(a) for a in bl))
        tx["blobs"] = GaussianObstacles.from_sigmas(*(_t(a) for a in bl))
    if case == "refs":
        r = numpy_refs(3, B, N)
        jx["refs"], tx["refs"] = jnp.asarray(r), _t(r)
    if case == "u_init":
        u = np.random.default_rng(5).normal(size=(B, T, 2)) * 3.0  # clipped
        jx["u_init"], tx["u_init"] = jnp.asarray(u), _t(u)
    jcfg, cfg = JSolverConfig(**kw), SolverConfig(**kw)
    jp, tp = _params(_lane_leaves() if case == "lane_weights" else None)

    def jrun(z):
        if case == "lane_weights":
            return jbatch_swept(jnp.asarray(z), jnp.asarray(coeffs), jp, jcfg)
        return jbatch_solve(jnp.asarray(z), jnp.asarray(coeffs), jp, jcfg,
                            **jx)

    def run(z):
        return ilqr.solve(_t(z), _t(coeffs), tp, cfg, **tx)

    ref, ours = jrun(z0), run(z0)
    assert ours.us.shape == (B, T, 2) and ours.n_iters.dtype == torch.int32
    assert_f64_bars(ref, ours, run, z0, jrun)
    assert float(ours.converged.double().mean()) > 0.95


def test_single_scenario_unbatched_matches_solve_jit():
    """One scenario, z0 (6,): an unbatched result equal to JAX solve_jit's,
    with a cold and a warm start."""
    z0, coeffs = numpy_scenarios(8, 1)
    z0, coeffs = z0[0], coeffs[0]
    cfg, jcfg = SolverConfig(n_steps=N), JSolverConfig(n_steps=N)
    jp, tp = _params()
    ref = jilqr.solve_jit(jnp.asarray(z0), jnp.asarray(coeffs), jp, jcfg)
    ours = ilqr.solve(_t(z0), _t(coeffs), tp, cfg)
    assert ours.us.shape == (T, 2) and ours.cost.shape == ()
    assert int(ours.n_iters) == int(ref.n_iters)
    assert bool(ours.converged) == bool(ref.converged)
    _close(ours.us, ref.us, 1e-8)
    warm = torch.cat([ours.us[1:], ours.us[-1:]])
    w = ilqr.solve(_t(z0), _t(coeffs), tp, cfg, u_init=warm)
    assert int(w.n_iters) <= int(ours.n_iters)
    np.testing.assert_allclose(float(w.cost), float(ours.cost), rtol=1e-6)


def _scenario(curve=0.2, v0=0.3):
    coeffs = np.array([0.05, -0.1, curve, -0.02])
    z0 = np.array([0.0, 0.0, 0.0, v0, coeffs[0], float(np.arctan(coeffs[1]))])
    return z0, coeffs


def _params64(**kw):
    base = dict(dt=0.1, ref_vel=0.5, w_cte=100.0, w_etheta=100.0,
                w_vel=100.0, w_angvel=100.0, w_accel=50.0, w_angvel_d=10.0,
                w_accel_d=10.0, max_angvel=1.0, max_throttle=1.0)
    base.update(kw)
    return JMPCParams(**base).astype(jnp.float64), MPCParams(**base)


@pytest.mark.parametrize("case", ["n10", "saturated"])
def test_matches_oracle(case):
    """The bars of tests/test_solver.py: controls within 1e-3 of the scipy
    oracle's full-NLP optimum (cost to 1e-5 unsaturated), the controls in
    their box."""
    if case == "saturated":
        z0, coeffs = _scenario(curve=0.6)
        z0[4] = 0.5
        jp, tp = _params64(ref_vel=0.8, w_cte=500.0, w_angvel=10.0,
                           w_accel=10.0, w_angvel_d=1.0, w_accel_d=1.0,
                           max_angvel=0.3, max_throttle=0.5)
        cfg = SolverConfig(n_steps=12, max_sqp_iters=300, tol_grad=1e-10)
        jcfg = JSolverConfig(n_steps=12, max_sqp_iters=300, tol_grad=1e-10)
    else:
        z0, coeffs = _scenario()
        jp, tp = _params64()
        cfg = SolverConfig(n_steps=10, max_sqp_iters=200, tol_grad=1e-10)
        jcfg = JSolverConfig(n_steps=10, max_sqp_iters=200, tol_grad=1e-10)
    res = ilqr.solve(_t(z0), _t(coeffs), tp, cfg)
    orc = solve_oracle(z0, coeffs, tp, cfg)
    assert orc.success, orc.status
    dev = float(np.max(np.abs(res.us.numpy() - orc.us)))
    assert dev < 1e-3, dev
    if case == "saturated":
        assert float(res.us[:, 0].abs().max()) > 0.3 - 1e-6
    else:
        np.testing.assert_allclose(float(res.cost), orc.cost, rtol=1e-5)
    assert float(res.us[:, 0].abs().max()) <= float(tp.max_angvel) + 1e-12
    assert float(res.us[:, 1].abs().max()) <= float(tp.max_throttle) + 1e-12


def test_f32_close_to_f64():
    """The same batch in float32 and float64: relative cost within 1e-3 and
    controls within tests/test_solver.py's 5e-3, lane by lane."""
    z0, coeffs = numpy_scenarios(9, B)
    cfg = SolverConfig(n_steps=N, max_sqp_iters=30, ddp=True, tol_grad=1e-4)
    r64 = ilqr.solve(_t(z0), _t(coeffs), MPCParams(), cfg)
    r32 = ilqr.solve(_t(z0, torch.float32), _t(coeffs, torch.float32),
                     MPCParams(), cfg)
    assert r32.us.dtype == torch.float32
    rel = ((r32.cost.double() - r64.cost).abs()
           / (1.0 + r64.cost.abs()))
    assert float(rel.max()) <= 1e-3, float(rel.max())
    assert float((r32.us.double() - r64.us).abs().max()) < 5e-3
    assert bool(r32.converged.all())


def test_done_lanes_keep_their_state():
    """A lane that is done keeps its state, its iteration count and its
    certificate while the others go on: each lane of a batch equals its
    solve alone, bit for bit, whatever its neighbours."""
    z0, coeffs = numpy_scenarios(10, 16)
    cfg = SolverConfig(n_steps=N, max_sqp_iters=30)
    both = ilqr.solve(_t(z0), _t(coeffs), MPCParams(), cfg)
    first, last = int(both.n_iters.argmin()), int(both.n_iters.argmax())
    assert int(both.n_iters[first]) < int(both.n_iters[last])
    for i in (first, last):
        alone = ilqr.solve(_t(z0[i:i + 1]), _t(coeffs[i:i + 1]),
                           MPCParams(), cfg)
        for f in ("us", "cost", "n_iters", "converged", "grad_norm", "reg"):
            assert torch.equal(getattr(alone, f)[0], getattr(both, f)[i]), f
    before = ilqr.host_reads
    ilqr.solve(_t(z0), _t(coeffs), MPCParams(), cfg)
    # one read per iteration run and the read that ends the loop
    assert ilqr.host_reads - before == int(both.n_iters.max()) + 1
