"""The bicycle family in the port against the JAX package, on the same
numpy inputs:

* `models.bicycle`: the step, the steering/throttle bounds and the yaw
  rate in f64, to 1e-12;
* the XLA lane path's bicycle rows (`_step_bl`, `_stage_linexp_bl`, the
  DDP (v, delta) cross term) against JAX `batch_solve_lane(backward=
  "xla")` in f64, with a scalar and a per-lane wheelbase: conv and
  iterations equal on every lane, controls within max(1e-8, twice the
  port's own response to a one-ulp change of z0);
* K1 stage (g), `solve_mega_plain` with `model="bicycle"`, against the JAX
  megakernel in Pallas interpret mode in f64 at the same bar, with exact
  and with fast trig; and the fast trig's half-angle rotation on the
  extended domain of tests/test_pallas_kernels.py (2 rad per step), where
  fast and exact agree to 1e-3 in f32 and the port's fast rollout matches
  JAX's;
* bicycle serving against JAX `receding_horizon_rollout` in f64: controls
  and plant states to 1e-7.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_ros_tpu.config import MPCParams as JMPCParams
from mpc_ros_tpu.config import SolverConfig as JSolverConfig
from mpc_ros_tpu.engine.receding import receding_horizon_rollout as jroll
from mpc_ros_tpu.kernels.backward_fused_pallas import pack_params as jpack
from mpc_ros_tpu.kernels.solve_pallas import solve_pallas
from mpc_ros_tpu.models import bicycle as jbic
from mpc_ros_tpu.solver import batch_lane as jbl
from mpc_ros_tpu_torch.config import MPCParams, SolverConfig
from mpc_ros_tpu_torch.engine import receding_horizon_rollout
from mpc_ros_tpu_torch.kernels import solve_mega
from mpc_ros_tpu_torch.kernels.pack import pack_params
from mpc_ros_tpu_torch.models import bicycle, get_model
from mpc_ros_tpu_torch.solver import batch_lane as tbl
from mpc_ros_tpu_torch.testing import (numpy_scenarios, torch_threads)

TOL = 1e-12
B = 128
N = 12
LANE_LF = {"lf": np.linspace(0.3, 0.8, B), "max_steer": 0.5}



@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these tests run many small ops, and the suite
    runs in several processes at once (`testing.torch_threads`)."""
    with torch_threads(1):
        yield

def _t(a, dtype=torch.float64):
    return torch.tensor(np.asarray(a), dtype=dtype)


def _params(leaves, dtype=torch.float64):
    return MPCParams.from_numpy({k: np.asarray(v) for k, v in
                                 leaves.items()}, dtype=dtype)


# ---------------------------------------------------------------- model


@pytest.mark.parametrize("per_lane", [False, True])
def test_bicycle_step_bounds_and_yaw_rate(per_lane):
    rng = np.random.default_rng(0)
    n = 9
    z = rng.normal(size=(n, 6))
    u = rng.normal(size=(n, 2)) * 0.5
    c = rng.normal(size=(n, 4)) * 0.2
    leaves = (dict(lf=np.linspace(0.3, 0.8, n),
                   max_steer=np.linspace(0.2, 0.6, n), max_throttle=0.7)
              if per_lane else dict(lf=0.4))
    jp = JMPCParams(**leaves)
    p = _params(leaves)
    for sign in (1.0, -1.0):
        ref = jbic.step(jnp.asarray(z), jnp.asarray(u), jnp.asarray(c), 0.1,
                        sign, jp)
        ours = bicycle.step(_t(z), _t(u), _t(c), 0.1, sign, p)
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=0,
                                   atol=TOL)
        # the registry's entry is the same function
        reg = get_model("bicycle").step(_t(z), _t(u), _t(c), 0.1, sign, p)
        np.testing.assert_array_equal(reg.numpy(), ours.numpy())
    lb, ub = get_model("bicycle").control_bounds(p, torch.float64)
    jlb, jub = jbic._control_bounds(jp, jnp.float64)
    assert tuple(lb.shape) == jlb.shape == ((2, n) if per_lane else (2,))
    np.testing.assert_array_equal(lb.numpy(), np.asarray(jlb))
    np.testing.assert_array_equal(ub.numpy(), np.asarray(jub))
    np.testing.assert_allclose(
        bicycle._yaw_rate(_t(z[:, 3]), _t(u[:, 0]), p).numpy(),
        np.asarray(jbic._yaw_rate(jnp.asarray(z[:, 3]),
                                  jnp.asarray(u[:, 0]), jp)),
        rtol=0, atol=TOL)


# -------------------------------------------------------- XLA lane path


def _lane_both(kw, leaves, seed):
    z0, coeffs = numpy_scenarios(seed, B)
    r_j = jbl.batch_solve_lane(jnp.asarray(z0), jnp.asarray(coeffs),
                               JMPCParams(**leaves).astype(jnp.float64),
                               JSolverConfig(**kw))
    p = _params(leaves)
    cfg = SolverConfig(**kw)
    r_t = tbl.batch_solve_lane(_t(z0), _t(coeffs), p, cfg)
    ulp = 0.0
    for k in range(2):
        flip = np.random.default_rng(100 + k).choice([-1.0, 1.0],
                                                     size=z0.shape)
        r_u = tbl.batch_solve_lane(_t(z0 * (1.0 + 2.0 ** -52 * flip)),
                                   _t(coeffs), p, cfg)
        ulp = max(ulp, float((r_u.us - r_t.us).abs().max()))
    return r_j, r_t, ulp


@pytest.mark.parametrize("lf", ["scalar", "per_lane"])
def test_xla_path_bicycle_matches_jax_f64(lf):
    """Gated DDP (the (v, delta) cross term in Qus[0, 3]) with the default
    wheelbase; Gauss-Newton with a per-lane wheelbase and steering bound."""
    kw = dict(n_steps=N, max_sqp_iters=15, backward="xla", model="bicycle",
              ddp=lf == "scalar")
    leaves = {} if lf == "scalar" else LANE_LF
    r_j, r_t, ulp = _lane_both(kw, leaves, seed=1)
    np.testing.assert_array_equal(r_t.converged.numpy(),
                                  np.asarray(r_j.converged))
    np.testing.assert_array_equal(r_t.n_iters.numpy(),
                                  np.asarray(r_j.n_iters))
    dus = float(np.abs(r_t.us.numpy() - np.asarray(r_j.us)).max())
    assert dus <= max(1e-8, 2.0 * ulp), (dus, ulp)
    np.testing.assert_allclose(r_t.cost.numpy(), np.asarray(r_j.cost),
                               rtol=1e-10)
    assert r_t.converged.numpy().mean() > 0.95
    # the steering bound is the bicycle's
    bound = 0.6 if lf == "scalar" else 0.5
    assert float(r_t.us[..., 0].abs().max()) <= bound + 1e-12


def test_pallas_with_bicycle_runs_the_xla_path(monkeypatch):
    """The two-kernel route is diff-drive only: "pallas" with the bicycle
    runs the XLA lane path (f32, B % 128 == 0, so only the family keeps it
    off the route); the route's loop refuses the bicycle outright."""
    def boom(*a, **kw):
        raise AssertionError("the two-kernel route must not run")

    monkeypatch.setattr(tbl, "solve_two_kernel", boom)
    z0, coeffs = numpy_scenarios(2, B)
    f32 = torch.float32
    cfg = SolverConfig(n_steps=N, max_sqp_iters=12, backward="pallas",
                       model="bicycle", tol_grad=1e-4)
    res = tbl.batch_solve_lane(_t(z0, f32), _t(coeffs, f32), MPCParams(),
                               cfg)
    xla = tbl.LaneSQP(_t(z0, f32), _t(coeffs, f32), MPCParams(), cfg).run()
    torch.testing.assert_close(res.us, xla.us, rtol=0, atol=0)
    with pytest.raises(ValueError, match="diff-drive only"):
        tbl.LaneSQP(_t(z0, f32), _t(coeffs, f32), MPCParams(), cfg,
                    two_kernel=tbl.two_kernel_stages(plain=True))


# ------------------------------------------------------ K1 stage (g)


def _mega_inputs(z0, coeffs, leaves, dtype, u0):
    """Batch-last kernel inputs with the bicycle's bounds."""
    p = _params(leaves, dtype)
    lb, ub = get_model("bicycle").control_bounds(p, dtype)
    lb = (lb if lb.dim() == 2 else lb[:, None]).expand(2, z0.shape[0])
    ub = (ub if ub.dim() == 2 else ub[:, None]).expand(2, z0.shape[0])
    return ([z0.T.copy(), coeffs.T.copy(), lb.numpy().copy(),
             ub.numpy().copy(), u0], p)


def _both_mega(arrays, leaves, kw, f64=True):
    jdt, tdt = ((jnp.float64, torch.float64) if f64 else
                (jnp.float32, torch.float32))
    zT, cT, lb, ub, u0 = arrays
    Bn = zT.shape[-1]
    ref = solve_pallas(*(jnp.asarray(a, jdt) for a in (zT, cT)),
                       jpack(JMPCParams(**leaves), Bn, jdt),
                       *(jnp.asarray(a, jdt) for a in (lb, ub, u0)),
                       JSolverConfig(model="bicycle", **kw), dtype=jdt,
                       interpret=True)
    ours = solve_mega.solve_mega_plain(
        *(_t(a, tdt) for a in (zT, cT)),
        pack_params(_params(leaves), Bn, tdt),
        *(_t(a, tdt) for a in (lb, ub, u0)),
        SolverConfig(model="bicycle", **kw))
    return [np.asarray(a) for a in ref], [a.numpy() for a in ours]


@pytest.mark.parametrize("trig", ["exact", "fast"])
def test_plain_kernel_bicycle_matches_interpret_f64(trig):
    """Gated DDP with a per-lane wheelbase: the heading rows' A[2,3] =
    A[5,3] = delta dt / lf, B rows 2/5 scaled by v / lf, the DDP Qus[0, 3]
    term; with fast trig, the half-angle rotation."""
    z0, coeffs = numpy_scenarios(3, B)
    arrays, _ = _mega_inputs(z0, coeffs, LANE_LF, torch.float64,
                             np.zeros((N - 1, 2, B)))
    kw = dict(n_steps=N, max_sqp_iters=15, ddp=True, trig=trig)
    ref, ours = _both_mega(arrays, LANE_LF, kw)
    np.testing.assert_array_equal(ours[3], ref[3])
    np.testing.assert_array_equal(ours[4], ref[4])
    assert np.abs(ours[1] - ref[1]).max() <= 1e-8
    assert np.abs(ours[0] - ref[0]).max() <= 1e-8
    np.testing.assert_allclose(ours[2], ref[2], rtol=1e-10)
    assert ref[3].mean() > 0.95


def test_bicycle_fast_trig_extended_domain():
    """v = 10, lf = 0.25, saturated steering 0.5: 2 rad of heading per
    step. The half-angle Taylor rotation keeps the fast rollout within 1e-3
    of the exact one in f32 after one SQP iteration (the check of
    tests/test_pallas_kernels.py::test_bicycle_fast_trig_extended_domain),
    and the port's fast solve equals JAX's to 1e-4 (f32 rounding carried
    through 9 steps of a 10 m/s vehicle)."""
    z0, coeffs = numpy_scenarios(11, B)
    z0[:, 3] = 10.0
    leaves = dict(lf=0.25, max_steer=0.5, max_throttle=1.0)
    u0 = np.concatenate([np.full((9, 1, B), 0.5), np.zeros((9, 1, B))],
                        axis=1)
    arrays, _ = _mega_inputs(z0, coeffs, leaves, torch.float64, u0)
    outs = {}
    for trig in ("fast", "exact"):
        kw = dict(n_steps=10, max_sqp_iters=1, ls_iters=1, tol_grad=1e-9,
                  trig=trig)
        outs[trig] = _both_mega(arrays, leaves, kw, f64=False)
    ds = np.abs(outs["fast"][1][0] - outs["exact"][1][0]).max()
    assert ds < 1e-3, ds
    ref, ours = outs["fast"]
    assert np.abs(ours[0] - ref[0]).max() < 1e-4
    # the increment is 2 rad: the heading wraps past pi within the horizon
    assert np.abs(ours[0][:, 2]).max() > np.pi


# -------------------------------------------------------------- serving


def test_bicycle_serving_matches_jax_f64():
    """3 warm-started cycles of bicycle robots, both sides on their XLA
    lane paths in f64; the plant steps with the bicycle's kinematics. The
    wheelbase is shared: the JAX package's plant step maps one robot at a
    time and takes scalar parameters only."""
    z0, coeffs = numpy_scenarios(12, B)
    leaves = dict(lf=0.4, max_steer=0.5)
    kw = dict(n_steps=N, max_sqp_iters=15, tol_grad=1e-7, model="bicycle")
    tr_j = jroll(jnp.asarray(z0), jnp.asarray(coeffs),
                 JMPCParams(**leaves).astype(jnp.float64),
                 JSolverConfig(**kw), n_cycles=3)
    tr_t = receding_horizon_rollout(_t(z0), _t(coeffs), _params(leaves),
                                    SolverConfig(**kw), n_cycles=3)
    np.testing.assert_allclose(tr_t.us.numpy(), np.asarray(tr_j.us),
                               rtol=0, atol=1e-7)
    np.testing.assert_allclose(tr_t.zs.numpy(), np.asarray(tr_j.zs),
                               rtol=0, atol=1e-7)
    np.testing.assert_array_equal(tr_t.iters.numpy(), np.asarray(tr_j.iters))
    # the plant is the bicycle: its heading advanced by v delta dt / lf
    z1 = bicycle.step(tr_t.zs[0], tr_t.us[0], _t(coeffs), 0.1, 1.0,
                      _params(leaves))
    torch.testing.assert_close(tr_t.zs[1], z1, rtol=0, atol=0)
