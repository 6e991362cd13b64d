"""The port's vehicle families with their Jacobians and the autodiff-built
families (`models.base.model_from_step`) against the JAX package's, in
float64:

* the closed-form Jacobians, the augmented-state step and its Jacobians
  and the rollout of the diff drive and the bicycle equal the JAX ones
  (1e-12), batched and per-lane;
* `make_jacobians` (forward-mode autodiff, `torch.func.jacfwd` under
  `vmap`) equals the closed forms, batched and unbatched;
* a family built from a step function alone (a velocity-damped drive)
  solves as the JAX package's same family does, one scenario and a
  batch; the registry refuses a silent override.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_ros_tpu.config import MPCParams as JMPCParams
from mpc_ros_tpu.config import SolverConfig as JSolverConfig
from mpc_ros_tpu.engine.batch import batch_solve as jbatch_solve
from mpc_ros_tpu.models import bicycle as jbicycle
from mpc_ros_tpu.models import diff_drive as jdd
from mpc_ros_tpu.models.base import get_model as jget_model
from mpc_ros_tpu.models.base import model_from_step as jmodel_from_step
from mpc_ros_tpu.solver.ilqr import solve_jit as jsolve_jit
from mpc_ros_tpu_torch.config import MPCParams, SolverConfig
from mpc_ros_tpu_torch.engine import batch_solve
from mpc_ros_tpu_torch.models import (available_models, bicycle, diff_drive,
                                      get_model, make_jacobians,
                                      model_from_step)
from mpc_ros_tpu_torch.solver import ilqr
from mpc_ros_tpu_torch.testing import (numpy_scenarios, torch_threads)

TOL = 1e-12
F64 = torch.float64



@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these tests run many small ops, and the suite
    runs in several processes at once (`testing.torch_threads`)."""
    with torch_threads(1):
        yield

def _t(a):
    return torch.tensor(np.asarray(a), dtype=F64)


def _close(ours, ref, tol=TOL):
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=0,
                               atol=tol)


def _rand_zu(seed, batch):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=batch + (6,)), rng.normal(size=batch + (2,)),
            0.3 * rng.normal(size=batch + (4,)))


@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_diff_drive_matches_jax(sign):
    z, u, c = _rand_zu(0, (17,))
    for ours, ref in zip(diff_drive.step_jacobians(_t(z), _t(u), _t(c), 0.1,
                                                   sign),
                         jax.vmap(lambda a, b, cc: jdd.step_jacobians(
                             a, b, cc, 0.1, sign))(z, u, c)):
        _close(ours, ref)
    s = np.concatenate([z, 0.5 * u], axis=-1)
    _close(diff_drive.aug_step(_t(s), _t(u), _t(c), 0.1, sign),
           jax.vmap(lambda a, b, cc: jdd.aug_step(a, b, cc, 0.1, sign))(
               s, u, c))
    for ours, ref in zip(
            diff_drive.aug_step_jacobians(_t(s), _t(u), _t(c), 0.1, sign),
            jax.vmap(lambda a, b, cc: jdd.aug_step_jacobians(
                a, b, cc, 0.1, sign))(s, u, c)):
        _close(ours, ref)
    us = np.clip(np.random.default_rng(1).normal(size=(17, 9, 2)), -1, 1)
    _close(diff_drive.rollout(_t(z), _t(us), _t(c), 0.1, sign),
           jax.vmap(lambda a, b, cc: jdd.rollout(a, b, cc, 0.1, sign))(
               z, us, c))


def test_bicycle_matches_jax_with_lane_wheelbase():
    z, u, c = _rand_zu(2, (11,))
    lf = np.linspace(0.3, 0.7, 11)
    jp = JMPCParams(lf=jnp.asarray(lf))
    tp = MPCParams(lf=_t(lf))
    ref = jax.vmap(lambda a, b, cc, l: jbicycle.step_jacobians(
        a, b, cc, 0.1, 1.0, JMPCParams(lf=l)))(z, u, c, jnp.asarray(lf))
    for ours, r in zip(bicycle.step_jacobians(_t(z), _t(u), _t(c), 0.1, 1.0,
                                              tp), ref):
        _close(ours, r)
    mdl, jmdl = get_model("bicycle"), jget_model("bicycle")
    s = np.concatenate([z, u], axis=-1)
    ref = jax.vmap(lambda a, b, cc, l: jmdl.aug_step_jacobians(
        a, b, cc, 0.1, 1.0, JMPCParams(lf=l)))(s, u, c, jnp.asarray(lf))
    for ours, r in zip(mdl.aug_step_jacobians(_t(s), _t(u), _t(c), 0.1, 1.0,
                                              tp), ref):
        _close(ours, r)
    assert mdl.control_names == ("delta", "accel")
    assert not mdl.can_rotate_in_place and jp.lf.shape == (11,)


@pytest.mark.parametrize("family", ["diff_drive", "bicycle"])
def test_make_jacobians_match_closed_forms(family):
    """Forward-mode autodiff of the step equals the closed forms, with a
    batch of (3, 7) scenarios and a per-lane wheelbase; one scenario gives
    unbatched (6, 6) and (6, 2)."""
    mdl = get_model(family)
    jac = make_jacobians(mdl.step)
    z, u, c = _rand_zu(3, (3, 7))
    p = MPCParams(lf=_t(np.linspace(0.4, 0.6, 7)))
    for ours, ref in zip(jac(_t(z), _t(u), _t(c), 0.1, -1.0, p),
                         mdl.step_jacobians(_t(z), _t(u), _t(c), 0.1, -1.0,
                                            p)):
        assert ours.shape == ref.shape
        _close(ours, ref.numpy())
    A, B = jac(_t(z[0, 0]), _t(u[0, 0]), _t(c[0, 0]), 0.1, 1.0, MPCParams())
    assert A.shape == (6, 6) and B.shape == (6, 2)


def _damped_pair():
    """A family with no hand math in either package: the diff drive with
    linear velocity drag, v' = v + (a - 0.35 v) dt."""
    def jstep(z, u, coeffs, dt, sign, p):
        z_next = jdd.step(z, u, coeffs, dt, sign)
        return z_next.at[..., jdd.V].add(-0.35 * z[..., jdd.V] * dt)

    def tstep(z, u, coeffs, dt, sign, p):
        z_next = diff_drive.step(z, u, coeffs, dt, sign)
        e_v = torch.zeros(6, dtype=z.dtype, device=z.device)
        e_v[diff_drive.V] = 1.0
        return z_next - (0.35 * z[..., diff_drive.V] * dt)[..., None] * e_v

    jmodel_from_step("damped_drive", jstep,
                     jget_model("diff_drive").control_bounds,
                     allow_override=True)
    return model_from_step("damped_drive", tstep,
                           get_model("diff_drive").control_bounds,
                           allow_override=True)


def test_custom_family_solves_as_jax():
    """One scenario through `ilqr.solve` against JAX `solve_jit`, then a
    batch of 8 through `batch_solve` against JAX `batch_solve`: equal
    iterations and convergence, controls to 1e-8, cost to 1e-10; the
    drag bites in the family's own rollout."""
    mdl = _damped_pair()
    assert "damped_drive" in available_models()
    kw = dict(n_steps=12, max_sqp_iters=50, backward="xla",
              model="damped_drive")
    z0 = np.array([0.0, 0.3, -0.1, 0.2, 0.0, 0.0])
    coeffs = np.array([0.0, 0.2, 0.0, 0.0])
    jp = JMPCParams().astype(jnp.float64)
    ref = jsolve_jit(jnp.asarray(z0), jnp.asarray(coeffs), jp,
                     JSolverConfig(**kw))
    ours = ilqr.solve(_t(z0), _t(coeffs), MPCParams(), SolverConfig(**kw))
    assert bool(ours.converged) and bool(ref.converged)
    assert int(ours.n_iters) == int(ref.n_iters)
    _close(ours.us, ref.us, 1e-8)
    np.testing.assert_allclose(float(ours.cost), float(ref.cost), rtol=1e-10)
    zs = mdl.rollout(_t(z0), ours.us, _t(coeffs), 0.1, 1.0, MPCParams())
    plain = diff_drive.rollout(_t(z0), ours.us, _t(coeffs), 0.1)
    assert float(zs[-1, diff_drive.V]) < float(plain[-1, diff_drive.V])

    z0s, cs = numpy_scenarios(12, 8)
    kw["n_steps"], kw["max_sqp_iters"] = 10, 30
    rj = jbatch_solve(jnp.asarray(z0s), jnp.asarray(cs), jp,
                      JSolverConfig(**kw))
    rt = batch_solve(_t(z0s), _t(cs), MPCParams(), SolverConfig(**kw))
    np.testing.assert_array_equal(rt.n_iters.numpy(), np.asarray(rj.n_iters))
    np.testing.assert_array_equal(rt.converged.numpy(),
                                  np.asarray(rj.converged))
    _close(rt.us, rj.us, 1e-8)
    np.testing.assert_allclose(rt.cost.numpy(), np.asarray(rj.cost),
                               rtol=1e-10)


def test_registry_refuses_silent_override():
    with pytest.raises(ValueError, match="already registered"):
        model_from_step("diff_drive", lambda z, u, c, dt, s, p: z,
                        get_model("diff_drive").control_bounds)
    assert get_model("diff_drive").step_jacobians is not None
    assert {"bicycle", "diff_drive"} <= set(available_models())
