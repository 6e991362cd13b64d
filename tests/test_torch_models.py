"""The port's polynomial ops, tile polynomials and diff-drive model equal
the JAX package's in f64 (to 1e-12)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_ros_tpu.config import MPCParams as JMPCParams
from mpc_ros_tpu.kernels import backward_pallas as jtiles
from mpc_ros_tpu.models import diff_drive as jdd
from mpc_ros_tpu.ops import poly as jpoly
from mpc_ros_tpu_torch.config import MPCParams
from mpc_ros_tpu_torch.kernels import tiles
from mpc_ros_tpu_torch.models import diff_drive, get_model
from mpc_ros_tpu_torch.ops import poly

TOL = 1e-12


def _t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


@pytest.mark.parametrize("P", [1, 2, 4, 6])
def test_polyeval_and_derivatives(P):
    rng = np.random.default_rng(P)
    B = 64
    c = rng.normal(size=(B, P))
    x = rng.normal(size=B) * 2.0
    np.testing.assert_allclose(poly.polyeval(_t(c), _t(x)).numpy(),
                               np.asarray(jpoly.polyeval(c, x)),
                               rtol=0, atol=TOL)
    np.testing.assert_allclose(poly.polyder_eval(_t(c), _t(x)).numpy(),
                               np.asarray(jpoly.polyder_eval(c, x)),
                               rtol=0, atol=TOL)
    # the kernel's tile form: coefficients (P, B) batch-last
    cT = c.T.copy()
    for ours, ref in ((tiles.polyval, jtiles._polyval_tile),
                      (tiles.polyder, jtiles._polyder_tile),
                      (tiles.polyder2, jtiles._polyder2_tile)):
        np.testing.assert_allclose(ours(_t(cT), _t(x)).numpy(),
                                   np.asarray(ref(jnp.asarray(cT),
                                                  jnp.asarray(x))),
                                   rtol=0, atol=TOL)


@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_diff_drive_step(sign):
    rng = np.random.default_rng(7)
    B = 128
    z = rng.normal(size=(B, 6))
    u = rng.normal(size=(B, 2))
    c = rng.normal(size=(B, 4)) * 0.3
    ours = diff_drive.step(_t(z), _t(u), _t(c), 0.1, sign).numpy()
    ref = np.stack([np.asarray(jdd.step(z[i], u[i], c[i], 0.1, sign))
                    for i in range(B)])
    np.testing.assert_allclose(ours, ref, rtol=0, atol=TOL)
    # the registry step (signature of the JAX Model) is the same function
    reg = get_model("diff_drive").step(_t(z), _t(u), _t(c), 0.1, sign, None)
    np.testing.assert_array_equal(reg.numpy(), ours)


@pytest.mark.parametrize("per_lane", [False, True])
def test_control_bounds(per_lane):
    B = 9
    kw = {}
    if per_lane:
        kw = dict(max_angvel=np.linspace(0.5, 1.5, B), max_throttle=0.7)
    jp = JMPCParams(**kw)
    p = MPCParams.from_numpy({k: np.asarray(v) for k, v in kw.items()})
    lb, ub = get_model("diff_drive").control_bounds(p, torch.float64)
    jlb, jub = jdd._control_bounds(jp, jnp.float64)
    assert tuple(lb.shape) == jlb.shape
    np.testing.assert_array_equal(lb.numpy(), np.asarray(jlb))
    np.testing.assert_array_equal(ub.numpy(), np.asarray(jub))


def test_unknown_model_raises():
    with pytest.raises(ValueError, match="unknown model"):
        get_model("tricycle")
