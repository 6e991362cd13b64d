"""tiles.boxqp (the plain version of the kernel's box QP) equals the JAX
package's `_boxqp_tile` in f64 on random, saturated and exactly tied QPs,
and the small per-lane matrix products equal theirs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_ros_tpu.kernels import backward_pallas as jtiles
from mpc_ros_tpu_torch.kernels import tiles

TOL = 1e-12


def _qp(kind: str, B: int = 512):
    rng = np.random.default_rng({"random": 0, "saturated": 1, "ties": 2}[kind])
    if kind == "ties":
        # small integers: many combos reach exactly equal violations, so
        # the first-wins order decides; includes Qu = 0 and bounds at 0
        L = rng.integers(-2, 3, size=(B, 2, 2)).astype(np.float64)
        Quu = np.einsum("bij,bkj->bik", L, L) + np.eye(2)
        Qu = rng.integers(-3, 4, size=(B, 2)).astype(np.float64)
        lb = -rng.integers(0, 3, size=(B, 2)).astype(np.float64)
        ub = rng.integers(0, 3, size=(B, 2)).astype(np.float64)
    else:
        L = rng.normal(size=(B, 2, 2))
        Quu = np.einsum("bij,bkj->bik", L, L) + 0.05 * np.eye(2)
        scale = 1.0 if kind == "random" else 50.0
        Qu = rng.normal(size=(B, 2)) * scale
        lb = -rng.uniform(0.1, 1.0, size=(B, 2))
        ub = rng.uniform(0.1, 1.0, size=(B, 2))
    Qus = rng.normal(size=(B, 2, 8))
    # batch-last, as the kernel holds them
    return (np.moveaxis(Quu, 0, -1).copy(), Qu.T.copy(), lb.T.copy(),
            ub.T.copy(), np.moveaxis(Qus, 0, -1).copy())


@pytest.mark.parametrize("kind", ["random", "saturated", "ties"])
def test_boxqp_matches_reference(kind):
    args = _qp(kind)
    k, K = tiles.boxqp(*(torch.tensor(a) for a in args))
    jk, jK = jtiles._boxqp_tile(*(jnp.asarray(a) for a in args),
                                jnp.float64)
    np.testing.assert_allclose(k.numpy(), np.asarray(jk), rtol=0, atol=TOL)
    np.testing.assert_allclose(K.numpy(), np.asarray(jK), rtol=0, atol=TOL)
    if kind == "saturated":
        # the case exercises the clamped combos
        lb, ub = args[2], args[3]
        at_bound = np.isclose(k.numpy(), lb) | np.isclose(k.numpy(), ub)
        assert at_bound.mean() > 0.5


def test_small_matrix_products():
    rng = np.random.default_rng(3)
    B = 16
    X = rng.normal(size=(2, 8, B))
    Y = rng.normal(size=(2, 2, B))
    v = rng.normal(size=(2, B))
    M = rng.normal(size=(2, 2, B))
    t = torch.tensor
    np.testing.assert_allclose(
        tiles.mtm(t(X), t(Y), 8, 2, 2).numpy(),
        np.asarray(jtiles._mtm(jnp.asarray(X), jnp.asarray(Y), 8, 2, 2)),
        rtol=0, atol=TOL)
    np.testing.assert_allclose(
        tiles.mtv(t(X), t(v), 8, 2).numpy(),
        np.asarray(jtiles._mtv(jnp.asarray(X), jnp.asarray(v), 8, 2)),
        rtol=0, atol=TOL)
    np.testing.assert_allclose(
        tiles.mv(t(M), t(v), 2, 2).numpy(),
        np.asarray(jtiles._mv(jnp.asarray(M), jnp.asarray(v), 2, 2)),
        rtol=0, atol=TOL)
