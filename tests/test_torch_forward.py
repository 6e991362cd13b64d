"""forward_plain (the plain PyTorch version of the fused line-search
kernel, K5) against the JAX package's `forward_pallas` run in Pallas
interpret mode, on the same numpy inputs (gains from a real backward
pass, a mixed `act` mask); and the dispatch contract of the wrapper."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_ros_tpu.config import MPCParams as JMPCParams
from mpc_ros_tpu.kernels.backward_fused_pallas import pack_params as jpack
from mpc_ros_tpu.kernels.forward_pallas import forward_pallas
from mpc_ros_tpu.solver import batch_lane as jbl
from mpc_ros_tpu_torch.config import MPCParams
from mpc_ros_tpu_torch.kernels import forward
from mpc_ros_tpu_torch.kernels.pack import pack_params
from mpc_ros_tpu_torch.testing import (numpy_scenarios, torch_threads)

B = 128



@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these tests run many small ops, and the suite
    runs in several processes at once (`testing.torch_threads`)."""
    with torch_threads(1):
        yield

def make_inputs(seed, T):
    """A rollout of random controls, its cost, the gains of one backward
    pass on it (so most lanes accept some alpha), and act with ~30% of the
    lanes done."""
    rng = np.random.default_rng(seed)
    z0, coeffs = numpy_scenarios(seed, B)
    jp = JMPCParams().astype(jnp.float64)
    us = rng.normal(size=(T, 2, B)) * 0.4
    s0 = np.concatenate([z0.T, np.zeros((2, B))])
    cT = jnp.asarray(coeffs.T)
    ss, cost = jbl._rollout_and_cost(jnp.asarray(s0), jnp.asarray(us), cT,
                                     0.1, 1.0, jp, jnp.float64, T)
    V_s, V_ss = jbl._terminal_bl(ss[-1], jp, jnp.float64)
    lb = np.full((2, B), -1.0)
    ks, Ks, _, _, _ = jbl._backward_bl(
        ss, jnp.asarray(us), cT, 0.1, 1.0, jp, V_s, V_ss, jnp.asarray(lb),
        jnp.asarray(-lb), jnp.full((B,), 1e-3))
    # some lanes get a blown-up step, so a smaller alpha wins, and some a
    # prior cost of 0 (the costs are sums of squares), so none does
    ks = np.asarray(ks).copy()
    ks[:, :, :16] *= 50.0
    cost = np.asarray(cost).copy()
    cost[16:28] = 0.0
    act = (rng.uniform(size=B) > 0.3).astype(np.float64)
    return dict(ss=np.asarray(ss), us=us, ks=ks, Ks=np.asarray(Ks),
                coeffs=coeffs.T.copy(), lb=lb, ub=-lb, cost=cost, act=act)


def run_both(inp, n_alpha, f64):
    jdt, tdt = ((jnp.float64, torch.float64) if f64
                else (jnp.float32, torch.float32))
    j = lambda k: jnp.asarray(inp[k], jdt)
    ref = forward_pallas(j("ss"), j("us"), j("ks"), j("Ks"), j("coeffs"),
                         jpack(JMPCParams(), B, jdt), 1.0, j("lb"), j("ub"),
                         j("cost"), j("act"), n_alpha, interpret=True)
    t = lambda k: torch.tensor(inp[k], dtype=tdt)
    ours = forward.forward_plain(
        t("ss"), t("us"), t("ks"), t("Ks"), t("coeffs"),
        pack_params(MPCParams(), B, tdt), 1.0, t("lb"), t("ub"), t("cost"),
        t("act"), n_alpha)
    return [np.asarray(a) for a in ref], [a.numpy() for a in ours]


@pytest.mark.parametrize("n_alpha", [8, 3])
def test_plain_matches_interpret_f64(n_alpha):
    inp = make_inputs(0, 29)
    ref, ours = run_both(inp, n_alpha, f64=True)
    np.testing.assert_array_equal(ours[3], ref[3])               # accepted
    for name, a, b in zip(("ss", "us", "cost"), ours[:3], ref[:3]):
        assert a.shape == b.shape, name
        scale = max(1.0, float(np.abs(b).max()))
        assert np.abs(a - b).max() <= 1e-12 * scale, name
    acc = ref[3] > 0.5
    # both outcomes occur, and act gates the update, not the flag
    assert 0.05 < acc.mean() < 0.995, acc.mean()
    moved = np.abs(ours[1] - inp["us"]).max(axis=(0, 1)) > 0
    np.testing.assert_array_equal(moved, acc & (inp["act"] > 0.5))


def test_plain_matches_interpret_f32():
    inp = make_inputs(1, 7)
    ref, ours = run_both(inp, 8, f64=False)
    np.testing.assert_array_equal(ours[3], ref[3])
    # the tolerance of tests/test_pallas_kernels.py (interpret vs XLA)
    np.testing.assert_allclose(ours[0], ref[0], atol=2e-6)
    np.testing.assert_allclose(ours[1], ref[1], atol=2e-6)
    np.testing.assert_allclose(ours[2], ref[2], rtol=1e-6)


def _cpu_inputs(T=5):
    inp = make_inputs(2, T)
    f32 = torch.float32
    t = lambda k: torch.tensor(inp[k], dtype=f32)
    return (t("ss"), t("us"), t("ks"), t("Ks"), t("coeffs"),
            pack_params(MPCParams(), B, f32), 1.0, t("lb"), t("ub"),
            t("cost"), t("act"))


def test_dispatch_sends_cpu_tensors_to_plain_without_launching():
    ins = _cpu_inputs()
    before = forward.launches
    out = forward.forward(*ins, n_alpha=4)
    assert forward.launches == before
    for a, b in zip(out, forward.forward_plain(*ins, n_alpha=4)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_cuda_wrapper_refuses_cpu_tensors():
    before = forward.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        forward.forward_cuda(*_cpu_inputs())
    assert forward.launches == before


@pytest.mark.parametrize("n_alpha", [0, 9])
def test_n_alpha_range_is_checked(n_alpha):
    with pytest.raises(ValueError, match="n_alpha"):
        forward.forward_plain(*_cpu_inputs(), n_alpha=n_alpha)
