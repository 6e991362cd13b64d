"""backward_fused_plain (the plain PyTorch version of the fused backward
kernel, K4) against the JAX package's `backward_fused_pallas` run in
Pallas interpret mode, on the same numpy inputs; and the dispatch
contract of the kernel wrapper."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_ros_tpu.config import MPCParams as JMPCParams
from mpc_ros_tpu.kernels.backward_fused_pallas import backward_fused_pallas
from mpc_ros_tpu.kernels.backward_fused_pallas import pack_params as jpack
from mpc_ros_tpu.solver import batch_lane as jbl
from mpc_ros_tpu_torch.config import MPCParams
from mpc_ros_tpu_torch.kernels import backward_fused
from mpc_ros_tpu_torch.kernels.pack import pack_params
from mpc_ros_tpu_torch.testing import (numpy_scenarios, scaled_weights,
                                       torch_threads)

B = 128
OUTS = ("ks", "Ks", "dV1", "dV2", "pg")



@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these tests run many small ops, and the suite
    runs in several processes at once (`testing.torch_threads`)."""
    with torch_threads(1):
        yield

def make_inputs(seed, T, lane_weights=True):
    """numpy inputs of one backward pass: a rollout of random controls
    (the ss the solver would hold), the terminal expansion, per-lane
    bounds and per-lane mu over six decades."""
    rng = np.random.default_rng(seed)
    z0, coeffs = numpy_scenarios(seed, B)
    leaves = dataclasses.asdict(JMPCParams())
    if lane_weights:
        leaves.update(scaled_weights(leaves, B))
    jp = JMPCParams(**leaves).astype(jnp.float64)
    us = rng.normal(size=(T, 2, B)) * 0.4
    s0 = np.concatenate([z0.T, np.zeros((2, B))])
    ss, _ = jbl._rollout_and_cost(jnp.asarray(s0), jnp.asarray(us),
                                  jnp.asarray(coeffs.T), 0.1, 1.0, jp,
                                  jnp.float64, T)
    V_s, V_ss = jbl._terminal_bl(ss[-1], jp, jnp.float64)
    lb = -rng.uniform(0.4, 1.2, size=(2, B))
    ub = rng.uniform(0.4, 1.2, size=(2, B))
    mu = 10.0 ** rng.uniform(-6.0, 0.0, size=B)
    return dict(ss=np.asarray(ss), us=us, coeffs=coeffs.T.copy(),
                leaves=leaves, V_s=np.asarray(V_s), V_ss=np.asarray(V_ss),
                lb=lb, ub=ub, mu=mu)


def run_both(inp, f64, sign=1.0):
    jdt, tdt = ((jnp.float64, torch.float64) if f64
                else (jnp.float32, torch.float32))
    j = lambda k: jnp.asarray(inp[k], jdt)
    ref = backward_fused_pallas(
        j("ss"), j("us"), j("coeffs"), jpack(JMPCParams(**inp["leaves"]), B,
                                             jdt),
        sign, j("V_s"), j("V_ss"), j("lb"), j("ub"), j("mu"),
        interpret=True)
    t = lambda k: torch.tensor(inp[k], dtype=tdt)
    p = MPCParams.from_numpy({k: np.asarray(v)
                              for k, v in inp["leaves"].items()})
    ours = backward_fused.backward_fused_plain(
        t("ss"), t("us"), t("coeffs"), pack_params(p, B, tdt), sign,
        t("V_s"), t("V_ss"), t("lb"), t("ub"), t("mu"))
    return [np.asarray(a) for a in ref], [a.numpy() for a in ours]


@pytest.mark.parametrize("seed,sign", [(0, 1.0), (1, -1.0)],
                         ids=["sign+", "sign-"])
def test_plain_matches_interpret_f64(seed, sign):
    ref, ours = run_both(make_inputs(seed, 29), f64=True, sign=sign)
    for name, a, b in zip(OUTS, ours, ref):
        assert a.shape == b.shape, name
        scale = max(1.0, float(np.abs(b).max()))
        err = float(np.abs(a - b).max())
        assert err <= 1e-10 * scale, (name, err, scale)
    # the inputs exercise both clamped and free box-QP outcomes
    ks = ref[0]
    free = np.abs(ref[1]).sum(axis=2) > 0
    assert 0.05 < free.mean() < 0.999, free.mean()
    assert np.isfinite(ks).all()


def test_plain_matches_interpret_f32():
    ref, ours = run_both(make_inputs(2, 7, lane_weights=False), f64=False)
    # the tolerances of tests/test_pallas_kernels.py (interpret vs XLA)
    np.testing.assert_allclose(ours[0], ref[0], atol=2e-6)       # ks
    np.testing.assert_allclose(ours[1], ref[1], atol=2e-6)       # Ks
    np.testing.assert_allclose(ours[4], ref[4], atol=1e-6)       # pg
    # dV1/dV2 sum T terms of cost magnitude: relative f32 rounding
    for a, b in zip(ours[2:4], ref[2:4]):
        np.testing.assert_allclose(a, b, rtol=2e-5, atol=1e-4)


def _cpu_inputs(T=5):
    inp = make_inputs(3, T, lane_weights=False)
    f32 = torch.float32
    t = lambda k: torch.tensor(inp[k], dtype=f32)
    return (t("ss"), t("us"), t("coeffs"), pack_params(MPCParams(), B, f32),
            1.0, t("V_s"), t("V_ss"), t("lb"), t("ub"), t("mu"))


def test_dispatch_sends_cpu_tensors_to_plain_without_launching():
    ins = _cpu_inputs()
    before = backward_fused.launches
    out = backward_fused.backward_fused(*ins)
    assert backward_fused.launches == before
    for a, b in zip(out, backward_fused.backward_fused_plain(*ins)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_cuda_wrapper_refuses_cpu_tensors():
    before = backward_fused.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        backward_fused.backward_fused_cuda(*_cpu_inputs())
    assert backward_fused.launches == before


def test_shapes_are_checked():
    ins = list(_cpu_inputs())
    ins[5] = ins[5][:7]                       # V_s with 7 rows
    with pytest.raises(ValueError, match="V_s"):
        backward_fused.backward_fused_plain(*ins)
