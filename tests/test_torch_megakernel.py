"""solve_mega_plain (the plain PyTorch version of the solve kernel) against
the JAX package's megakernel run in Pallas interpret mode, on the same
numpy inputs; and the dispatch contract of the kernel wrapper. Resume,
the per-tile exit and the schedules are held in test_torch_schedule.py."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_ros_tpu.config import MPCParams as JMPCParams
from mpc_ros_tpu.config import SolverConfig as JSolverConfig
from mpc_ros_tpu.kernels.backward_fused_pallas import pack_params as jpack
from mpc_ros_tpu.kernels.solve_pallas import solve_pallas
from mpc_ros_tpu_torch.config import MPCParams, SolverConfig
from mpc_ros_tpu_torch.kernels import solve_mega
from mpc_ros_tpu_torch.kernels.pack import pack_params
from mpc_ros_tpu_torch.testing import (numpy_scenarios, scaled_weights,
                                       torch_threads)
from mpc_ros_tpu_torch.verify import parity_gates

B = 128



@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these tests run many small ops, and the suite
    runs in several processes at once (`testing.torch_threads`)."""
    with torch_threads(1):
        yield

def _inputs(seed, n_steps, lane_weights):
    z0, coeffs = numpy_scenarios(seed, B)
    leaves = dataclasses.asdict(JMPCParams())
    if lane_weights:
        leaves.update(scaled_weights(leaves, B))
    T = n_steps - 1
    lb = np.full((2, B), -1.0)
    return z0.T.copy(), coeffs.T.copy(), leaves, lb, -lb, np.zeros((T, 2, B))


def _both(kw, f64, seed=0, lane_weights=False):
    jdt, tdt = (jnp.float64, torch.float64) if f64 else (jnp.float32,
                                                         torch.float32)
    zT, cT, leaves, lb, ub, u0 = _inputs(seed, kw["n_steps"], lane_weights)
    jp = JMPCParams(**leaves)
    ref = solve_pallas(*(jnp.asarray(a, jdt) for a in (zT, cT)),
                       jpack(jp, B, jdt),
                       *(jnp.asarray(a, jdt) for a in (lb, ub, u0)),
                       JSolverConfig(**kw), dtype=jdt, interpret=True)
    p = MPCParams.from_numpy({k: np.asarray(v) for k, v in leaves.items()})
    t = lambda a: torch.tensor(a, dtype=tdt)
    ours = solve_mega.solve_mega_plain(t(zT), t(cT), pack_params(p, B, tdt),
                                       t(lb), t(ub), t(u0),
                                       SolverConfig(**kw))
    return [np.asarray(a) for a in ref], [a.numpy() for a in ours]


def _gates(ref, ours, n_steps):
    mv = lambda us: np.moveaxis(us, -1, 0)
    return parity_gates(mv(ours[1]), ours[2], ours[3], ours[4],
                        mv(ref[1]), ref[2], ref[3], ref[4], n_steps)


@pytest.mark.parametrize("ddp", [False, True], ids=["gn", "ddp"])
def test_plain_matches_interpret_f64(ddp):
    kw = dict(n_steps=12, max_sqp_iters=12, ddp=ddp, trig="exact")
    ref, ours = _both(kw, f64=True)
    np.testing.assert_array_equal(ours[3], ref[3])       # conv, every lane
    np.testing.assert_array_equal(ours[4], ref[4])       # iters, every lane
    assert np.max(np.abs(ours[1] - ref[1])) <= 1e-8      # us
    assert np.max(np.abs(ours[0] - ref[0])) <= 1e-8      # ss
    assert ref[3].mean() > 0.9


def test_plain_matches_interpret_f32_lane_weights():
    kw = dict(n_steps=12, max_sqp_iters=12, ddp=True, ls_iters=4,
              trig="fast", scale_adaptive=True, tol_grad=1e-4)
    ref, ours = _both(kw, f64=False, seed=1, lane_weights=True)
    g = _gates(ref, ours, 12)
    assert g["ok"], g


def test_plain_matches_interpret_f32_n30():
    kw = dict(n_steps=30, max_sqp_iters=12, ddp=True, ls_iters=4,
              trig="fast", tol_grad=1e-4)
    ref, ours = _both(kw, f64=False, seed=2)
    g = _gates(ref, ours, 30)
    assert g["ok"], g
    assert ours[3].mean() >= 0.99


def _cpu_inputs(n_steps=8, B_=128):
    z0, coeffs = numpy_scenarios(5, B_)
    T = n_steps - 1
    f32 = torch.float32
    lb = torch.full((2, B_), -1.0)
    return (torch.tensor(z0.T, dtype=f32), torch.tensor(coeffs.T, dtype=f32),
            pack_params(MPCParams(), B_, f32), lb, -lb,
            torch.zeros(T, 2, B_))


def test_cuda_wrapper_refuses_cpu_tensors():
    cfg = SolverConfig(n_steps=8, max_sqp_iters=3)
    before = solve_mega.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        solve_mega.solve_mega_cuda(*_cpu_inputs(), cfg)
    assert solve_mega.launches == before


def test_dispatch_sends_cpu_tensors_to_plain_without_launching():
    cfg = SolverConfig(n_steps=8, max_sqp_iters=3)
    ins = _cpu_inputs()
    before = solve_mega.launches
    out = solve_mega.solve_mega(*ins, cfg)
    assert solve_mega.launches == before
    plain = solve_mega.solve_mega_plain(*ins, cfg)
    for a, b in zip(out, plain):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_lockstep_selects_the_per_tile_variant():
    """`lockstep` asks for the per-tile loop at done_frac = 1 (the fifth
    template flag) and leaves the exit count at the whole tile."""
    kn = solve_mega.resolve_knobs(SolverConfig(n_steps=8), torch.float32)
    lock = dataclasses.replace(kn, lockstep=True)
    assert (kn.tile_exit, lock.tile_exit) == (False, True)
    assert lock.variant == kn.variant[:4] + (True,) + kn.variant[5:]
    assert lock.n_done_needed == kn.n_done_needed == solve_mega.TILE


def test_parity_gates_lanes_limit_the_numerics_only():
    """`lanes` drops lanes from the |du| and d-cost comparison; the
    fraction gates still count every lane."""
    n = 1024
    rng = np.random.default_rng(0)
    us = rng.normal(size=(n, 7, 2))
    cost = rng.uniform(10.0, 20.0, n)
    conv = np.ones(n)
    iters = np.full(n, 4.0)
    us_b = us.copy()
    us_b[3] += 0.5                       # one lane off, converged alike
    conv_b = conv.copy()
    conv_b[0] = 0.0                      # one lane converged on one side
    off = parity_gates(us, cost, conv, iters, us_b, cost, conv_b, iters, 12)
    keep = np.ones(n, bool)
    keep[3] = False
    g = parity_gates(us, cost, conv, iters, us_b, cost, conv_b, iters, 12,
                     lanes=keep)
    assert not off["ok"] and off["max_du"] == pytest.approx(0.5)
    assert g["ok"] and g["max_du"] == 0.0
    assert g["conv_match_frac"] == off["conv_match_frac"] == (n - 1) / n
    assert g["flip_or_oneside_frac"] == off["flip_or_oneside_frac"] == 1 / n
    assert g["compared_frac"] == (n - 2) / n


@pytest.mark.parametrize("kw,extra,match", [
    (dict(model="tricycle"), {}, "families"),
    ({}, dict(blobs=(torch.zeros(2, 128),) * 3), "cx, cy, gamma, w"),
    ({}, dict(refs=torch.zeros(7, 3, 128)), "refs: expected shape"),
], ids=["unknown_model", "blobs_arity", "refs_shape"])
def test_unported_kernel_options_raise(kw, extra, match):
    """The kernel covers both families, blobs and setpoints; what it does
    not take raises before anything runs: another family, blobs that are
    not the four (cx, cy, gamma, w) arrays, a profile not (T+1, 3, B)."""
    cfg = SolverConfig(n_steps=8, **kw)
    with pytest.raises(ValueError, match=match):
        solve_mega.solve_mega(*_cpu_inputs(), cfg, **extra)
