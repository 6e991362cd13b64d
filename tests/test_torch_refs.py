"""Per-knot setpoint profiles (K1 stage (f)) in the port against the JAX
package, on the same numpy inputs (`mpc_ros_tpu_torch.testing.numpy_refs`:
a speed ramp with a sinusoidal cte setpoint, plus per-lane noise):

* a constant profile equal to the scalar setpoints gives the scalar
  path's solve bit for bit (the check of tests/test_pallas_kernels.py::
  test_megakernel_refs_constant_profile_matches_scalar_setpoints);
* a ramp profile, and a profile with blobs, against the JAX megakernel in
  Pallas interpret mode in f64: conv, iterations and done equal on every
  lane, controls and states within 1e-8 (max(1e-8, twice the port's own
  one-ulp response) where a lane sits on a near-tie);
* `batch_solve_lane(refs=...)` on the kernel route: the (B, N, 3) profile
  reaches the kernel as (N, 3, B), and the sorted schedule carries each
  lane's profile through its permutation (held against the single pass at
  the `kernel_verify` gates in f32).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_ros_tpu.config import MPCParams as JMPCParams
from mpc_ros_tpu.config import SolverConfig as JSolverConfig
from mpc_ros_tpu.kernels.backward_fused_pallas import pack_params as jpack
from mpc_ros_tpu.kernels.solve_pallas import solve_pallas
from mpc_ros_tpu.models.obstacles import GaussianObstacles as JBlobs
from mpc_ros_tpu.solver import batch_lane as jbl
from mpc_ros_tpu_torch.config import MPCParams, SolverConfig
from mpc_ros_tpu_torch.kernels import solve_mega
from mpc_ros_tpu_torch.kernels.pack import pack_params
from mpc_ros_tpu_torch.models.obstacles import GaussianObstacles
from mpc_ros_tpu_torch.solver import batch_lane as tbl
from mpc_ros_tpu_torch.testing import (numpy_blobs, numpy_refs,
                                       numpy_scenarios, torch_threads)
from mpc_ros_tpu_torch.verify import parity_gates

B = 128
N = 12



@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these tests run many small ops, and the suite
    runs in several processes at once (`testing.torch_threads`)."""
    with torch_threads(1):
        yield

def _t(a, dtype=torch.float64):
    return torch.tensor(np.asarray(a), dtype=dtype)


def _arrays(seed, batch=B, n_steps=N):
    z0, coeffs = numpy_scenarios(seed, batch)
    lb = np.full((2, batch), -1.0)
    return [z0.T.copy(), coeffs.T.copy(), lb, -lb,
            np.zeros((n_steps - 1, 2, batch))]


def _port(arrays, kw, refs=None, blobs=None, dtype=torch.float64,
          fn=solve_mega.solve_mega_plain):
    zT, cT, lb, ub, u0 = (_t(a, dtype) for a in arrays)
    refsT = None if refs is None else _t(refs, dtype).permute(1, 2, 0)
    bl = (None if blobs is None else GaussianObstacles.from_sigmas(
        *(_t(a, dtype) for a in blobs)).lane())
    out = fn(zT, cT, pack_params(MPCParams(), zT.shape[-1], dtype), lb, ub,
             u0, SolverConfig(**kw), blobs=bl, refs=refsT)
    return [a.numpy() for a in out]


def _jax(arrays, kw, refs, blobs=None):
    f64 = jnp.float64
    zT, cT, lb, ub, u0 = (jnp.asarray(a, f64) for a in arrays)
    bl = (None if blobs is None else JBlobs.from_sigmas(
        *(jnp.asarray(a, f64) for a in blobs)).lane())
    out = solve_pallas(zT, cT, jpack(JMPCParams(), zT.shape[-1], f64), lb,
                       ub, u0, JSolverConfig(**kw), dtype=f64,
                       interpret=True, blobs=bl,
                       refs=jnp.moveaxis(jnp.asarray(refs, f64), 0, -1))
    return [np.asarray(a) for a in out]


def _assert_lanes(arrays, kw, refs, blobs, ref, ours):
    np.testing.assert_array_equal(ours[3], ref[3])       # conv
    np.testing.assert_array_equal(ours[4], ref[4])       # iters
    np.testing.assert_array_equal(ours[7], ref[7])       # done
    worst = max(np.abs(ours[1] - ref[1]).max(), np.abs(ours[0] - ref[0]).max())
    if worst > 1e-8:
        ulp = 0.0
        for k in range(2):
            flip = np.random.default_rng(100 + k).choice(
                [-1.0, 1.0], size=arrays[0].shape)
            moved = [arrays[0] * (1.0 + 2.0 ** -52 * flip)] + arrays[1:]
            out = _port(moved, kw, refs, blobs)
            ulp = max(ulp, float(np.abs(out[1] - ours[1]).max()))
        assert worst <= 2.0 * ulp, (worst, ulp)
    np.testing.assert_allclose(ours[2], ref[2], rtol=1e-10)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_constant_profile_equals_scalar_path(dtype):
    """The profile holds the scalar setpoints at every knot: every output
    equals the scalar path's bit for bit."""
    arrays = _arrays(0)
    kw = dict(n_steps=N, max_sqp_iters=8, tol_grad=1e-3, trig="exact")
    p = MPCParams()
    const = np.broadcast_to(
        np.array([p.ref_cte, p.ref_etheta, p.ref_vel])[None, None],
        (B, N, 3))
    base = _port(arrays, kw, dtype=dtype)
    with_refs = _port(arrays, kw, refs=const, dtype=dtype)
    for a, b in zip(base, with_refs):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("blobs", [False, True], ids=["ramp", "ramp_blobs"])
def test_profile_matches_interpret_f64(blobs):
    """A per-lane ramp profile (and with blobs: obstacle-aware trajectory
    tracking) read at the knot of each state: the stage cost at knots
    0..T-1, the terminal cost and Vs0 at knot T, the linearization's l_s
    at knot t."""
    arrays = _arrays(1)
    refs = numpy_refs(2, B, N)
    blob_arrays = numpy_blobs(3, B) if blobs else None
    kw = dict(n_steps=N, max_sqp_iters=20, ddp=True, trig="exact")
    ref = _jax(arrays, kw, refs, blob_arrays)
    ours = _port(arrays, kw, refs, blob_arrays)
    _assert_lanes(arrays, kw, refs, blob_arrays, ref, ours)
    assert ref[3].mean() > 0.95
    # the profile moves the solution away from the scalar setpoints'
    scalar = _port(arrays, kw, blobs=blob_arrays)
    assert np.abs(scalar[1] - ours[1]).max() > 1e-2


def test_batch_solve_lane_takes_refs_on_the_kernel_route():
    """`backward="mega"` (f32, B % 128 == 0) on CPU tensors runs the
    kernel's plain version with the (B, N, 3) profile laid out (N, 3, B);
    the sorted schedule permutes each lane's profile with the lane (at
    done_frac = 1 a lane's result does not depend on its neighbours, so
    it holds to the single pass at the `kernel_verify` gates, the
    line-search state restarting between the passes). f64 is off the
    kernel rule: there the profile runs on the registry-generic engine,
    held against the JAX package's fallback in f64."""
    f32 = torch.float32
    z0, coeffs = (_t(a, f32) for a in numpy_scenarios(4, B))
    refs = _t(numpy_refs(5, B, N), f32)
    cfg = SolverConfig(n_steps=N, max_sqp_iters=12, backward="mega",
                       tol_grad=1e-4)
    res = tbl.batch_solve_lane(z0, coeffs, MPCParams(), cfg, refs=refs)
    ins = tbl.lane_inputs(z0, coeffs, MPCParams(), cfg)
    direct = solve_mega.solve_mega_plain(*ins, cfg,
                                         refs=refs.permute(1, 2, 0))
    torch.testing.assert_close(res.us, direct[1].permute(2, 0, 1), rtol=0,
                               atol=0)
    srt = dataclasses.replace(cfg, schedule="sorted", presolve_iters=2)
    before = solve_mega.passes
    r_s = tbl.batch_solve_lane(z0, coeffs, MPCParams(), srt, refs=refs)
    assert solve_mega.passes - before == 2
    g = parity_gates(r_s.us.numpy(), r_s.cost.numpy(),
                     r_s.converged.numpy(), r_s.n_iters.numpy(),
                     res.us.numpy(), res.cost.numpy(),
                     res.converged.numpy(), res.n_iters.numpy(), N)
    assert g["ok"], g
    # f64 is off the kernel rule: the profile runs on the registry-generic
    # engine, as the JAX package's batch_solve_lane does
    r64 = tbl.batch_solve_lane(z0.double(), coeffs.double(), MPCParams(),
                               cfg, refs=refs.double())
    j64 = jbl.batch_solve_lane(
        jnp.asarray(z0.double().numpy()), jnp.asarray(coeffs.double().numpy()),
        JMPCParams().astype(jnp.float64),
        JSolverConfig(n_steps=N, max_sqp_iters=12, backward="mega",
                      tol_grad=1e-4),
        refs=jnp.asarray(refs.double().numpy()))
    np.testing.assert_array_equal(r64.n_iters.numpy(), np.asarray(j64.n_iters))
    np.testing.assert_array_equal(r64.converged.numpy(),
                                  np.asarray(j64.converged))
    np.testing.assert_allclose(r64.us.numpy(), np.asarray(j64.us), rtol=0,
                               atol=1e-8)
    np.testing.assert_allclose(r64.cost.numpy(), np.asarray(j64.cost),
                               rtol=1e-10)
