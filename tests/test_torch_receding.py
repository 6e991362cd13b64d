"""The port's warm-started serving loop against the JAX package's
receding_horizon_rollout on the same numpy robots (B=128, N=12, 3 cycles),
held cycle by cycle to the solver parity gates. The port's side runs the
whole-solve kernel's plain version (`backward="mega"`; "auto" on CPU
tensors is the XLA lane path, as in the JAX package, whose serving is
held in tests/test_torch_lane_xla.py). At N=48 the port's serving runs
the compact schedule around the kernel's plain version."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_ros_tpu.config import MPCParams as JMPCParams
from mpc_ros_tpu.config import SolverConfig as JSolverConfig
from mpc_ros_tpu.engine.receding import receding_horizon_rollout as jroll
from mpc_ros_tpu_torch.config import MPCParams, SolverConfig
from mpc_ros_tpu_torch.engine import receding_horizon_rollout
from mpc_ros_tpu_torch.kernels import solve_mega
from mpc_ros_tpu_torch.testing import (numpy_scenarios, torch_threads)
from mpc_ros_tpu_torch.verify import parity_gates

B = 128
N = 12
CYCLES = 3
KW = dict(n_steps=N, max_sqp_iters=12, ls_iters=4, tol_grad=1e-4)



@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these tests run many small ops, and the suite
    runs in several processes at once (`testing.torch_threads`)."""
    with torch_threads(1):
        yield

@pytest.fixture(scope="module")
def traces():
    z0, coeffs = numpy_scenarios(11, B)
    f32 = jnp.float32
    tr_j = jroll(jnp.asarray(z0, f32), jnp.asarray(coeffs, f32),
                 JMPCParams().astype(f32), JSolverConfig(**KW),
                 n_cycles=CYCLES)
    t = lambda a: torch.tensor(a, dtype=torch.float32)
    tr_t = receding_horizon_rollout(t(z0), t(coeffs),
                                    MPCParams().astype(torch.float32),
                                    SolverConfig(**KW, backward="mega"),
                                    n_cycles=CYCLES)
    return tr_j, tr_t


def test_trace_shapes_and_warm_start(traces):
    _, tr = traces
    assert tuple(tr.zs.shape) == (CYCLES, B, 6)
    assert tuple(tr.us.shape) == (CYCLES, B, 2)
    assert tuple(tr.costs.shape) == (CYCLES, B)
    assert tr.iters.dtype == torch.int32
    assert float(tr.converged.float().mean()) >= 0.999
    # the shifted warm start cuts the iterations after the cold cycle
    assert float(tr.iters[1:].float().mean()) < float(
        tr.iters[0].float().mean())


@pytest.mark.parametrize("cycle", range(CYCLES))
def test_cycle_matches_jax_serving(traces, cycle):
    tr_j, tr_t = traces
    # the JAX trace carries no convergence flags: the conv gates compare
    # the port's flags with themselves, the cost-flip gate still applies
    conv = tr_t.converged[cycle].numpy()
    g = parity_gates(tr_t.us[cycle].numpy()[:, None, :],
                     tr_t.costs[cycle].numpy(), conv,
                     tr_t.iters[cycle].numpy(),
                     np.asarray(tr_j.us[cycle])[:, None, :],
                     np.asarray(tr_j.costs[cycle]), conv,
                     np.asarray(tr_j.iters[cycle]), N)
    assert g["ok"], g
    # the plant states the loop applied the controls to
    dz = np.abs(tr_t.zs[cycle].numpy() - np.asarray(tr_j.zs[cycle])).max()
    assert dz <= 2e-3, dz


def test_long_horizon_serving_matches_jax():
    """N = 48, 256 robots, 2 cycles: the port's "mega" serving resolves
    "auto" to the compact schedule, observed engaged on every cycle (two
    passes, a 128-lane tail), and each cycle holds to the gates against
    JAX's serving. The two sides run different schedules: on the CPU the
    JAX package's "auto" is its XLA lane path, one pass over every lane
    (its Pallas path would not compact 256 lanes either: `_pick_sub` gives
    one 256-lane tile, so its tail is the whole batch). This holds the
    compact schedule's result against a single pass's, not compact
    against compact; test_torch_schedule.py does that at B = 384."""
    n, b, cycles = 48, 256, 2
    kw = dict(n_steps=n, max_sqp_iters=22, tol_grad=1e-4)
    z0, coeffs = numpy_scenarios(13, b)
    f32 = jnp.float32
    tr_j = jroll(jnp.asarray(z0, f32), jnp.asarray(coeffs, f32),
                 JMPCParams().astype(f32), JSolverConfig(**kw),
                 n_cycles=cycles)
    t = lambda a: torch.tensor(a, dtype=torch.float32)
    before = (solve_mega.passes, solve_mega.tail_lanes)
    tr_t = receding_horizon_rollout(t(z0), t(coeffs),
                                    MPCParams().astype(torch.float32),
                                    SolverConfig(**kw, backward="mega"),
                                    n_cycles=cycles)
    assert (solve_mega.passes - before[0],
            solve_mega.tail_lanes - before[1]) == (2 * cycles, 128 * cycles)
    for cycle in range(cycles):
        # the JAX trace keeps no converged flags: the port's stand on both
        # sides, so the gates hold the applied controls, costs and
        # iteration counts
        conv = tr_t.converged[cycle].numpy()
        g = parity_gates(tr_t.us[cycle].numpy()[:, None, :],
                         tr_t.costs[cycle].numpy(), conv,
                         tr_t.iters[cycle].numpy(),
                         np.asarray(tr_j.us[cycle])[:, None, :],
                         np.asarray(tr_j.costs[cycle]), conv,
                         np.asarray(tr_j.iters[cycle]), n)
        assert g["ok"], (cycle, g)
        assert conv.mean() >= 0.99
