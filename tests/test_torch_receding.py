"""The port's warm-started serving loop against the JAX package's
receding_horizon_rollout on the same numpy robots (B=128, N=12, 3 cycles),
held cycle by cycle to the solver parity gates. The port's side runs the
whole-solve kernel's plain version (`backward="mega"`; "auto" on CPU
tensors is the XLA lane path, as in the JAX package, whose serving is
held in tests/test_torch_lane_xla.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_ros_tpu.config import MPCParams as JMPCParams
from mpc_ros_tpu.config import SolverConfig as JSolverConfig
from mpc_ros_tpu.engine.receding import receding_horizon_rollout as jroll
from mpc_ros_tpu_torch.config import MPCParams, SolverConfig
from mpc_ros_tpu_torch.engine import receding_horizon_rollout
from mpc_ros_tpu_torch.testing import numpy_scenarios
from mpc_ros_tpu_torch.verify import parity_gates

B = 128
N = 12
CYCLES = 3
KW = dict(n_steps=N, max_sqp_iters=12, ls_iters=4, tol_grad=1e-4)


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
