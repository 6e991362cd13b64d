"""The port's entry module (`entry.py`), its exports and its examples:

* `entry()` on the CPU: its function on the JAX `__graft_entry__.entry()`
  example inputs is the port's lane solve's first controls, and that
  solve is held against the JAX package's lane solve at the single-pass
  parity gates (`verify.parity_gates`);
* `dryrun_multichip(4)` on a mesh of four CPU entries (data 2 x time 2),
  every phase within its bound;
* the exports: `solver.solve` and `solve_jit`, `engine.Scenario`, and the
  package's top-level names, those of the JAX package's `__init__`;
* the examples that end within seconds on one CPU thread, run with their
  own arguments (`custom_model`, `weight_tuning --candidates 2
  --scenarios 16`, `fleet_planner --fleet 8 --cycles 5`); the others,
  whose closed loops take minutes on the CPU, imported.
"""

import importlib

import numpy as np
import pytest
import torch

import mpc_ros_tpu
import mpc_ros_tpu_torch
from mpc_ros_tpu_torch import entry as port_entry
from mpc_ros_tpu_torch.testing import torch_threads
from mpc_ros_tpu_torch.verify import parity_gates


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with torch_threads(1):
        yield


def test_entry_matches_the_jax_entry_at_the_parity_gates():
    import __graft_entry__ as graft
    from mpc_ros_tpu.config import MPCParams as JMPCParams
    from mpc_ros_tpu.config import SolverConfig as JSolverConfig
    from mpc_ros_tpu.solver.batch_lane import batch_solve_lane as jlane

    from mpc_ros_tpu_torch.config import MPCParams, SolverConfig
    from mpc_ros_tpu_torch.solver.batch_lane import batch_solve_lane

    fn, (z0s, coeffs) = port_entry.entry(device="cpu")
    assert z0s.shape == (128, 6) and coeffs.shape == (128, 4)
    assert z0s.dtype == torch.float32 and z0s.device.type == "cpu"
    assert fn(z0s, coeffs).shape == (128, 2)
    jfn, (jz, jc) = graft.entry()
    z, c = (torch.tensor(np.asarray(a)) for a in (jz, jc))
    kw = dict(n_steps=30, max_sqp_iters=12, tol_grad=1e-4, ddp=True,
              ls_iters=4)
    ours = batch_solve_lane(z, c, MPCParams().astype(torch.float32),
                            SolverConfig(**kw))
    assert torch.equal(fn(z, c), ours.us[:, 0, :])
    import jax.numpy as jnp

    ref = jlane(jz, jc, JMPCParams().astype(jnp.float32),
                JSolverConfig(**kw))
    np.testing.assert_array_equal(np.asarray(jfn(jz, jc)),
                                  np.asarray(ref.us[:, 0, :]))
    g = parity_gates(ours.us.numpy(), ours.cost.numpy(),
                     ours.converged.numpy(), ours.n_iters.numpy(),
                     np.asarray(ref.us), np.asarray(ref.cost),
                     np.asarray(ref.converged), np.asarray(ref.n_iters), 30)
    assert g["ok"], g


def test_dryrun_multichip_on_four_cpu_entries():
    out = port_entry.dryrun_multichip(4, device="cpu")
    assert out["mesh"] == {"data": 2, "time": 2}
    d = out["max_dev_vs_unsharded"]
    assert set(d) == {"sweep", "horizon", "fleet", "serving",
                      "device_fleet", "costmap_fit", "fleet_trajectory"}
    assert d["sweep"] <= 1e-6 and d["fleet"] <= 1e-6
    assert d["serving"] <= 1e-6 and d["horizon"] <= 5e-4
    assert out["converged"] == 1.0 and out["hsolve_conv"] > 0.9


def test_entry_points_need_the_card_or_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_entry.entry()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_entry.dryrun_multichip(2)


def test_exports_match_the_jax_package():
    assert set(mpc_ros_tpu.__all__) <= set(mpc_ros_tpu_torch.__all__)
    for name in mpc_ros_tpu.__all__:
        assert getattr(mpc_ros_tpu_torch, name) is not None, name
    from mpc_ros_tpu_torch.engine import Scenario
    from mpc_ros_tpu_torch.solver import SolveResult, solve, solve_jit
    from mpc_ros_tpu_torch.solver import ilqr

    # solve_jit is the captured solve (solver/graphed.py), no alias
    assert solve is ilqr.solve and solve_jit is ilqr.solve_jit
    assert SolveResult is not None
    sc = Scenario(z0=torch.zeros(6), coeffs=torch.zeros(4))
    assert sc.z0.shape == (6,) and sc.coeffs.shape == (4,)
    from mpc_ros_tpu import engine as jengine
    from mpc_ros_tpu import solver as jsolver
    from mpc_ros_tpu_torch import engine, solver

    assert set(jsolver.__all__) <= set(solver.__all__)
    assert set(jengine.__all__) <= set(engine.__all__) | {"Scenario"}
    assert "Scenario" in engine.__all__


RUN = {"custom_model": [],
       "weight_tuning": ["--candidates", "2", "--scenarios", "16"],
       "fleet_planner": ["--fleet", "8", "--cycles", "5"]}
IMPORTED = ("quickstart", "fleet_serving", "obstacle_navigation",
            "costmap_pipeline")


@pytest.mark.parametrize("name", sorted(RUN))
def test_example_runs_on_the_cpu(name, capsys):
    mod = importlib.import_module(f"mpc_ros_tpu_torch.examples.{name}")
    mod.main(RUN[name] + ["--cpu"])
    out = capsys.readouterr().out
    assert out.strip(), name
    assert "nan" not in out.lower(), out


@pytest.mark.parametrize("name", IMPORTED)
def test_example_imports(name):
    mod = importlib.import_module(f"mpc_ros_tpu_torch.examples.{name}")
    assert callable(mod.main)
    if not torch.cuda.is_available():
        # without --cpu an example runs on the card, and raises without one
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mod.main([])
