"""The port's config (mpc_ros_tpu_torch.config) resolves every solver knob
exactly as the JAX package's does, and its params cross over from numpy."""

import dataclasses
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_ros_tpu.config import MPCParams as JMPCParams
from mpc_ros_tpu.config import SolverConfig as JSolverConfig
from mpc_ros_tpu.kernels.backward_fused_pallas import pack_params as jpack
from mpc_ros_tpu_torch.config import MPCParams, SolverConfig
from mpc_ros_tpu_torch.kernels.pack import N_PAR, pack_params
from mpc_ros_tpu_torch.testing import scaled_weights

DTYPES = [(jnp.float32, torch.float32), (jnp.float64, torch.float64)]


def _resolved(cfg, dt):
    out = {"ls_for": cfg.ls_for(dt), "tol_grad_for": cfg.tol_grad_for(dt),
           "ddp_for": cfg.ddp_for(dt), "ddp_gate_eff": cfg.ddp_gate_eff,
           "n_controls": cfg.n_controls, "n_coeffs": cfg.n_coeffs,
           "n_vars": cfg.n_vars, "n_constraints": cfg.n_constraints}
    for obs, omaps in itertools.product((False, True), repeat=2):
        out[("pair", obs, omaps)] = cfg._long_horizon_pair(dt, obs, omaps)
        out[("mu", obs, omaps)] = cfg.mu_init_for(dt, obs, omaps)
        out[("gate", obs, omaps)] = cfg.gate_for(obs, dt, omaps)
    out["mu_none"] = cfg.mu_init_for(None)
    out["gate_none"] = cfg.gate_for(False, None)
    return out


def test_solver_config_fields_and_defaults_match():
    jf = [(f.name, f.default) for f in dataclasses.fields(JSolverConfig)]
    tf = [(f.name, f.default) for f in dataclasses.fields(SolverConfig)]
    assert tf == jf


@pytest.mark.parametrize("n_steps", [20, 30, 36, 40, 48])
@pytest.mark.parametrize("dtypes", DTYPES, ids=["f32", "f64"])
def test_resolved_knobs_match(dtypes, n_steps):
    jdt, tdt = dtypes
    grid = itertools.product(
        ("auto", True, False), (None, 1.0), ("auto", 1e-3), (None, 5),
        ("auto", "pallas"), (False, True))
    for ddp, gate, mu, ls, backward, hp in grid:
        kw = dict(n_steps=n_steps, ddp=ddp, ddp_gate=gate, mu_init=mu,
                  ls_iters=ls, backward=backward, horizon_parallel=hp)
        assert (_resolved(SolverConfig(**kw), tdt)
                == _resolved(JSolverConfig(**kw), jdt)), kw


def test_params_from_numpy_roundtrip():
    B = 5
    jp = JMPCParams(**scaled_weights(
        dataclasses.asdict(JMPCParams()), B)).astype(jnp.float64)
    leaves = {f.name: np.asarray(getattr(jp, f.name))
              for f in dataclasses.fields(JMPCParams)}
    p = MPCParams.from_numpy(leaves)
    back = p.to_numpy()
    assert set(back) == set(leaves)
    for k, v in leaves.items():
        assert back[k].dtype == v.dtype
        np.testing.assert_array_equal(back[k], v)
    assert p.w_cte.shape == (B,) and p.dt.shape == ()
    with pytest.raises(ValueError):
        MPCParams.from_numpy({"not_a_param": 1.0})
    # defaults and the reference's own defaults equal the JAX package's
    for tp, jpp in ((MPCParams(), JMPCParams()),
                    (MPCParams.reference_defaults(),
                     JMPCParams.reference_defaults())):
        for f in dataclasses.fields(JMPCParams):
            assert float(getattr(tp, f.name)) == float(getattr(jpp, f.name))


@pytest.mark.parametrize("lane_weights", [False, True])
def test_pack_params_equal(lane_weights):
    B = 7
    base = dataclasses.asdict(JMPCParams())
    if lane_weights:
        base.update(scaled_weights(base, B))
    jp = JMPCParams(**base).astype(jnp.float64)
    p = MPCParams.from_numpy({k: np.asarray(getattr(jp, k)) for k in base})
    packed = pack_params(p, B, torch.float64)
    assert packed.shape == (N_PAR, B) and packed.is_contiguous()
    np.testing.assert_array_equal(packed.numpy(),
                                  np.asarray(jpack(jp, B, jnp.float64)))
