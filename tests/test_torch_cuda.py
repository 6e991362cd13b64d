"""Tests that need an NVIDIA GPU (marker `cuda`; they skip without one):
the solve kernel against its plain version on the card, and the main path
launching it. Run on the card with
`python -m pytest --noconftest tests/test_torch_cuda.py` (tests/conftest.py
configures JAX, which the card's machine need not have).
"""

import dataclasses

import pytest
import torch

from mpc_ros_tpu_torch.config import MPCParams, SolverConfig
from mpc_ros_tpu_torch.engine import (make_random_scenarios,
                                      receding_horizon_rollout)
from mpc_ros_tpu_torch.kernels import solve_mega
from mpc_ros_tpu_torch.solver.batch_lane import batch_solve_lane, lane_inputs
from mpc_ros_tpu_torch.verify import parity_gates

pytestmark = pytest.mark.cuda

PROD = SolverConfig(n_steps=30, max_sqp_iters=12, ls_iters=4, ddp=True,
                    tol_grad=1e-4)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _scen(dev, B, seed=0):
    return make_random_scenarios(torch.Generator(device=dev).manual_seed(seed),
                                 B)


@pytest.mark.parametrize("variant", ["prod", "exact", "gn", "no_adaptive"])
def test_kernel_matches_plain(dev, variant):
    cfg = {"prod": PROD,
           "exact": dataclasses.replace(PROD, trig="exact"),
           "gn": dataclasses.replace(PROD, ddp=False, ls_iters=8),
           "no_adaptive": dataclasses.replace(PROD, scale_adaptive=False,
                                              n_steps=12)}[variant]
    z0s, coeffs = _scen(dev, 1024)
    ins = lane_inputs(z0s, coeffs, MPCParams().astype(torch.float32, dev),
                      cfg)
    k = solve_mega.solve_mega_cuda(*ins, cfg)
    p = solve_mega.solve_mega_plain(*ins, cfg)
    g = parity_gates(k[1].permute(2, 0, 1).cpu(), k[2].cpu(), k[3].cpu(),
                     k[4].cpu(), p[1].permute(2, 0, 1).cpu(), p[2].cpu(),
                     p[3].cpu(), p[4].cpu(), cfg.n_steps)
    assert g["ok"], g


def test_main_path_and_serving_launch_the_kernel(dev):
    z0s, coeffs = _scen(dev, 2048, seed=1)
    p = MPCParams().astype(torch.float32, dev)
    before = solve_mega.launches
    res = batch_solve_lane(z0s, coeffs, p, PROD)
    assert solve_mega.launches == before + 1
    assert res.us.is_cuda and bool(torch.isfinite(res.us).all())
    tr = receding_horizon_rollout(z0s, coeffs, p, PROD, n_cycles=3)
    assert solve_mega.launches == before + 4
    assert float(tr.converged.float().mean()) >= 0.99


def test_cuda_refuses_what_the_kernel_does_not_take(dev):
    z0s, coeffs = _scen(dev, 256)
    with pytest.raises(NotImplementedError):
        batch_solve_lane(z0s.double(), coeffs.double(), MPCParams(), PROD)
    with pytest.raises(NotImplementedError):
        batch_solve_lane(z0s[:200], coeffs[:200], MPCParams(), PROD)
    ins = lane_inputs(z0s, coeffs, MPCParams(), PROD)
    with pytest.raises(ValueError):
        solve_mega.solve_mega_cuda(*(a.double() for a in ins), PROD)
