"""The rest of a run, with the timed path broken underneath, has to come
out as not correct: a solve or a plant step that returns its state
unchanged, half of the batch left out, an answer altered where it is
produced. (The cells run on one card: there is no exchange between
chips to leave out.)"""

from __future__ import annotations

import dataclasses
from types import SimpleNamespace

import pytest
import torch

import _bench_env as env

from mpc_ros_tpu_torch.engine import receding  # noqa: E402
from mpc_ros_tpu_torch.models import base  # noqa: E402
from mpc_ros_tpu_torch.solver import batch_lane  # noqa: E402

REAL_SOLVE = batch_lane.batch_solve_lane
REAL_ROLLOUT = receding.receding_horizon_rollout


def _unchanged(z0s, coeffs, p, cfg, **kw):
    # the solve returns the state it was given: no SQP iteration
    return REAL_SOLVE(z0s, coeffs, p,
                      dataclasses.replace(cfg, max_sqp_iters=0), **kw)


def _half(z0s, coeffs, p, cfg, **kw):
    # half of the batch solved, the other half left at its start
    B = z0s.shape[0]
    h = B // 2 - (B // 2) % 128
    r = REAL_SOLVE(z0s[:h], coeffs[:h], p, cfg,
                   **{k: (v[:h] if torch.is_tensor(v) else v)
                      for k, v in kw.items()})
    pad = B - h

    def cat(a, fill):
        return torch.cat([a, torch.full((pad,) + a.shape[1:], fill,
                                        dtype=a.dtype, device=a.device)])
    return SimpleNamespace(us=cat(r.us, 0), cost=cat(r.cost, 0),
                           converged=cat(r.converged, False),
                           n_iters=cat(r.n_iters, 0))


def _altered(z0s, coeffs, p, cfg, **kw):
    # every seventh lane's controls nudged where they are produced
    r = REAL_SOLVE(z0s, coeffs, p, cfg, **kw)
    us = r.us.clone()
    us[::7] += 0.02
    return dataclasses.replace(r, us=us)


def _cells(*entries):
    return [w for w in env.workloads() if env.entry_of(w) in entries]


@pytest.mark.parametrize("fault", [_unchanged, _half, _altered],
                         ids=["unchanged", "half", "altered"])
def test_batch_solve_faults_are_not_correct(fault, monkeypatch):
    monkeypatch.setattr(batch_lane, "batch_solve_lane", fault)
    # the serving loop calls the solver through its own import
    monkeypatch.setattr(receding, "batch_solve_lane", fault)
    for w in _cells("batch_solve", "rollout"):
        out = env.rehearse(w, seed=77)
        assert out["correct"] is False, (w, out["checks"])


def test_a_plant_step_that_returns_its_state_is_not_correct(monkeypatch):
    real = base.get_model

    def frozen_plant(name):
        m = real(name)
        return dataclasses.replace(
            m, step=lambda z, u, c, dt, sign, p: z.clone())
    monkeypatch.setattr(receding, "get_model", frozen_plant)
    for w in _cells("rollout"):
        out = env.rehearse(w, seed=78)
        assert out["correct"] is False, out["checks"]
