"""Monte-Carlo weight-tuning sweeps (counterpart of
`mpc_ros_tpu/engine/sweep.py`).

Sample candidate weight vectors, evaluate each on a common scenario set
by solving (n_weights x n_scenarios) NMPC problems in one batch, and rank
the candidates by a fixed evaluation metric. Per-scenario weights ride the
batch lanes of `batch_solve_lane` (and through it the whole-solve kernel's
packed parameters), so the whole sweep is one solve; a batch off the lane
solver's rule (total % 128 != 0, or a custom family) runs on
`batch_solve_swept`.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..config import WEIGHT_NAMES, MPCParams, SolverConfig
from ..solver.batch_lane import batch_solve_lane
from .batch import batch_solve_swept, make_random_scenarios
from .presort import fit_difficulty_model, predict_difficulty


@dataclasses.dataclass
class SweepResult:
    weights: MPCParams               # candidate weight sets, leaves (n,)
    mean_cost: torch.Tensor          # (n,) mean solve cost over scenarios
    mean_terminal_cte: torch.Tensor  # (n,)
    converged_frac: torch.Tensor     # (n,)
    # (n,) mean SQP iterations: extreme candidates dominate a sweep's wall
    # time (a warp or tile pays its slowest lane)
    mean_iters: torch.Tensor
    best_index: int

    def best_params(self) -> MPCParams:
        i = self.best_index
        return MPCParams(**{f.name: getattr(self.weights, f.name)[i]
                            for f in dataclasses.fields(MPCParams)})


def sample_weight_candidates(generator: torch.Generator, n: int,
                             base: MPCParams, scale: float = 3.0,
                             dtype=torch.float32) -> MPCParams:
    """Log-uniform perturbations of the tracking weights around `base`,
    factors in [1/scale, scale], drawn from `generator` on its device."""
    dev = generator.device
    out = {f.name: torch.as_tensor(getattr(base, f.name), dtype=dtype,
                                   device=dev).expand(n).clone()
           for f in dataclasses.fields(MPCParams)}
    lo = -math.log(scale)
    for name in WEIGHT_NAMES:
        u = torch.rand((n,), dtype=dtype, device=dev, generator=generator)
        out[name] = out[name] * torch.exp(lo + (2.0 * -lo) * u)
    return MPCParams(**out)


def tuning_sweep(generator: torch.Generator, candidates: MPCParams,
                 n_scenarios: int, cfg: SolverConfig, dtype=torch.float32,
                 score_cte_weight: float = 1.0,
                 presort: bool = False) -> SweepResult:
    """Evaluate the candidates on one random scenario set drawn from
    `generator` (on its device): n_weights * n_scenarios solves in one
    batch, scenario-major blocks per candidate. Scoring is terminal |cte|
    with candidates under 99% convergence excluded (costs under different
    weights are incomparable); when no candidate reaches 99%, the most
    converged wins.

    `presort`: order the shared scenario set by predicted difficulty
    before tiling (engine/presort.py), fit on a <= 2048-scenario
    calibration solve under the first candidate's weights. The sweep
    consumes per-candidate reductions only, so the order does not change
    its result beyond reduction-order rounding."""
    n_weights = getattr(candidates, WEIGHT_NAMES[0]).shape[0]
    z0s, coeffs = make_random_scenarios(generator, n_scenarios, dtype)

    if (presort and n_scenarios >= 256 and n_scenarios % 128 == 0
            and cfg.model in ("diff_drive", "bicycle")):
        n_cal = min(n_scenarios, 2048)
        p0 = MPCParams(**{f.name: getattr(candidates, f.name)[0]
                          for f in dataclasses.fields(MPCParams)})
        calib = batch_solve_lane(z0s[:n_cal], coeffs[:n_cal], p0, cfg)
        z0s_h = z0s.cpu().numpy()
        coeffs_h = coeffs.cpu().numpy()
        dmodel = fit_difficulty_model(z0s_h[:n_cal], coeffs_h[:n_cal],
                                      calib.n_iters.cpu().numpy())
        order = np.argsort(predict_difficulty(dmodel, z0s_h, coeffs_h),
                           kind="stable")
        order = torch.as_tensor(order, device=z0s.device)
        z0s = z0s[order]
        coeffs = coeffs[order]

    # scenario-major blocks: candidate i owns lanes [i*n, (i+1)*n)
    z0s_t = z0s.repeat(n_weights, 1)
    coeffs_t = coeffs.repeat(n_weights, 1)
    ps = MPCParams(**{
        f.name: torch.repeat_interleave(
            torch.as_tensor(getattr(candidates, f.name), device=z0s.device),
            n_scenarios, dim=0)
        for f in dataclasses.fields(MPCParams)})
    if (n_weights * n_scenarios % 128 == 0
            and cfg.model in ("diff_drive", "bicycle")):
        res = batch_solve_lane(z0s_t, coeffs_t, ps, cfg)
    else:
        # custom families (model_from_step) and ragged batches run the
        # registry-generic engine
        res = batch_solve_swept(z0s_t, coeffs_t, ps, cfg)
    costs = res.cost.reshape(n_weights, n_scenarios)
    term_cte = res.zs[:, -1, 4].abs().reshape(n_weights, n_scenarios)
    conv = res.converged.reshape(n_weights, n_scenarios)

    mean_cost = costs.mean(dim=1)
    mean_cte = term_cte.mean(dim=1)
    conv_frac = conv.to(dtype).mean(dim=1)
    mean_iters = res.n_iters.to(dtype).reshape(n_weights,
                                               n_scenarios).mean(dim=1)
    score = score_cte_weight * mean_cte + torch.where(
        conv_frac < 0.99, float("inf"), 0.0)
    if not bool(torch.isfinite(score).any()):
        # argmin over +inf would crown index 0: take the most converged
        score = -conv_frac
    best = int(torch.argmin(score))
    return SweepResult(
        weights=candidates, mean_cost=mean_cost, mean_terminal_cte=mean_cte,
        converged_frac=conv_frac, mean_iters=mean_iters, best_index=best,
    )
