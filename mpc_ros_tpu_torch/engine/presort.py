"""Host-side difficulty presort (counterpart of
`mpc_ros_tpu/engine/presort.py`): an opt-in throughput lever for batch
workloads whose consumers do not care about scenario order.

The whole-solve kernel pays, per 128-lane tile under the compact
schedule's pass 1 and per warp everywhere, the iterations of its slowest
lanes. Ordering the scenarios by a predicted difficulty before upload
groups similar lanes together at the cost of one matvec and one argsort on
the host. The predictor is a closed-form ridge fit of iteration counts on
raw difficulty features (high heading error at speed on curved
references), calibrated on one solve.

`solve_presorted` returns results in the permuted order together with the
permutation; `PresortedResult.unpermuted_host` restores the caller's
order on the host. The feature, fit and predict functions are numpy, as in
the JAX package; the port keeps its own copy of them.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from ..config import MPCParams, SolverConfig
from ..solver.batch_lane import batch_solve_lane


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def difficulty_features(z0s, coeffs, blob_xy: Optional[np.ndarray] = None,
                        blob_sigma: float = 0.3) -> np.ndarray:
    """Per-scenario difficulty features (B, 16 or 23): the raw terms
    behind the iteration tail, their pairwise interactions, and the
    heading error against the local path tangent atan(c1). `blob_xy`
    (B, 2): the primary obstacle blob centre per scenario; its miss
    distance from the path and the penalty at the path join the set."""
    z0s = np.asarray(_host(z0s), np.float64)
    coeffs = np.asarray(_host(coeffs), np.float64)
    v0, cte, eth = z0s[:, 3], z0s[:, 4], z0s[:, 5]
    c0 = coeffs[:, 0]
    c1 = coeffs[:, 1]
    c2 = coeffs[:, 2]
    c3 = coeffs[:, 3]
    etan = np.abs(eth - np.arctan(c1))
    cols = [v0, np.abs(cte), np.abs(eth), np.abs(c1), np.abs(c2),
            np.abs(c3), v0 * np.abs(eth), v0 * np.abs(c2),
            np.abs(eth) * np.abs(c2), np.abs(cte) * np.abs(c2),
            v0 * v0, eth * eth, cte * cte, etan, v0 * etan]
    if blob_xy is not None:
        bx = np.asarray(blob_xy, np.float64)[:, 0]
        by = np.asarray(blob_xy, np.float64)[:, 1]
        py = c0 + c1 * bx + c2 * bx**2 + c3 * bx**3
        slope = c1 + 2 * c2 * bx + 3 * c3 * bx**2
        miss = np.abs(by - py) / np.sqrt(1.0 + slope * slope)
        pen = np.exp(-(miss * miss) / (2.0 * blob_sigma**2))
        start = np.exp(-((bx - 0.0) ** 2 + (by - cte) ** 2)
                       / (2.0 * blob_sigma**2))
        cols += [bx, np.abs(by), miss, pen, pen * v0, pen * np.abs(eth),
                 start]
    cols.append(np.ones_like(v0))
    return np.stack(cols, axis=1)


def fit_difficulty_model(z0s, coeffs, n_iters, reg: float = 1e-3,
                         blob_xy: Optional[np.ndarray] = None,
                         blob_sigma: float = 0.3) -> np.ndarray:
    """Closed-form ridge fit of iteration counts (`SolveResult.n_iters`
    of one calibration solve) on the difficulty features; returns the
    weight vector."""
    X = difficulty_features(z0s, coeffs, blob_xy, blob_sigma)
    y = np.asarray(_host(n_iters), np.float64)
    A = X.T @ X + reg * np.eye(X.shape[1])
    return np.linalg.solve(A, X.T @ y)


def predict_difficulty(model: np.ndarray, z0s, coeffs,
                       blob_xy: Optional[np.ndarray] = None,
                       blob_sigma: float = 0.3) -> np.ndarray:
    """Difficulty keys (B,): one matvec."""
    return difficulty_features(z0s, coeffs, blob_xy, blob_sigma) @ \
        np.asarray(model, np.float64)


@dataclasses.dataclass
class PresortedResult:
    """Solve results in difficulty order and the permutation that produced
    them: lane b of `result` holds scenario `perm[b]` of the caller's
    batch."""

    result: Any          # SolveResult, permuted order, on the solve device
    perm: np.ndarray     # (B,) caller index of each result lane

    def unpermuted_host(self):
        """The result on the host as numpy arrays, in the caller's
        scenario order."""
        inv = np.empty_like(self.perm)
        inv[self.perm] = np.arange(len(self.perm))

        def back(a):
            a = _host(a)
            return a[inv] if a.ndim and a.shape[0] == len(inv) else a

        return type(self.result)(**{
            f.name: back(getattr(self.result, f.name))
            for f in dataclasses.fields(self.result)})


def solve_presorted(z0s, coeffs, p: MPCParams, cfg: SolverConfig,
                    model: Optional[np.ndarray] = None,
                    keys: Optional[np.ndarray] = None,
                    device="cuda") -> PresortedResult:
    """Solve a host-resident scenario batch in difficulty order on
    `device` (CUDA unless the caller asks for another). `model`: weights
    from `fit_difficulty_model`, or `keys`: any per-scenario difficulty
    ranking. The permuted batch is uploaded once; `p` must be on
    `device` (or hold Python floats)."""
    z0s_h = _host(z0s)
    coeffs_h = _host(coeffs)
    if keys is None:
        if model is None:
            raise ValueError("pass a fitted model or explicit keys")
        keys = predict_difficulty(model, z0s_h, coeffs_h)
    perm = np.argsort(_host(keys), kind="stable")
    res = batch_solve_lane(torch.as_tensor(z0s_h[perm], device=device),
                           torch.as_tensor(coeffs_h[perm], device=device),
                           p, cfg)
    return PresortedResult(result=res, perm=perm)
