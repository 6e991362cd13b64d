"""Solver parity gates: two solves of the same batch agree.

The accuracy bar of `bench.py::kernel_verify` in the JAX package, as one
function on numpy arrays, so the CPU tests (port vs JAX package) and
`chip_smoke.py` (kernel vs plain version on the card) hold solves to the
same gates. At N <= 32:

  * max |du| <= 2e-3 * max(1, T/29) and relative d-cost <= 1e-4, over lanes
    both solves converged alike in the same basin;
  * converged-flag match >= 0.999 and iteration-count match >= 0.90;
  * flip / one-side fraction <= 0.002;
  * |difference of mean iterations| <= 0.25.

Longer horizons relax the match fractions as `kernel_verify` does. With
`compact=True` (`kernel_verify`'s compact-engaged branch) the numeric
comparison is restricted to lanes whose iteration counts match, at twice
the du tolerance and a 5e-4 relative d-cost: a lane that a compact pass
restarts, or whose tile stopped one iteration earlier on one side, walks a
different path, and the fraction gates cover it instead. `lanes` limits
the numeric comparison further (for example to the lanes both solves
converged: a lane stopped by its tile or its iteration cap, or stalled,
holds an iterate away from a stationary point, where a rounding-level
change of the controls moves the cost at first order); the fraction gates
still count every lane.
"""

from __future__ import annotations

import numpy as np


def parity_gates(us_a, cost_a, conv_a, iters_a, us_b, cost_b, conv_b,
                 iters_b, n_steps: int, compact: bool = False,
                 lanes=None) -> dict:
    """Compare solve A with reference solve B (batch-major arrays: us
    (B, T, 2), cost/conv/iters (B,); `lanes`, optional (B,) bool, the
    lanes the numerics cover). Returns the measured values, the `limits`
    they are held to, and `ok`."""
    us_a, us_b = np.asarray(us_a, np.float64), np.asarray(us_b, np.float64)
    cost_a = np.asarray(cost_a, np.float64)
    cost_b = np.asarray(cost_b, np.float64)
    conv_a = np.asarray(conv_a, np.float32) > 0.5
    conv_b = np.asarray(conv_b, np.float32) > 0.5
    it_a = np.asarray(iters_a, np.float32)
    it_b = np.asarray(iters_b, np.float32)
    T = n_steps - 1
    short = n_steps <= 32
    du_tol = 2e-3 * max(1.0, T / 29.0)
    dc_tol = 1e-4
    if compact:
        du_tol, dc_tol = 2.0 * du_tol, 5e-4
    conv_match = float(np.mean(conv_a == conv_b))
    it_match = float(np.mean(it_a == it_b))
    d_it = float(abs(it_a.mean() - it_b.mean()))
    rel_dc = np.abs(cost_a - cost_b) / (1.0 + np.abs(cost_b))
    # numerics over lanes both solves converged alike in the same basin;
    # the fraction of the others is gated instead
    oneside = conv_a != conv_b
    flip = ~oneside & (rel_dc > 1e-3)
    cmp_lanes = ~oneside & ~flip
    if compact:
        cmp_lanes = cmp_lanes & (it_a == it_b)
    if lanes is not None:
        cmp_lanes = cmp_lanes & np.asarray(lanes, bool)
    flip_frac = float(np.mean(flip | oneside))
    du = float(np.max(np.where(cmp_lanes[:, None, None],
                               np.abs(us_a - us_b), 0.0)))
    dc = float(np.max(np.where(cmp_lanes, rel_dc, 0.0)))
    finite = bool(np.all(np.isfinite(us_a)) and np.all(np.isfinite(cost_a)))
    if n_steps <= 60:
        limits = {"max_du": du_tol, "max_rel_dcost": dc_tol,
                  "conv_match_frac": 0.999 if short else 0.995,
                  "iters_match_frac": 0.90 if short else 0.88,
                  "flip_or_oneside_frac": 0.002 if short else 0.01,
                  "mean_iters_diff": 0.25 if short else 2.5}
        ok = (du <= limits["max_du"] and dc <= limits["max_rel_dcost"]
              and it_match >= limits["iters_match_frac"])
    else:
        # past N~60 basin flips dominate; gate only on gross disagreement
        limits = {"conv_match_frac": 0.99, "flip_or_oneside_frac": 0.01,
                  "mean_iters_diff": 2.5}
        ok = True
    ok = ok and (finite and conv_match >= limits["conv_match_frac"]
                 and flip_frac <= limits["flip_or_oneside_frac"]
                 and d_it <= limits["mean_iters_diff"])
    return {
        "batch": int(us_a.shape[0]),
        "max_du": du,
        "max_rel_dcost": dc,
        "compared_frac": float(np.mean(cmp_lanes)),
        "conv_match_frac": conv_match,
        "iters_match_frac": it_match,
        "flip_or_oneside_frac": flip_frac,
        "mean_iters": [float(it_a.mean()), float(it_b.mean())],
        "finite": finite,
        "limits": limits,
        "ok": bool(ok),
    }
