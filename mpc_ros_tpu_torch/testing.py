"""Seeded numpy inputs for holding the port against the JAX package.

The two packages draw different numbers from their generators, so a
comparison makes its inputs once with numpy and hands the same arrays to
both. The distributions are those of `make_random_scenarios`.
"""

from __future__ import annotations

import numpy as np

from .config import WEIGHT_NAMES


def numpy_scenarios(seed: int, batch: int, pose_scale: float = 0.3,
                    curve_scale: float = 0.25):
    """z0s (B, 6) and coeffs (B, 4) as float64 numpy arrays."""
    rng = np.random.default_rng(seed)
    B = batch
    coeffs = rng.normal(size=(B, 4)) * np.array([0.1, 0.2, curve_scale,
                                                 0.05])
    v0 = rng.uniform(0.0, 0.8, size=B)
    cte = coeffs[:, 0] + rng.normal(size=B) * pose_scale * 0.3
    etheta = np.arctan(coeffs[:, 1]) + rng.normal(size=B) * 0.2
    zeros = np.zeros(B)
    z0s = np.stack([zeros, zeros, zeros, v0, cte, etheta], axis=-1)
    return z0s, coeffs


def scaled_weights(defaults: dict, batch: int,
                   factors=(0.5, 1.0, 4.0)) -> dict:
    """Per-lane (B,) weight leaves: every weight of lane i scaled by
    factors[i % len(factors)] (exercises the adaptive weight scale)."""
    f = np.resize(np.asarray(factors, np.float64), batch)
    return {k: np.asarray(defaults[k], np.float64) * f for k in WEIGHT_NAMES}
