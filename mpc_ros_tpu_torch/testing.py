"""Seeded numpy inputs for holding the port against the JAX package.

The two packages draw different numbers from their generators, so a
comparison makes its inputs once with numpy and hands the same arrays to
both. The scenarios' distributions are those of `make_random_scenarios`;
the blob fields are `bench.py`'s obstacle layout and the setpoint
profiles a ramp plus noise, as the JAX package's trajectory-tracking tests
draw them.
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


def numpy_blobs(seed: int, batch: int, n_blobs: int = 4):
    """A blob field per lane in `bench.py`'s obstacle layout: one live blob
    with its centre uniform in [0.3, 1.2]^2, then n_blobs - 1 inert blobs at
    (50, 50); sigma 0.3 and weight 100 for all. Returns (cx, cy, sigma, w),
    each (B, K) float64, for `GaussianObstacles.from_sigmas`."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(0.3, 1.2, size=(batch, 2))
    far = np.full((batch, n_blobs - 1), 50.0)
    cx = np.concatenate([centers[:, :1], far], axis=1)
    cy = np.concatenate([centers[:, 1:], far], axis=1)
    return (cx, cy, np.full((batch, n_blobs), 0.3),
            np.full((batch, n_blobs), 100.0))


def numpy_refs(seed: int, batch: int, n_steps: int, noise: float = 0.1,
               ref_vel: float = 0.5):
    """Per-lane (ref_cte, ref_etheta, ref_vel) setpoint profiles (B, N, 3),
    float64: a speed ramp from ref_vel + 0.2 down to ref_vel - 0.3 with a
    small sinusoidal cte setpoint, plus seeded Gaussian noise of scale
    `noise` per knot and lane (`noise=0` gives the ramp alone)."""
    rng = np.random.default_rng(seed)
    t = np.linspace(0.0, 1.0, n_steps)
    base = np.stack([0.02 * np.sin(2.0 * np.pi * t), np.zeros_like(t),
                     ref_vel + 0.2 - 0.5 * t], axis=-1)
    return base[None] + noise * rng.normal(size=(batch, n_steps, 3))
