"""`jnp.linspace` as XLA compiles it on the CPU, where the JAX package's
tests run it: the reference grids of the DWA window and of the synthetic
blob costmaps, reproduced bit for bit in float32 (the plain formula parts
from it by one float32 ulp)."""

from __future__ import annotations

import torch


def window(center, limit, span: float, n: int):
    """`center + jnp.linspace(-limit * span, limit * span, n)` in float32,
    rounded as XLA compiles the JAX evaluator on the CPU, where the JAX
    package's tests run it: the division by n - 1 folded into a product
    with r = fl(1 / (n - 1)) and the span into the stop term, knot k < n - 1
    the fused multiply-add k (limit fl(span r)) + fl((-limit span)(1 - k r))
    (at k = 1, where the product by k folds away, (-limit span)(1 - r) +
    limit fl(span r) fused instead), then limit span. A fused multiply-add
    of float32 operands is exact in float64 but for its one rounding."""
    div = n - 1
    f32, f64 = limit.dtype, torch.float64
    r = torch.tensor(1.0 / div, dtype=f32, device=limit.device)
    span_r = torch.tensor(span, dtype=f32, device=limit.device) * r
    k = torch.arange(div, dtype=f32, device=limit.device)
    start = -limit * span
    one = 1 - k * r
    stop_k = limit * span_r
    fused_k = (k.to(f64) * stop_k.to(f64) + (start * one).to(f64)).to(f32)
    fused_1 = (start.to(f64) * one.to(f64) + stop_k.to(f64)).to(f32)
    out = torch.where(k == 1, fused_1, fused_k)
    return center + torch.cat([out, (limit * span).reshape(1)])


def linspace(start: float, stop: float, n: int, dtype=torch.float32,
             device=None) -> torch.Tensor:
    """`jnp.linspace(start, stop, n, dtype=dtype)` of a symmetric range
    (start = -stop), rounded as `window` rounds it."""
    assert start == -stop, "symmetric ranges only"
    limit = torch.tensor(stop, dtype=dtype, device=device)
    return window(torch.zeros((), dtype=dtype, device=device), limit, 1.0, n)
