"""Scalar constants on a device without a host-to-device copy.

`torch.as_tensor(0.5, device="cuda")` builds the value on the host and
copies it from pageable memory, which synchronizes the stream and cannot
be captured in a CUDA graph. `const` writes a Python number with a fill
kernel instead (the value rounds to the dtype exactly as `as_tensor`
rounds it) and converts a tensor as `as_tensor` does, so the solver's
per-solve and per-iteration constants cost no copy and no sync.
"""

from __future__ import annotations

import torch


def const(x, dtype, device=None) -> torch.Tensor:
    """x as a tensor of `dtype` on `device`: a Python number (bool, int,
    float, or a numpy float64, a float subclass) as a 0-d fill, anything
    else through `torch.as_tensor` (a tensor already there is returned
    as it is)."""
    if isinstance(x, (bool, int, float)):
        return torch.full((), x, dtype=dtype, device=device)
    return torch.as_tensor(x, dtype=dtype, device=device)
