"""Associative scan over one axis of a tuple of tensors (the counterpart
of `jax.lax.associative_scan`, which `mpc_ros_tpu/solver/riccati.py`
runs).

The structure is JAX's: adjacent pairs are combined, the half-length
sequence is scanned recursively, the even positions are recovered from
the odd results, and the two are interleaved. That is O(log T) levels of
batched tensor ops and no Python loop over T, and the tree of
combinations is the one JAX builds, so the rounding stays close to
JAX's. With `reverse=True` the elements are flipped first and flipped
back after, so the operator is called with the later element first.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch


def _slice(x: torch.Tensor, dim: int, start: int, stop=None,
           step: int = 1) -> torch.Tensor:
    idx = [slice(None)] * x.dim()
    idx[dim] = slice(start, stop, step)
    return x[tuple(idx)]


def _interleave(even: torch.Tensor, odd: torch.Tensor,
                dim: int) -> torch.Tensor:
    """even[0], odd[0], even[1], odd[1], ... along `dim` (even has as many
    entries as odd, or one more)."""
    shape = list(even.shape)
    shape[dim] = even.shape[dim] + odd.shape[dim]
    out = even.new_empty(shape)
    _slice(out, dim, 0, None, 2).copy_(even)
    _slice(out, dim, 1, None, 2).copy_(odd)
    return out


def associative_scan(fn: Callable, elems: Sequence[torch.Tensor],
                     reverse: bool = False, dim: int = 0) -> tuple:
    """Inclusive scan of `fn` over `dim` of every tensor in `elems` (a
    tuple of tensors of equal length along `dim`); `fn(a, b)` takes and
    returns tuples of the same structure, batched over the other dims.
    Forward, out[i] = e[0] * ... * e[i]; with `reverse=True`, out[i] =
    fn-combination of e[i .. T-1], `fn` called as fn(later, earlier)."""
    cls = type(elems)
    elems = list(elems)
    if reverse:
        elems = [torch.flip(e, (dim,)) for e in elems]

    def combine(a, b):
        return list(fn(cls(*a) if hasattr(cls, "_fields") else cls(a),
                       cls(*b) if hasattr(cls, "_fields") else cls(b)))

    def scan(es):
        n = es[0].shape[dim]
        if n < 2:
            return es
        reduced = combine([_slice(e, dim, 0, -1, 2) for e in es],
                          [_slice(e, dim, 1, None, 2) for e in es])
        odd = scan(reduced)
        if n % 2 == 0:
            even = combine([_slice(e, dim, 0, -1) for e in odd],
                           [_slice(e, dim, 2, None, 2) for e in es])
        else:
            even = combine(odd, [_slice(e, dim, 2, None, 2) for e in es])
        even = [torch.cat([_slice(e, dim, 0, 1), r], dim=dim)
                for e, r in zip(es, even)]
        return [_interleave(a, b, dim) for a, b in zip(even, odd)]

    out = scan(elems)
    if reverse:
        out = [torch.flip(e, (dim,)) for e in out]
    return cls(*out) if hasattr(cls, "_fields") else cls(out)
