"""The yardstick of K3's roofline share: the bytes the compact schedule's
work between and after K1's two passes must move, whatever implements
it, at a stated horizon and batch.

K3 reads pass 1's done flag of every lane once and writes the indices of
the `tail_lanes(B)` lanes it hands to pass 2; gathers the tail's inputs
(z0 6, the path's coefficients P, params 12, bounds 2 + 2, pass 1's
controls 2T) and its resume state (done, conv, mu, gnorm), each row read
once and written once, the indices read once; and scatters pass 2's
outputs (the trajectory 8 (T+1), the controls 2T and six per-lane
scalars) into their rows, each read once and written once, the iteration
count adding pass 1's (read once more), the indices read once. The copy of
the whole batch that an out-of-place scatter makes is not the algorithm's
and is not counted. Floats are float32; an index is 32 bits (the kernel
addresses rows by 32-bit offsets, so no batch it takes needs more).
"""

from __future__ import annotations

N = 8        # augmented state rows of the trajectory
M = 2        # controls
N_PAR = 12   # packed per-lane parameters
F32 = 4
IDX = 4
TILE = 128   # K1's block: the tail is whole tiles


def tail_lanes(B: int, compact_tail: float) -> int:
    """The compact tail's lanes: ceil(compact_tail * B / TILE) tiles, at
    least one and at most the batch."""
    n = int(-(-B * compact_tail // TILE)) * TILE
    return max(TILE, min(n, B))


def k3_bytes(n_steps: int, B: int, compact_tail: float,
             n_coeffs: int = 4) -> dict:
    """The bytes of one compact solve's K3 work by part, and their sum."""
    T = n_steps - 1
    tail = tail_lanes(B, compact_tail)
    select = B * F32 + tail * IDX
    gather_rows = 6 + n_coeffs + N_PAR + 2 + 2 + M * T + 4
    gather = 2 * tail * gather_rows * F32 + tail * IDX
    out_rows = N * (T + 1) + M * T + 6
    scatter = 2 * tail * out_rows * F32 + tail * F32 + tail * IDX
    return {"tail_lanes": tail, "select": select, "gather": gather,
            "scatter": scatter, "total": select + gather + scatter}
