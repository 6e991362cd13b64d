"""The yardstick of K1's roofline share: operations the algorithm needs,
bytes each input and output moves once, and the card's peaks.

The operation counts are a frozen copy of the per-iteration, per-stage
counts of `mpc_ros_tpu_torch/kernels/roofline.py`
(`megakernel_accounting`): the linearization inlined into the backward
scan, the Riccati backward with its box QP, n_ls + 1 rollouts (the line
search's candidates and the winner's re-roll), the gated DDP terms, and
one initial rollout per solve. They count the algorithm, not how a kernel
implements it. Multiplied by the SQP iterations each lane ran, as the
solve's outputs report them.

Bytes: every input read once (z0 6, coeffs 4, params 12, bounds 2 + 2,
warm start 2T floats per lane) and every output written once (the
trajectory 8 (T+1), the controls 2T and six per-lane scalars), float32.
"""

from __future__ import annotations

N = 8    # augmented state
M = 2    # controls
F32 = 4

# NVIDIA H100 SXM (data sheet; dense, without sparsity), at a 700 W limit:
# float32 on the CUDA cores (no product of the solve maps onto tensor
# cores), and HBM3
PEAK_FLOPS_F32 = 67e12
PEAK_BYTES_PER_S = 3.35e12


def ops_per_lane_iteration(T: int, n_ls: int, ddp: bool) -> float:
    linearize = 80.0
    matmul = 2 * (N ** 3 + 2 * N * N * M + N * M * M + 2 * M * M * N)
    boxqp = 9 * 40 + 60
    forward = (n_ls + 1) * (2 * M * N + 60.0)
    per_stage = linearize + matmul + boxqp + forward + (35.0 if ddp else 0.0)
    return per_stage * T


def ops_per_lane_rollout(T: int) -> float:
    return 60.0 * T


def bytes_per_lane(T: int) -> float:
    inputs = 6 + 4 + 12 + 2 + 2 + 2 * T
    outputs = N * (T + 1) + M * T + 6
    return float((inputs + outputs) * F32)


def roofline_s(lane_iterations: float, lanes: float, T: int, n_ls: int,
               ddp: bool) -> tuple:
    """The least time the card could take for `lanes` solves that ran
    `lane_iterations` SQP iterations in all: (seconds, "operations" or
    "bytes")."""
    ops = (ops_per_lane_iteration(T, n_ls, ddp) * lane_iterations
           + ops_per_lane_rollout(T) * lanes)
    t_ops = ops / PEAK_FLOPS_F32
    t_bytes = bytes_per_lane(T) * lanes / PEAK_BYTES_PER_S
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
