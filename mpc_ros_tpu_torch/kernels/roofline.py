"""Speed-of-light accounting for the solver's hot stages (counterpart of
`mpc_ros_tpu/kernels/roofline.py`).

Analytic operation and device-memory byte counts per stage of the
lane-major batched solve (`solver/batch_lane.py`), a roofline bound from
the device's peaks, and efficiency = bound / measured. The counts are the
JAX package's, term for term; only the device changes. `DeviceSpec`
defaults to the H100 SXM: 3.35e12 B/s of HBM3 and 67e12 f32 operations/s
on the non-tensor pipes (the figures `PERF.md` §6 divides by), and the
whole-solve kernel's compute peak is the spec's, not the TPU's vector
unit.

Counts are per SQP iteration for a batch B, horizon T, state n=8, control
m=2, n_alpha line-search candidates, f32. These are models of the
algorithm, not of K1's own design: `chip_smoke.py`'s bound counts the
stages as K1 runs them (its scratch traffic, the re-roll on accepted
steps only).
"""

from __future__ import annotations

import dataclasses

_N = 8     # augmented state dim
_M = 2     # control dim
_F32 = 4   # bytes


@dataclasses.dataclass(frozen=True)
class DeviceSpec:
    """Peak numbers for the roofline. Defaults: one NVIDIA H100 SXM (f32
    on the CUDA cores: no product of the solve maps onto tensor cores)."""

    name: str = "NVIDIA H100 80GB HBM3"
    peak_flops_f32: float = 67e12
    hbm_bytes_per_s: float = 3.35e12


@dataclasses.dataclass
class StageAccount:
    name: str
    flops: float
    bytes: float

    def roofline_s(self, dev: DeviceSpec) -> float:
        return max(self.flops / dev.peak_flops_f32,
                   self.bytes / dev.hbm_bytes_per_s)

    @property
    def intensity(self) -> float:
        return self.flops / self.bytes


# bytes of one stage's linearization outputs per scenario:
# A(n*n) + B(n*m) + l_s(n) + l_u(m) + l_ss(n*n) + l_uu(m*m) + l_us(m*n)
_STAGE_LIN = (_N * _N + _N * _M + _N + _M + _N * _N + _M * _M + _M * _N)


def account_linearize(B: int, T: int) -> StageAccount:
    """Per-iteration linearize+expand: elementwise over (T, B); reads the
    trajectory slice, writes all stage quadratics."""
    flops = B * T * 80.0                      # trig, polynomial, products
    bytes_ = B * T * ((_N + _M) + _STAGE_LIN) * _F32
    return StageAccount("linearize+expand", flops, bytes_)


def account_backward(B: int, T: int) -> StageAccount:
    """Per-iteration control-limited Riccati scan: per stage ~6 batched
    (8x8)-class matmuls + the 9-combo box QP; reads stage quadratics,
    writes (k, K). The (Vs, Vss) carry stays on chip."""
    matmul_flops = 2 * (_N**3 + 2 * _N * _N * _M + _N * _M * _M
                        + 2 * _M * _M * _N)          # Q-expansion + V update
    boxqp_flops = 9 * 40 + 60                         # enumeration + select
    flops = B * T * float(matmul_flops + boxqp_flops)
    bytes_ = B * T * (_STAGE_LIN + (_M + _M * _N)) * _F32
    return StageAccount("riccati backward", flops, bytes_)


def account_forward(B: int, T: int, n_alpha: int) -> StageAccount:
    """Per-iteration multi-alpha forward rollouts: per stage and alpha a
    feedback matvec + dynamics step + stage cost; writes the candidate
    trajectories (gathered once per iteration)."""
    flops = B * T * n_alpha * (2 * _M * _N + 60.0)
    bytes_ = B * T * ((_N + _M + _M + _M * _N) * _F32          # read bar/k/K
                      + n_alpha * (_N + _M) * _F32 * 2)        # write + gather
    return StageAccount("forward line-search", flops, bytes_)


def account_rollout(B: int, T: int) -> StageAccount:
    """Initial cold/warm-start rollout (once per solve)."""
    flops = B * T * 60.0
    bytes_ = B * T * (_N + _M) * 2 * _F32
    return StageAccount("rollout", flops, bytes_)


def solve_accounting(B: int, T: int, n_alpha: int = 8,
                     n_iters: float = 5.0,
                     dev: DeviceSpec = DeviceSpec()) -> dict:
    """Full-solve accounting: per-iteration stages x n_iters + rollout."""
    stages = [account_linearize(B, T), account_backward(B, T),
              account_forward(B, T, n_alpha)]
    per_iter_flops = sum(s.flops for s in stages)
    per_iter_bytes = sum(s.bytes for s in stages)
    roll = account_rollout(B, T)
    total_flops = per_iter_flops * n_iters + roll.flops
    total_bytes = per_iter_bytes * n_iters + roll.bytes
    total = StageAccount("solve", total_flops, total_bytes)
    return {
        "device": dev.name,
        "B": B,
        "T": T,
        "n_iters": n_iters,
        "stages": {
            s.name: {
                "gflops": s.flops / 1e9,
                "mbytes": s.bytes / 1e6,
                "intensity_flop_per_byte": round(s.intensity, 2),
                "roofline_us": s.roofline_s(dev) * 1e6,
            }
            for s in stages + [roll]
        },
        "solve_roofline_ms": total.roofline_s(dev) * 1e3,
        "solve_gflops": total.flops / 1e9,
        "solve_mbytes": total.bytes / 1e6,
        "bound": ("memory" if total.bytes / dev.hbm_bytes_per_s
                  > total.flops / dev.peak_flops_f32 else "compute"),
    }


def megakernel_accounting(B: int, T: int, n_alpha: int = 8,
                          n_iters: float = 5.0, ddp: bool = False,
                          dev: DeviceSpec = DeviceSpec()) -> dict:
    """Speed-of-light accounting for the whole-solve kernel.

    The model holds the trajectory, gains and loop state on chip for the
    whole solve: device-memory traffic collapses to the problem's inputs
    and final outputs, and the bound is compute. The operations are the
    per-iteration stage counts (the linearization inlined into the
    backward scan; the winner's re-roll one more alpha-like rollout), with
    the gated DDP terms under `ddp`. The compute peak is `dev`'s (the JAX
    package divides by the TPU v5e vector unit's 7.7e12). K1 does not
    keep its trajectory on chip (it streams ~8.5 KB per lane-iteration of
    scratch, `solve_mega.scratch_bytes`), so this bound sits below the one
    `chip_smoke.py` counts for it.
    """
    per_iter = (account_linearize(B, T).flops
                + account_backward(B, T).flops
                + account_forward(B, T, n_alpha + 1).flops)
    if ddp:
        # gated second-order terms: per backward stage the f''(x) Horner,
        # the five dmap entry products and their Qss additions
        per_iter += 35.0 * B * T
    flops = per_iter * n_iters + account_rollout(B, T).flops
    in_bytes = B * (6 + 4 + 12 + 2 + 2 + 2 * T) * _F32
    # 6 per-lane scalar outputs: cost, conv, iters, gnorm, mu, done
    out_bytes = B * (_N * (T + 1) + _M * T + 6) * _F32
    bytes_ = float(in_bytes + out_bytes)
    t_compute = flops / dev.peak_flops_f32
    t_hbm = bytes_ / dev.hbm_bytes_per_s
    return {
        "device": dev.name,
        "kernel": "megakernel",
        "B": B,
        "T": T,
        "n_iters": n_iters,
        "solve_gflops": flops / 1e9,
        "solve_mbytes": bytes_ / 1e6,
        "intensity_flop_per_byte": round(flops / bytes_, 1),
        "peak_tflops_f32": dev.peak_flops_f32 / 1e12,
        "solve_roofline_ms": max(t_compute, t_hbm) * 1e3,
        "bound": "compute" if t_compute > t_hbm else "memory",
    }


def efficiency(measured_s: float, accounting: dict) -> float:
    """Fraction of speed-of-light achieved by a measured batch-solve time."""
    return accounting["solve_roofline_ms"] / 1e3 / measured_s
