"""Per-solve cost breakdown and run-level statistics (counterpart of
`mpc_ros_tpu/obs/metrics.py`): the FG_eval objective split by term, read
from any solved trajectory, and an aggregator of a closed-loop run's
per-cycle latency, iterations and convergence. The phase timers are in
`timers.py`, the checkpoints in `checkpoint.py`."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import MPCParams


@dataclasses.dataclass
class CostBreakdown:
    """The FG_eval objective split by term (host floats)."""

    cte: float
    etheta: float
    vel: float
    angvel: float
    accel: float
    angvel_rate: float
    accel_rate: float

    @property
    def total(self) -> float:
        return (self.cte + self.etheta + self.vel + self.angvel
                + self.accel + self.angvel_rate + self.accel_rate)


def cost_breakdown(zs, us, p: MPCParams) -> CostBreakdown:
    """Split the objective as FG_eval accumulates it: zs (N, 6), us
    (N-1, 2), tensors or arrays; computed where zs lies."""
    zs = torch.as_tensor(zs)
    us = torch.as_tensor(us, dtype=zs.dtype, device=zs.device)

    def leaf(name):
        return torch.as_tensor(getattr(p, name), dtype=zs.dtype,
                               device=zs.device)

    du = us[1:] - us[:-1]
    return CostBreakdown(
        cte=float(torch.sum(leaf("w_cte") * (zs[:, 4] - leaf("ref_cte"))
                            ** 2)),
        etheta=float(torch.sum(leaf("w_etheta")
                               * (zs[:, 5] - leaf("ref_etheta")) ** 2)),
        vel=float(torch.sum(leaf("w_vel") * (zs[:, 3] - leaf("ref_vel"))
                            ** 2)),
        angvel=float(torch.sum(leaf("w_angvel") * us[:, 0] ** 2)),
        accel=float(torch.sum(leaf("w_accel") * us[:, 1] ** 2)),
        angvel_rate=float(torch.sum(leaf("w_angvel_d") * du[:, 0] ** 2)),
        accel_rate=float(torch.sum(leaf("w_accel_d") * du[:, 1] ** 2)),
    )


@dataclasses.dataclass
class RunStats:
    """Aggregated per-cycle observability over a closed-loop run."""

    n_cycles: int = 0
    n_solves: int = 0
    n_converged: int = 0
    solve_iters: list = dataclasses.field(default_factory=list)
    cycle_times_s: list = dataclasses.field(default_factory=list)
    costs: list = dataclasses.field(default_factory=list)

    def record_cycle(self, info) -> None:
        """Accepts a planner CycleInfo."""
        self.n_cycles += 1
        self.cycle_times_s.append(info.solve_time_s)
        t = info.tracking
        if t is not None and t.solve is not None:
            self.n_solves += 1
            self.n_converged += int(bool(t.solve.converged))
            self.solve_iters.append(int(t.solve.n_iters))
            self.costs.append(float(t.solve.cost))

    def summary(self) -> dict:
        ct = (np.asarray(self.cycle_times_s) if self.cycle_times_s
              else np.zeros(1))
        it = np.asarray(self.solve_iters) if self.solve_iters else np.zeros(1)
        return {
            "n_cycles": self.n_cycles,
            "n_solves": self.n_solves,
            "converged_frac": (self.n_converged / self.n_solves
                               if self.n_solves else float("nan")),
            "cycle_time_p50_ms": float(np.percentile(ct, 50) * 1e3),
            "cycle_time_p99_ms": float(np.percentile(ct, 99) * 1e3),
            "sqp_iters_mean": float(it.mean()),
            "sqp_iters_max": int(it.max()),
            "mean_cost": (float(np.mean(self.costs)) if self.costs
                          else float("nan")),
        }
