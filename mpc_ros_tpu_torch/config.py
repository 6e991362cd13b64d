"""Typed configuration for the PyTorch/CUDA port of the NMPC framework.

The counterpart of `mpc_ros_tpu/config.py`, with the same two layers:

* `MPCParams` — every numeric solver parameter. A leaf is a Python float
  or a tensor: 0-d for a shared value, `(B,)` for a per-scenario value
  (Monte-Carlo weight sweeps ride the batch lanes unchanged).
* `SolverConfig` — static shape/iteration knobs with every resolution
  policy of the JAX package (line-search width, pg tolerance, the gated
  GN->DDP profile, the horizon-aware gate and mu floor) unchanged, so the
  two packages resolve the same knobs for the same configuration.

and the planner's `PlannerConfig` / `PlannerLimits` (plain host values).

Dtypes are torch dtypes; the dtype checks use `torch.finfo`.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import numpy as np
import torch

Leaf = Any  # float or torch.Tensor (0-d or (B,))

# the seven cost weights (what weight sweeps perturb)
WEIGHT_NAMES = ("w_cte", "w_etheta", "w_vel", "w_angvel", "w_accel",
                "w_angvel_d", "w_accel_d")


@dataclasses.dataclass(frozen=True)
class MPCParams:
    """Numeric NMPC parameters (defaults equal the JAX package's)."""

    dt: Leaf = 0.1            # control period [s]
    ref_cte: Leaf = 0.0       # cross-track error setpoint
    ref_etheta: Leaf = 0.0    # heading error setpoint
    ref_vel: Leaf = 0.5       # reference speed [m/s]
    w_cte: Leaf = 100.0       # cross-track error weight
    w_etheta: Leaf = 100.0    # heading error weight
    w_vel: Leaf = 100.0       # speed tracking weight
    w_angvel: Leaf = 100.0    # angular-velocity magnitude weight
    w_accel: Leaf = 50.0      # acceleration magnitude weight
    w_angvel_d: Leaf = 10.0   # angular-velocity rate weight
    w_accel_d: Leaf = 10.0    # acceleration rate weight
    max_angvel: Leaf = 1.0    # |omega| bound [rad/s]
    max_throttle: Leaf = 1.0  # |accel| bound [m/s^2]
    bound_value: Leaf = 1.0e3  # box bound for non-actuator vars
    lf: Leaf = 0.5            # bicycle: CoG -> front-axle distance [m]
    max_steer: Leaf = 0.6     # bicycle: |delta| steering bound [rad]

    def astype(self, dtype, device=None) -> "MPCParams":
        """Every leaf as a tensor of `dtype` (on `device`, if given)."""
        return MPCParams(**{
            f.name: torch.as_tensor(getattr(self, f.name), dtype=dtype,
                                    device=device)
            for f in dataclasses.fields(self)})

    @staticmethod
    def reference_defaults() -> "MPCParams":
        """The reference planner's own live defaults (the same values as
        `mpc_ros_tpu.config.MPCParams.reference_defaults`)."""
        return MPCParams(
            dt=0.1, ref_cte=0.0, ref_etheta=0.0, ref_vel=1.0,
            w_cte=1000.0, w_etheta=1000.0, w_vel=100.0, w_angvel=100.0,
            w_accel=50.0, w_angvel_d=0.0, w_accel_d=10.0,
            max_angvel=1.0, max_throttle=1.0, bound_value=1.0e3)

    @staticmethod
    def from_numpy(leaves: Mapping[str, Any], dtype=None,
                   device=None) -> "MPCParams":
        """Params from a dict of numpy (or Python scalar) leaves — the way
        parameters cross over from the JAX package
        (`{f: np.asarray(getattr(p, f))}`). Missing names keep their
        defaults; unknown names raise. `dtype=None` keeps each leaf's
        numpy dtype."""
        names = {f.name for f in dataclasses.fields(MPCParams)}
        unknown = set(leaves) - names
        if unknown:
            raise ValueError(f"unknown MPCParams leaves: {sorted(unknown)}")
        return MPCParams(**{
            k: torch.tensor(np.asarray(v), dtype=dtype, device=device)
            for k, v in leaves.items()})

    def to_numpy(self) -> dict:
        """Every leaf as a numpy array (the inverse of `from_numpy`)."""
        out = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            out[f.name] = (v.detach().cpu().numpy()
                           if isinstance(v, torch.Tensor) else np.asarray(v))
        return out


def _eps(dtype) -> float:
    return float(torch.finfo(dtype).eps)


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Static solver configuration; the knobs and their resolution policy
    are those of `mpc_ros_tpu.config.SolverConfig` (see its comments for
    the measurements behind each default)."""

    n_steps: int = 20          # horizon knots N
    poly_order: int = 3        # reference-path polynomial order (cubic)
    model: str = "diff_drive"  # vehicle-dynamics family
    max_sqp_iters: int = 60    # outer SQP/iLQR iteration cap
    # parallel line-search step sizes 0.5^j; None resolves with the ddp
    # profile (4 with the gated GN->DDP backward, 8 for pure GN)
    ls_iters: "int | None" = None
    # projected-gradient threshold; None = 1e-4 in f32, 1e-7 in f64
    tol_grad: "float | None" = None
    tol_cost: float = 1e-12    # relative cost-decrease threshold
    # initial/floor Levenberg regularization; "auto" couples with the
    # horizon-aware DDP gate (see _long_horizon_pair)
    mu_init: "float | str" = "auto"
    mu_factor: float = 10.0
    mu_max: float = 1e8
    # stop once this fraction of lanes is done (1.0 = every lane)
    done_frac: float = 1.0
    # "auto" (the whole-solve kernel on CUDA tensors, the XLA lane path on
    # CPU tensors) | "mega" (the whole-solve kernel) | "pallas" (the
    # two-kernel route) | "xla" (the XLA lane path); the kernels take f32
    # with B % 128 == 0, anything else runs the XLA lane path
    backward: str = "auto"
    horizon_parallel: bool = False
    # gated GN->DDP second-order backward terms; "auto" = on in f32
    ddp: "bool | str" = "auto"
    ddp_gate: "float | None" = None
    # per-lane weight scale s = max(1, sum(w)/470) on mu bounds and pg
    scale_adaptive: bool = True
    cte_vsin_sign: float = 1.0
    # iteration schedule: "auto" resolves to the single pass at N <= 36
    schedule: str = "auto"
    presolve_iters: int = 3
    compact_frac: float = 0.97
    compact_tail: float = 0.06
    # rollout trigonometry: "fast" (transcendental-free) or "exact"
    trig: str = "fast"

    def ls_for(self, dtype) -> int:
        """Effective line-search candidate count for a compute dtype."""
        if self.ls_iters is not None:
            return int(self.ls_iters)
        return 4 if self.ddp_for(dtype) else 8

    def tol_grad_for(self, dtype) -> float:
        """Effective projected-gradient threshold for a compute dtype."""
        if self.tol_grad is not None:
            return float(self.tol_grad)
        return 1e-4 if _eps(dtype) > 1e-10 else 1e-7

    def _long_horizon_pair(self, dtype, has_obstacles: bool,
                           has_omaps: bool = False) -> bool:
        """True when the long-horizon coupled auto policy (gate 1.5, mu
        floor 1e-2) applies: DDP active in this dtype, N > 32, both knobs
        on auto, no obstacle terms, a backward that carries DDP."""
        return (self.n_steps > 32 and not has_obstacles and not has_omaps
                and not self.horizon_parallel and self.backward != "pallas"
                and self.ddp_gate is None and self.mu_init == "auto"
                and dtype is not None and self.ddp_for(dtype))

    def mu_init_for(self, dtype=None, has_obstacles: bool = False,
                    has_omaps: bool = False) -> float:
        """Effective initial/floor regularization."""
        if self.mu_init != "auto":
            return float(self.mu_init)
        return 1e-2 if self._long_horizon_pair(dtype, has_obstacles,
                                               has_omaps) else 1e-6

    def ddp_for(self, dtype) -> bool:
        """Effective hybrid GN->DDP switch for a compute dtype."""
        if self.ddp != "auto":
            return bool(self.ddp)
        if self.horizon_parallel or self.backward == "pallas":
            return False
        return _eps(dtype) > 1e-10

    def gate_for(self, has_obstacles: bool = False, dtype=None,
                 has_omaps: bool = False) -> float:
        """Effective DDP gate: explicit values verbatim; auto is 2.5 at
        N <= 32, above that 1.5 with the coupled mu floor else 0.75, and
        capped at 0.75 with obstacle terms."""
        if self.ddp_gate is not None:
            return float(self.ddp_gate)
        if self.n_steps <= 32:
            gate = 2.5
        else:
            gate = 1.5 if self._long_horizon_pair(dtype, has_obstacles,
                                                  has_omaps) else 0.75
        return min(gate, 0.75) if has_obstacles else gate

    @property
    def ddp_gate_eff(self) -> float:
        """Obstacle-free, dtype-agnostic (conservative) gate."""
        return self.gate_for(False)

    @property
    def n_controls(self) -> int:
        """Number of control steps T = N - 1."""
        return self.n_steps - 1

    @property
    def n_coeffs(self) -> int:
        return self.poly_order + 1

    @property
    def n_vars(self) -> int:
        """Reference NLP decision-vector size: 6N + 2(N-1)."""
        return 6 * self.n_steps + 2 * (self.n_steps - 1)

    @property
    def n_constraints(self) -> int:
        """Reference NLP constraint count: 6N."""
        return 6 * self.n_steps


def per_lane_leaf_names(params: MPCParams) -> tuple:
    """Sorted names of the per-scenario ((B,)-shaped) MPCParams leaves (a
    tensor's dimensions are read without moving it to the host)."""
    return tuple(sorted(
        f.name for f in dataclasses.fields(MPCParams)
        if np.ndim(getattr(params, f.name)) >= 1))


@dataclasses.dataclass(frozen=True)
class PlannerLimits:
    """Generic local-planner limits (the goal tolerances and the stopped
    check of the reference's LocalPlannerLimits)."""

    xy_goal_tolerance: float = 0.2
    yaw_goal_tolerance: float = 0.1
    trans_stopped_vel: float = 0.1
    theta_stopped_vel: float = 0.1


@dataclasses.dataclass(frozen=True)
class PlannerConfig:
    """Planner-level configuration; the fields and defaults are those of
    `mpc_ros_tpu.config.PlannerConfig` (see its comments for the reference
    behaviour behind each)."""

    limits: PlannerLimits = dataclasses.field(default_factory=PlannerLimits)
    # heading error below which Tracking engages
    heading_yaw_error_threshold: float = 0.1
    # FSM speed policy
    max_speed: float = 0.7
    min_speed: float = 0.05
    # P-gain of the two rotation states
    rotate_p_gain: float = 0.5
    # one-control-period latency compensation
    delay_mode: bool = True
    # lookahead window [m]: the plan is clipped to this arclength before
    # fitting
    local_plan_length: float = 4.0
    # plan downsampling: target number of reference segments
    downsample_segments: int = 10
    # cap ref_vel at sqrt(max_lat_accel / kappa) over the local window
    curvature_slowdown: bool = False
    max_lat_accel: float = 1.0   # [m/s^2]
    # wrap the extracted heading error to [-pi, pi] (quirk Q13 fix)
    wrap_etheta: bool = True
    debug_info: bool = False
