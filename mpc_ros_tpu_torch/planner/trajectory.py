"""Direct trajectory tracking: a reference point that moves in time
(counterpart of the single-robot part of `mpc_ros_tpu/planner/
trajectory.py`: `TimedTrajectory`, `TrajectoryDebug`, `TrajectoryTracker`
and its cycle).

Each control cycle samples the timed reference at the horizon knots
t_now + k dt, fits the solver's cubic to those future positions in the
robot frame, builds the per-knot speed profile |dr/dt| plus a proportional
catch-up on the longitudinal lag, and solves with that profile as the
per-knot setpoints (`refs`, and optional robot-frame blobs) through
`solver/ilqr.py::solve`, with the path tracker's transfer diet: one packed
upload of (6 + C + N,), the warm carry kept on the device, one packed
fetch (`_single_cycle`). The sampling and the fit are host numpy. The
tracker runs on the card unless built with `device="cpu"`. The fleet
tracker is ROADMAP Queue 1 item 6.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..config import MPCParams, PlannerConfig, SolverConfig
from ..models.base import get_model
from ..solver import ilqr
from .fsm import normalize_angle
from .tracking import _host_twin, pack_result, resolve_device, unpack_cycle


def _single_cycle(cfg: SolverConfig, inp: torch.Tensor,
                  prev_us: torch.Tensor, p: MPCParams, blobs=None):
    """One trajectory solve on the device: inp (6 + C + N,) = state,
    coefficients and the per-knot speed profile; the cte and etheta
    setpoint columns are zeros built here. The warm start is the previous
    optimum shifted by one knot (a zero carry is the cold start). Returns
    (the packed result, the new carry)."""
    nc = cfg.n_coeffs
    v_ref = inp[6 + nc:]
    zero = torch.zeros_like(v_ref)
    refs = torch.stack([zero, zero, v_ref], dim=-1)
    u_init = torch.cat([prev_us[1:], prev_us[-1:]])
    r = ilqr.solve(inp[:6], inp[6: 6 + nc], p, cfg, u_init=u_init,
                   refs=refs, blobs=blobs)
    return pack_result(r), r.us


@dataclasses.dataclass
class TimedTrajectory:
    """A reference trajectory with timestamps: xy (M, 2) world positions,
    yaw (M,) tangents, t (M,) strictly increasing times [s]."""

    xy: np.ndarray
    yaw: np.ndarray
    t: np.ndarray

    def __post_init__(self):
        self.xy = np.asarray(self.xy, float)
        self.yaw = np.asarray(self.yaw, float)
        self.t = np.asarray(self.t, float)
        if not np.all(np.diff(self.t) > 0):
            raise ValueError("timestamps must be strictly increasing")
        # unwrapped, so interpolation never crosses the +-pi seam
        self._yaw_unwrapped = np.unwrap(self.yaw)

    @property
    def duration(self) -> float:
        return float(self.t[-1] - self.t[0])

    @staticmethod
    def from_path(plan: np.ndarray, speed) -> "TimedTrajectory":
        """Time-parameterize a plan (M, >=2 [x, y[, yaw]]) by a scalar or
        per-waypoint (M,) speed: dt_i = ds_i / v_mid_i. Zero-length
        segments (repeated waypoints) are dropped."""
        plan = np.asarray(plan, float)
        seg = np.hypot(*np.diff(plan[:, :2], axis=0).T)
        keep = np.concatenate([[True], seg > 1e-9])
        plan = plan[keep]
        xy = plan[:, :2]
        if plan.shape[1] >= 3:
            yaw = plan[:, 2]
        else:
            d = np.gradient(xy, axis=0)
            yaw = np.arctan2(d[:, 1], d[:, 0])
        ds = np.hypot(*np.diff(xy, axis=0).T)
        v = np.broadcast_to(np.asarray(speed, float), (len(xy),))
        v_mid = np.maximum(0.5 * (v[1:] + v[:-1]), 1e-6)
        t = np.concatenate([[0.0], np.cumsum(ds / v_mid)])
        return TimedTrajectory(xy=xy, yaw=yaw, t=t)

    def sample(self, times: np.ndarray):
        """The reference at the given times (clamped to [t0, tN]): (xy
        (K, 2), yaw (K,), speed (K,)); the speed is 0 outside the
        schedule."""
        times = np.asarray(times, float)
        tc = np.clip(times, self.t[0], self.t[-1])
        x = np.interp(tc, self.t, self.xy[:, 0])
        y = np.interp(tc, self.t, self.xy[:, 1])
        yaw = np.interp(tc, self.t, self._yaw_unwrapped)
        # |dr/dt| of the linear interpolant: segment length over duration
        ds = np.hypot(*np.diff(self.xy, axis=0).T)
        dt = np.diff(self.t)
        v_seg = ds / dt
        k = np.clip(np.searchsorted(self.t, tc, side="right") - 1,
                    0, len(v_seg) - 1)
        v = v_seg[k]
        v = np.where(times > self.t[-1], 0.0, v)
        v = np.where(times < self.t[0], 0.0, v)
        return np.stack([x, y], axis=-1), yaw, v


@dataclasses.dataclass
class TrajectoryDebug:
    """Per-cycle observability record of the trajectory mode."""

    coeffs: np.ndarray
    state: np.ndarray       # solver z0 (error state)
    refs: np.ndarray        # (N, 3) per-knot setpoint profile
    ref_point: np.ndarray   # (2,) where the reference is now
    lag: float              # longitudinal lag [m] (> 0: behind)
    solve: object
    cost: float


class TrajectoryTracker:
    """Tracks a `TimedTrajectory` with the per-knot-profile NMPC solve; owns
    the Tracking state's cross-cycle actuation state."""

    def __init__(self, params: MPCParams, solver_cfg: SolverConfig,
                 planner_cfg: PlannerConfig = PlannerConfig(),
                 dtype=torch.float32, catchup_gain: float = 0.8,
                 device=None):
        self.device = resolve_device(device)
        self.dtype = dtype
        self.params = params.astype(dtype, self.device)
        self._np_params = _host_twin(params, dtype)
        self.solver_cfg = solver_cfg
        self.planner_cfg = planner_cfg
        # speed catch-up on the longitudinal lag [1/s]: ref_vel[k] +=
        # gain * lag (0: the feedforward profile alone)
        self.catchup_gain = float(catchup_gain)
        self.model = get_model(solver_cfg.model)
        self.traj: Optional[TimedTrajectory] = None
        self.w = 0.0
        self.speed = 0.0
        self._warm_us: Optional[np.ndarray] = None
        self._warm_dev = None
        self.world_obstacles = None

    def set_obstacles(self, blobs) -> None:
        """World-frame `GaussianObstacles` (leaves (K,)) to avoid while
        tracking, moved into the robot frame each cycle. None clears."""
        self.world_obstacles = blobs

    def set_trajectory(self, traj: TimedTrajectory) -> None:
        self.traj = traj
        self.w = 0.0
        self.speed = 0.0
        self._warm_us = None
        self._warm_dev = None

    def finished(self, t_now: float, pose: np.ndarray) -> bool:
        """Past the schedule's end and inside the xy goal tolerance of its
        final point."""
        if self.traj is None:
            return True
        done_t = t_now >= float(self.traj.t[-1])
        d = float(np.hypot(pose[0] - self.traj.xy[-1, 0],
                           pose[1] - self.traj.xy[-1, 1]))
        return done_t and d <= self.planner_cfg.limits.xy_goal_tolerance

    def compute(self, t_now: float, pose: np.ndarray, feedback_v: float):
        """One control cycle at time `t_now`; pose (x, y, yaw). Returns
        ((v_cmd, w_cmd), TrajectoryDebug)."""
        if self.traj is None:
            raise RuntimeError("set_trajectory first")
        cfg = self.solver_cfg
        N = cfg.n_steps
        dt = float(self._np_params.dt)
        px, py, theta = float(pose[0]), float(pose[1]), float(pose[2])
        v = float(feedback_v)

        times = t_now + dt * np.arange(N)
        pts, yaws, speeds = self.traj.sample(times)

        # the future reference positions in the robot frame
        ct, st = np.cos(theta), np.sin(theta)
        dx = pts[:, 0] - px
        dy = pts[:, 1] - py
        x_veh = dx * ct + dy * st
        y_veh = dy * ct - dx * st

        # near the schedule's end the knots clamp onto the final waypoint:
        # the degree drops with the number of distinct abscissae
        n_distinct = int(np.sum(np.abs(np.diff(np.sort(x_veh))) > 1e-6)) + 1
        order = min(cfg.poly_order, N - 1, max(n_distinct - 1, 0))
        if float(np.ptp(x_veh)) < 1e-3:
            order = 0
        c = np.polyfit(x_veh, y_veh, order)[::-1]
        coeffs = np.zeros(cfg.n_coeffs)
        coeffs[: len(c)] = c
        cte = float(np.polyval(coeffs[::-1], 0.0))
        # heading error against the reference tangent now, wrapped
        etheta = normalize_angle(theta - float(yaws[0]))

        # signed lag of the robot behind the reference point, along its
        # tangent (> 0: behind schedule -> speed up)
        hx, hy = np.cos(yaws[0]), np.sin(yaws[0])
        lag = float(dx[0] * hx + dy[0] * hy)

        v_ref = speeds + self.catchup_gain * lag
        v_ref = np.clip(v_ref, 0.0, self.planner_cfg.max_speed)
        refs = np.stack([np.zeros(N), np.zeros(N), v_ref], axis=-1)

        state = np.array([0.0, 0.0, 0.0, v, cte, etheta])
        inp = np.concatenate([state, coeffs, v_ref])
        if self._warm_dev is None:
            self._warm_dev = torch.zeros((cfg.n_controls, 2),
                                         dtype=self.dtype, device=self.device)
        # robot-frame blobs; the solve moves them to its dtype and device
        blobs = (None if self.world_obstacles is None
                 else self.world_obstacles.to_frame((px, py, theta)))
        flat, self._warm_dev = _single_cycle(
            cfg, torch.tensor(inp, dtype=self.dtype, device=self.device),
            self._warm_dev, self.params, blobs)
        res = unpack_cycle(flat.cpu().numpy().astype(float), cfg)
        self._warm_us = res.us

        self.w = float(res.us[0, 0])
        throttle = float(res.us[0, 1])
        self.speed = float(np.clip(v + throttle * dt, 0.0,
                                   self.planner_cfg.max_speed))
        dbg = TrajectoryDebug(
            coeffs=coeffs, state=state, refs=refs, ref_point=pts[0],
            lag=lag, solve=res, cost=float(res.cost))
        return (self.speed, self.w), dbg
