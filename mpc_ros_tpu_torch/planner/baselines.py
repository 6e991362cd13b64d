"""Baseline local planners: Pure Pursuit and DWA (counterpart of
`mpc_ros_tpu/planner/baselines.py`).

The reference's only quantitative benchmark is an A/B closed-loop
comparison of NMPC vs DWA vs Pure Pursuit on one course, produced by
swapping the move_base local-planner plugin. Here the baselines are built
in and share the whole planner lifecycle (FSM, goal latching, plan
pipeline, CSV logging) with `MPCPlanner`, so the three-controller
comparison is one command (`python -m mpc_ros_tpu_torch.sim.compare`) and
differences in the logs measure the control law, not the harness. Both
override only `_make_tracker` / `_tracking_command`.

Pure Pursuit is host numpy, as in the JAX package. DWA scores the whole
velocity window (nv x nw constant-twist arcs) as one batch of torch ops on
the planner's device, in float32 as the JAX package's evaluator does,
with one host read of the winner per cycle; the blob clearance takes the
port's `GaussianObstacles`. The grid-costmap clearance waits for the grid
obstacle maps.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import MPCParams, PlannerConfig
from ..models.obstacles import bilinear_sample
from ..ops.linspace import window as _window
from . import plan_utils
from .planner import MPCPlanner


@dataclasses.dataclass
class _BaselineTracker:
    """Minimal cross-cycle state standing in for TrackingController (the
    lifecycle calls reset/update_params on whatever `_make_tracker` built)."""

    params: MPCParams
    speed: float = 0.0

    def reset(self) -> None:
        self.speed = 0.0
        # DWAPlanner._make_tracker adds `w`; reset it too if present
        if hasattr(self, "w"):
            self.w = 0.0

    def update_params(self, params: MPCParams) -> None:
        self.params = params


def _scheduled_ref_vel(params: MPCParams, planner_cfg: PlannerConfig,
                       pose: np.ndarray, goal: np.ndarray, v: float) -> float:
    """Deceleration scheduling shared with the Tracking state (the
    reference's driving_state.cpp): inside the braking distance
    v^2/max_throttle, scale the reference speed with distance-to-goal."""
    dist = float(np.hypot(pose[0] - goal[0], pose[1] - goal[1]))
    max_thr = float(params.max_throttle)
    if dist <= v * v / max_thr:
        return float(np.clip(max_thr * dist, planner_cfg.min_speed,
                             planner_cfg.max_speed))
    return float(params.ref_vel)


# ---------------------------------------------------------------------------
# Pure Pursuit
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PurePursuitConfig:
    """Geometric pure-pursuit parameters (speed-scaled lookahead)."""

    k_dd: float = 1.2           # lookahead time gain [s]: L = k_dd * v
    min_lookahead: float = 0.3  # [m]
    max_lookahead: float = 1.5  # [m]


class PurePursuitPlanner(MPCPlanner):
    """Pure-pursuit tracking inside the shared planner lifecycle.

    Steers along the circular arc through the lookahead point: with the
    lookahead point at (x_l, y_l) in the robot frame at distance d,
    curvature kappa = 2*y_l/d^2 and omega = v*kappa. Speed follows the
    shared deceleration schedule with an accel-limited ramp
    (|dv| <= max_throttle*dt), mirroring the Tracking state's
    `speed = v + throttle*dt` integration. No solve runs: the planner's
    device is not used."""

    def __init__(self, params: MPCParams = MPCParams(),
                 planner_cfg: PlannerConfig = PlannerConfig(),
                 pp_cfg: PurePursuitConfig = PurePursuitConfig(),
                 **kw):
        super().__init__(params=params, planner_cfg=planner_cfg, **kw)
        self.pp_cfg = pp_cfg

    def _make_tracker(self):
        return _BaselineTracker(self.params)

    def _tracking_command(self, pose, feedback_vel, cut):
        ref_plan = plan_utils.downsample_plan(
            cut, self.planner_cfg.downsample_segments)
        p = self.params
        cfg = self.pp_cfg
        v_fb = float(feedback_vel[0])
        dt = float(p.dt)
        max_thr = float(p.max_throttle)

        ref_v = _scheduled_ref_vel(p, self.planner_cfg, pose, self.goal, v_fb)
        # accel-limited speed ramp toward the scheduled reference speed
        v_cmd = float(np.clip(ref_v, self.tracker.speed - max_thr * dt,
                              self.tracker.speed + max_thr * dt))
        self.tracker.speed = v_cmd

        # lookahead point: first plan point at straight-line distance >= L
        # from the robot (falls back to the last point near the goal)
        L = float(np.clip(cfg.k_dd * max(v_cmd, self.planner_cfg.min_speed),
                          cfg.min_lookahead, cfg.max_lookahead))
        d = np.hypot(cut[:, 0] - pose[0], cut[:, 1] - pose[1])
        ahead = np.nonzero(d >= L)[0]
        target = cut[ahead[0]] if len(ahead) else cut[-1]

        # world -> robot frame
        ct, st = np.cos(pose[2]), np.sin(pose[2])
        dx, dy = target[0] - pose[0], target[1] - pose[1]
        x_l = dx * ct + dy * st
        y_l = dy * ct - dx * st
        d2 = max(x_l * x_l + y_l * y_l, 1e-9)
        w_cmd = float(np.clip(v_cmd * 2.0 * y_l / d2,
                              -float(p.max_angvel), float(p.max_angvel)))
        return (v_cmd, w_cmd), ref_plan, None, None


# ---------------------------------------------------------------------------
# DWA
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DWAConfig:
    """Dynamic-window parameters. The candidate grid and rollout are static
    shapes: one batch of ops evaluates the whole window."""

    nv: int = 9                 # linear-velocity samples in the window
    nw: int = 25                # angular-velocity samples
    window_dt: float = 0.2      # accel window horizon [s] (v0 +- a*window_dt)
    sim_time: float = 1.2       # rollout duration [s]
    sim_steps: int = 12         # rollout sample count
    plan_points: int = 32       # static plan-window size (padded/truncated)
    w_path: float = 4.0         # path-proximity score weight
    w_goal: float = 1.5         # end-distance-to-local-goal weight (progress)
    w_vel: float = 0.5          # speed-tracking weight
    # obstacle handling mirrors ROS dwa_local_planner's costmap scoring:
    # rollouts whose peak obstacle cost exceeds `veto_cost` are treated as
    # colliding (hard veto), plus a small graded clearance bias. A purely
    # graded penalty measurably deadlocks: the repulsive gradient beats the
    # goal-progress term several sigma out and the robot stalls
    w_clear: float = 0.1        # graded clearance weight (if obstacles set)
    veto_cost: float = 25.0     # obstacle cost treated as collision
    w_turn: float = 0.02        # angular-effort tiebreak (prevents idle spin)


def _dwa_eval(cfg: DWAConfig, v0, w0, lim, plan_xy, goal_xy, omap=None,
              blobs=None):
    """Score the dynamic window and return the winner's (v, w), 0-d
    tensors on the inputs' device.

    All candidates (nv*nw constant-twist arcs) are rolled out closed-form —
    x(t) = (v/w)sin(wt), y(t) = (v/w)(1-cos(wt)) — and scored in one batch;
    `argmax` picks the first best on the device. `lim` = [max_accel,
    max_ang_accel_proxy, max_angvel, ref_v, min_v]; `plan_xy` (P, 2) and
    `goal_xy` (2,) in the robot frame; `omap` a robot-frame
    `ObstacleMap` (sampled bilinearly, as costmap_2d does) and `blobs` a
    `GaussianObstacles` with (K,) leaves in the robot frame, each scored
    for clearance."""
    max_thr, max_ang_acc, max_w, ref_v, min_v = (lim[i] for i in range(5))
    vs = _window(v0, max_thr, cfg.window_dt, cfg.nv)
    vs = torch.clamp(vs, min_v, ref_v)
    ws = _window(w0, max_ang_acc, cfg.window_dt, cfg.nw)
    ws = torch.clamp(ws, -max_w, max_w)
    v = vs.repeat_interleave(cfg.nw)                  # (C,)
    w = ws.repeat(cfg.nv)                             # (C,)

    ts = np.linspace(cfg.sim_time / cfg.sim_steps, cfg.sim_time,
                     cfg.sim_steps)
    t = torch.as_tensor(ts, dtype=v.dtype, device=v.device)      # (S,)
    wt = w[:, None] * t[None, :]                      # (C, S)
    # w -> 0 limit: straight line
    small = torch.abs(w)[:, None] < 1e-6
    r = v[:, None] / torch.where(small, torch.ones_like(wt), w[:, None])
    x = torch.where(small, v[:, None] * t[None, :], r * torch.sin(wt))
    y = torch.where(small, torch.zeros_like(wt), r * (1.0 - torch.cos(wt)))

    # path proximity: mean over rollout samples of min distance to the
    # plan window (robot frame)
    dx = x[:, :, None] - plan_xy[None, None, :, 0]
    dy = y[:, :, None] - plan_xy[None, None, :, 1]
    dist = torch.sqrt(dx * dx + dy * dy + 1e-12)      # (C, S, P)
    path_pen = torch.mean(torch.amin(dist, dim=2), dim=1)

    # distance to the local goal at the rollout end — the forward-progress
    # term (a heading-angle term instead rewards spinning in place)
    xe, ye = x[:, -1], y[:, -1]
    goal_pen = torch.hypot(goal_xy[0] - xe, goal_xy[1] - ye)

    vel_pen = torch.abs(v - ref_v)

    score = -(cfg.w_path * path_pen + cfg.w_goal * goal_pen
              + cfg.w_vel * vel_pen + cfg.w_turn * torch.abs(w))

    def apply_clearance(oc, score):
        """oc (C, S): the obstacle cost along each rollout; colliding
        candidates vetoed, the rest biased by mean clearance."""
        colliding = torch.amax(oc, dim=1) > cfg.veto_cost
        return (score - cfg.w_clear * torch.mean(oc, dim=1)
                - torch.where(colliding, 1e6, 0.0))

    if omap is not None:
        oc = omap.weight * bilinear_sample(omap.grid, omap.origin,
                                           omap.resolution,
                                           torch.stack([x, y], -1))
        score = apply_clearance(oc, score)
    if blobs is not None:
        # per-point blob penalty, summed over the blobs
        bdx = x[:, :, None] - blobs.cx
        bdy = y[:, :, None] - blobs.cy
        oc = torch.sum(blobs.w * torch.exp(
            -(bdx * bdx + bdy * bdy) * blobs.gamma), dim=-1)
        score = apply_clearance(oc, score)
    best = torch.argmax(score)
    return v[best], w[best]


class DWAPlanner(MPCPlanner):
    """Dynamic Window Approach inside the shared planner lifecycle.

    Like the reference benchmark's `dwa_local_planner`, candidates are
    (v, w) pairs reachable within one acceleration window, each scored on a
    short constant-twist rollout by path proximity, end distance to the
    local goal, speed tracking, and (optionally) obstacle clearance. The
    whole window is one batch of ops on the planner's device. World-frame
    blobs come through `set_obstacles` (moved into the robot frame each
    cycle); a robot-frame grid costmap through `tracker.obstacle_map`
    (moved to the device once per map it is set to)."""

    def __init__(self, params: MPCParams = MPCParams(),
                 planner_cfg: PlannerConfig = PlannerConfig(),
                 dwa_cfg: DWAConfig = DWAConfig(),
                 max_ang_accel: float = 3.0,
                 **kw):
        super().__init__(params=params, planner_cfg=planner_cfg, **kw)
        self.dwa_cfg = dwa_cfg
        self.max_ang_accel = max_ang_accel

    def _make_tracker(self):
        t = _BaselineTracker(self.params)
        t.w = 0.0
        t.obstacle_map = None
        t.obstacles = None
        # the costmap last set and its copy on the device in float32
        self._omap_src, self._omap_dev = None, None
        return t

    def _tracking_command(self, pose, feedback_vel, cut):
        ref_plan = plan_utils.downsample_plan(
            cut, self.planner_cfg.downsample_segments)
        p = self.params
        cfg = self.dwa_cfg
        v_fb = float(feedback_vel[0])

        ref_v = _scheduled_ref_vel(p, self.planner_cfg, pose, self.goal, v_fb)

        # world -> robot frame plan window, padded to the static size
        ct, st = np.cos(pose[2]), np.sin(pose[2])
        dx = cut[:, 0] - pose[0]
        dy = cut[:, 1] - pose[1]
        pts = np.stack([dx * ct + dy * st, dy * ct - dx * st], -1)
        if len(pts) >= cfg.plan_points:
            idx = np.linspace(0, len(pts) - 1, cfg.plan_points).round()
            pts = pts[idx.astype(int)]
        else:
            pts = np.concatenate(
                [pts, np.repeat(pts[-1:], cfg.plan_points - len(pts), 0)])
        goal_xy = pts[-1]

        # unconditional: set_obstacles(None) must clear the stale snapshot
        self.tracker.obstacles = (
            self.world_obstacles.to_frame(pose)
            if self.world_obstacles is not None else None)
        blobs = self.tracker.obstacles
        dev = self.device
        f32 = torch.float32
        omap = self.tracker.obstacle_map
        if omap is not self._omap_src:
            self._omap_src = omap
            self._omap_dev = None if omap is None else omap.to(f32, dev)
        if blobs is not None:
            blobs = dataclasses.replace(blobs, **{
                k: getattr(blobs, k).to(dev, f32)
                for k in ("cx", "cy", "gamma", "w")})
        # one upload: the limits, the measured state, the plan window
        host = np.concatenate([
            [float(p.max_throttle), self.max_ang_accel, float(p.max_angvel),
             ref_v, 0.0, v_fb, float(feedback_vel[1])],
            np.asarray(pts, np.float64).ravel()]).astype(np.float32)
        flat = torch.from_numpy(host).to(dev)
        pts_d = flat[7:].reshape(cfg.plan_points, 2)
        # center the dynamic window on the MEASURED state, not the last
        # command: after an external stop/safety override the commanded
        # speed is stale and the window would span dynamically infeasible
        # candidates (the guarantee DWA is named after)
        v_cmd, w_cmd = _dwa_eval(cfg, flat[5], flat[6], flat[:5], pts_d,
                                 pts_d[-1], omap=self._omap_dev,
                                 blobs=blobs)
        v_cmd, w_cmd = torch.stack([v_cmd, w_cmd]).tolist()
        self.tracker.speed = v_cmd
        self.tracker.w = w_cmd
        return (v_cmd, w_cmd), ref_plan, None, None
