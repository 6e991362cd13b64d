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
fetch. The solve is the counterpart of JAX's `_single_cycle_jit`: a
`CapturedSolve` per signature (`tracking.captured_cycle`: CUDA graphs on
the card, the same bodies called eagerly on the CPU; the private
`_graphed = False` runs the eager `tracking._cycle`). The sampling and the
fit are host numpy. The tracker runs on the card unless built with
`device="cpu"`.

`FleetTrajectoryTracker` (counterpart of the fleet half of the JAX
module) runs the same cycle for B robots with one batched solve through
`batch_solve_lane(refs=...)`: on the card, in float32 at B % 128 == 0,
one launch of the whole-solve kernel with its per-knot setpoints (K1
stage (f)). `pipeline="host"` keeps the sampling and the fit in float64
numpy; `pipeline="device"` runs the whole cycle on the device
(`_traj_cycle`): one upload of the (B, 4) world state and the time, the
warm bank kept on the device, one fetch of a (3, B) tile. With a device
mesh (`mesh=`, device pipeline only) that cycle runs per data shard, each
shard's constants and warm bank on its device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..config import MPCParams, PlannerConfig, SolverConfig
from ..models.base import get_model
from ..models.obstacles import GaussianObstacles
from ..solver import graphed, ilqr
from ..solver.batch_lane import batch_solve_lane
from .fleet import _blobs_to_frames, fetch, upload
from .fleet_device import _chol_solve_small
from .fsm import normalize_angle
from .tracking import (_cycle, _host_twin, resolve_device, run_captured,
                       unpack_cycle)


def _unpack_trajectory(cfg: SolverConfig):
    """The trajectory cycle's packed input: inp (6 + C + N,) = state,
    coefficients and the per-knot speed profile -> (z0, coeffs, p, refs);
    the cte and etheta setpoint columns are zeros built here."""
    nc = cfg.n_coeffs

    def unpack(inp, p):
        v_ref = inp[6 + nc:]
        zero = torch.zeros_like(v_ref)
        return (inp[:6], inp[6: 6 + nc], p,
                torch.stack([zero, zero, v_ref], dim=-1))

    return unpack


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
        # the previous optimum on the device, written in place (zeros:
        # the cold start)
        self._warm_dev = torch.zeros((solver_cfg.n_controls, 2),
                                     dtype=dtype, device=self.device)
        # the captured solves per signature; False runs the eager
        # `tracking._cycle`
        self._captured: dict = {}
        self._graphed = True
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
        self._warm_dev.zero_()

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
        # robot-frame blobs; the solve moves them to its dtype and device
        blobs = (None if self.world_obstacles is None
                 else self.world_obstacles.to_frame((px, py, theta)))
        if self._graphed and graphed.capturable(cfg):
            flat = run_captured(self._captured, cfg, self._warm_dev, inp,
                                self.params, blobs, None,
                                _unpack_trajectory(cfg))
        else:
            flat_t, us = _cycle(
                cfg, torch.tensor(inp, dtype=self.dtype, device=self.device),
                self._warm_dev, self.params, blobs,
                unpack=_unpack_trajectory(cfg))
            self._warm_dev.copy_(us)
            flat = flat_t.cpu().numpy()
        res = unpack_cycle(flat.astype(float), cfg)
        self._warm_us = res.us

        self.w = float(res.us[0, 0])
        throttle = float(res.us[0, 1])
        self.speed = float(np.clip(v + throttle * dt, 0.0,
                                   self.planner_cfg.max_speed))
        dbg = TrajectoryDebug(
            coeffs=coeffs, state=state, refs=refs, ref_point=pts[0],
            lag=lag, solve=res, cost=float(res.cost))
        return (self.speed, self.w), dbg


def _traj_cycle(cfg: SolverConfig, max_speed: float, catchup_gain: float,
                l_scale: float, dtype, consts: dict, warm: torch.Tensor,
                world: torch.Tensor, tnow: torch.Tensor, p, *blob_leaves):
    """One fleet trajectory cycle on the device: timed sampling, frame
    transform, batched fit, speed-profile build, the warm solve with
    per-knot setpoints, command extraction. world (B, 4): poses (x, y,
    yaw) and the measured speed, float32; tnow (2,): [t_now, the global
    max dt of the fleet] (computed once per set_trajectories). Returns
    (us (B, T, 2), out (3, B): v_cmd, w_cmd and the lag, obs (6, B): cte,
    etheta, ref_v[0], cost, converged, iterations).

    The JAX program reads each knot's bracketing timeline entries by
    one-hot masked sums over the padded timelines (gathers are slow on
    the TPU); here the index is a `searchsorted` (the count of t <= tc on
    each sorted, +inf padded row) and the entries row gathers, which read
    the same elements."""
    N = cfg.n_steps
    P = cfg.n_coeffs
    t = consts["t"]                  # (B, M), +inf padded
    plen = consts["len"]             # (B,) int32
    B, M = t.shape
    fdt = t.dtype
    dev = t.device
    px, py, pth, v_fb = (world[:, i] for i in range(4))
    # the horizon's step is the global max over the robots' dt
    dt = tnow[1]
    times = tnow[0] + dt * torch.arange(N, dtype=fdt, device=dev)   # (N,)

    t0 = t[:, 0]
    tN = t.gather(1, torch.clamp(plen - 1, min=0).long()[:, None])[:, 0]
    tc = torch.clamp(times[None, :].expand(B, N), t0[:, None],
                     tN[:, None])                                  # (B, N)
    k0 = torch.clamp(torch.searchsorted(t, tc.contiguous(), right=True) - 1,
                     0, M - 2)
    k1 = k0 + 1

    def g(a, i):
        return a.gather(1, i)

    t_lo, t_hi = g(t, k0), g(t, k1)
    w = torch.where(t_hi > t_lo,
                    (tc - t_lo) / torch.clamp(t_hi - t_lo, min=1e-12), 0.0)
    w = torch.clamp(w, 0.0, 1.0)
    x_s = g(consts["x"], k0) * (1 - w) + g(consts["x"], k1) * w
    y_s = g(consts["y"], k0) * (1 - w) + g(consts["y"], k1) * w
    yaw_s = g(consts["yawu"], k0) * (1 - w) + g(consts["yawu"], k1) * w
    v_s = g(consts["vseg_pad"], k0)
    off = (times[None, :] > tN[:, None]) | (times[None, :] < t0[:, None])
    v_s = torch.where(off, 0.0, v_s)

    # robot-frame transform and the batched masked fit (scaled abscissa,
    # unrolled Cholesky, as in the fleet's device cycle)
    ct, st = torch.cos(pth), torch.sin(pth)
    dx = x_s - px[:, None]
    dy = y_s - py[:, None]
    x_veh = dx * ct[:, None] + dy * st[:, None]
    y_veh = dy * ct[:, None] - dx * st[:, None]
    n_distinct = (torch.abs(torch.diff(torch.sort(x_veh, dim=1).values,
                                       dim=1)) > 1e-6).to(torch.int32).sum(
        dim=1, dtype=torch.int32) + 1
    order = torch.clamp(n_distinct - 1, min=0,
                        max=min(cfg.poly_order, N - 1))
    ptp = torch.amax(x_veh, dim=1) - torch.amin(x_veh, dim=1)
    order = torch.where(ptp < 1e-3, 0, order)
    xs = x_veh * (1.0 / l_scale)
    cols = [torch.ones_like(xs)]
    for _ in range(1, P):
        cols.append(cols[-1] * xs)
    V = torch.stack(cols, dim=-1)
    qmask = (torch.arange(P, device=dev)[None, :]
             <= order[:, None]).to(fdt)
    V = V * qmask[:, None, :]
    G = torch.einsum("bni,bnj->bij", V, V)
    G = G + 1e-12 * torch.eye(P, dtype=fdt, device=dev)
    rhs = torch.einsum("bni,bn->bi", V, y_veh)
    unscale = (1.0 / l_scale) ** torch.arange(P, dtype=fdt, device=dev)
    coeffs = _chol_solve_small(G, rhs) * qmask * unscale[None, :]

    cte = coeffs[:, 0]
    etheta = (pth - yaw_s[:, 0] + np.pi) % (2.0 * np.pi) - np.pi
    hx, hy = torch.cos(yaw_s[:, 0]), torch.sin(yaw_s[:, 0])
    lag = dx[:, 0] * hx + dy[:, 0] * hy

    v_ref = torch.clamp(v_s + catchup_gain * lag[:, None], 0.0, max_speed)
    zN = torch.zeros_like(v_ref)
    refs = torch.stack([zN, zN, v_ref], dim=-1).to(dtype)
    z = torch.zeros(B, dtype=fdt, device=dev)
    z0s = torch.stack([z, z, z, v_fb, cte, etheta], dim=1).to(dtype)
    u_init = torch.cat([warm[:, 1:], warm[:, -1:]], dim=1).to(dtype)
    blobs = None
    if blob_leaves:
        blobs = _blobs_to_frames(GaussianObstacles(*blob_leaves),
                                 world[:, :3], dtype)
    res = batch_solve_lane(z0s, coeffs.to(dtype), p, cfg, u_init=u_init,
                           refs=refs, blobs=blobs)
    u0 = res.us[:, 0, :].to(fdt)
    v_cmd = torch.clamp(v_fb + u0[:, 1] * dt, 0.0, max_speed)
    out = torch.stack([v_cmd, u0[:, 0], lag])
    obs = torch.stack([
        cte, etheta, v_ref[:, 0], res.cost.to(fdt),
        res.converged.to(fdt), res.n_iters.to(fdt)])
    return res.us, out, obs


class FleetTrajectoryTracker:
    """B robots chasing B timed references with one batched solve per
    cycle: the fleet twin of `TrajectoryTracker` (the same per-cycle math,
    vectorized). Trajectories live in padded (B, M) buffers; the horizon
    sampling is one flat searchsorted over the fleet, the cubic fits are
    batched normal equations, and the per-knot setpoint profiles go
    through `batch_solve_lane(refs=...)` (K1 stage (f) on the card; custom
    families run on `engine.batch_solve`).

    `pipeline="device"` runs the whole cycle on the device (`_traj_cycle`)
    with the warm bank kept there: one (B, 4) upload and one (3, B) fetch
    per cycle. The default "host" pipeline keeps the per-cycle math in
    float64 numpy."""

    def __init__(self, params: MPCParams, solver_cfg: SolverConfig,
                 planner_cfg: PlannerConfig = PlannerConfig(),
                 dtype=torch.float32, catchup_gain: float = 0.8,
                 pipeline: str = "host", mesh=None, obs_every: int = 0,
                 device=None):
        """`obs_every`: fill `self.last_obs`, a (6, B) per-robot tile (cte,
        etheta, ref_v[0], cost, converged, iters), every K cycles (0 =
        never: commands and lags alone come back; on skipped cycles
        last_obs is None).

        `mesh`: an optional `parallel.Mesh` (device pipeline only): the
        device cycle runs per data shard, B / n_data robots each, with no
        communication between shards; the commands equal the unsharded
        cycle's."""
        assert pipeline in ("host", "device"), pipeline
        assert mesh is None or pipeline == "device", \
            "mesh sharding requires pipeline='device'"
        self.mesh = mesh
        self.device = resolve_device(device)
        self.dtype = dtype
        self.params = params.astype(dtype, self.device)
        self._np_params = _host_twin(params, dtype)
        self.solver_cfg = solver_cfg
        self.planner_cfg = planner_cfg
        self.catchup_gain = float(catchup_gain)
        self.pipeline = pipeline
        self.obs_every = int(obs_every)
        self.last_obs: Optional[np.ndarray] = None
        self._cycle_count = 0
        self.B = 0
        self._warm_us = None
        self.world_obstacles = None
        self._world_dev = None

    def set_obstacles(self, blobs) -> None:
        """World-frame per-robot obstacles (`GaussianObstacles`, leaves
        (B, K)) to avoid while tracking, moved to the device once here and
        into each robot's frame every cycle. None clears."""
        self.world_obstacles = blobs
        self._world_dev = None if blobs is None else GaussianObstacles(*(
            torch.as_tensor(getattr(blobs, f), dtype=self.dtype,
                            device=self.device)
            for f in ("cx", "cy", "gamma", "w")))

    def set_trajectories(self, trajs: list) -> None:
        """Install B `TimedTrajectory` objects (padded internally)."""
        B = len(trajs)
        self.B = B
        M = max(len(tr.t) for tr in trajs)
        self._xy = np.zeros((B, M, 2))
        self._yawu = np.zeros((B, M))
        self._t = np.full((B, M), np.inf)
        self._len = np.zeros(B, np.int64)
        self._vseg = np.zeros((B, max(M - 1, 1)))
        for i, tr in enumerate(trajs):
            n = len(tr.t)
            self._len[i] = n
            self._xy[i, :n] = tr.xy
            # padded with the final waypoint: clamped samples park there
            self._xy[i, n:] = tr.xy[-1]
            self._yawu[i, :n] = tr._yaw_unwrapped
            self._yawu[i, n:] = tr._yaw_unwrapped[-1]
            self._t[i, :n] = tr.t
            ds = np.hypot(*np.diff(tr.xy, axis=0).T)
            dt_ = np.diff(tr.t)
            self._vseg[i, :n - 1] = ds / dt_
        self._t_end = np.array([tr.t[-1] for tr in trajs])
        self._goal = np.stack([tr.xy[-1] for tr in trajs])
        # the horizon's step: the global max of the robots' dt, once per
        # set of trajectories
        self._dt_max = float(np.max(self._np_params.dt))
        self._warm_us = None
        self.last_obs = None
        self._cycle_count = 0
        if self.pipeline == "device":
            f32 = torch.float32
            vseg_pad = np.zeros((B, M))
            vseg_pad[:, : self._vseg.shape[1]] = self._vseg
            leaves = dict(t=self._t, x=self._xy[..., 0], y=self._xy[..., 1],
                          yawu=self._yawu, vseg_pad=vseg_pad)
            self._dev_consts = {k: upload(v, f32, self.device)
                                for k, v in leaves.items()}
            self._dev_consts["len"] = upload(self._len, torch.int32,
                                             self.device)
            if self.mesh is not None:
                from ..parallel.sharded import split_rows

                self._dev_consts = split_rows(self.mesh, self._dev_consts, B)

    def finished(self, t_now: float, poses: np.ndarray) -> np.ndarray:
        """(B,) flags: past the schedule's end and inside the xy
        tolerance."""
        d = np.hypot(poses[:, 0] - self._goal[:, 0],
                     poses[:, 1] - self._goal[:, 1])
        return ((t_now >= self._t_end)
                & (d <= self.planner_cfg.limits.xy_goal_tolerance))

    def _sample(self, times: np.ndarray):
        """Vectorized TimedTrajectory.sample over the fleet: times (B, K)
        -> (xy (B, K, 2), yaw (B, K), speed (B, K))."""
        B, M = self._t.shape
        K = times.shape[1]
        t0 = self._t[:, 0]
        tN = np.take_along_axis(self._t, (self._len - 1)[:, None], 1)[:, 0]
        tc = np.clip(times, t0[:, None], tN[:, None])
        # one flat searchsorted across all rows: each row's (sorted)
        # timeline offset by i * C, C above every finite time
        fin = np.isfinite(self._t)
        tmax = float(self._t[fin].max()) if fin.any() else 1.0
        C = tmax + 2.0
        tpad = np.where(fin, self._t, tmax + 1.0)
        base = np.arange(B)[:, None] * C
        flat = (tpad + base).ravel()
        k = np.searchsorted(flat, (tc + base).ravel(), side="right")
        k = (k - (np.arange(B) * M).repeat(K)).reshape(B, K)
        k0 = np.clip(k - 1, 0, M - 2)
        g = lambda a: np.take_along_axis(a, k0, 1)  # noqa: E731
        t_lo = g(self._t)
        t_hi = np.take_along_axis(self._t, k0 + 1, 1)
        w = np.where(t_hi > t_lo, (tc - t_lo) / np.maximum(t_hi - t_lo,
                                                           1e-12), 0.0)
        w = np.clip(w, 0.0, 1.0)
        x = g(self._xy[..., 0]) * (1 - w) + np.take_along_axis(
            self._xy[..., 0], k0 + 1, 1) * w
        y = g(self._xy[..., 1]) * (1 - w) + np.take_along_axis(
            self._xy[..., 1], k0 + 1, 1) * w
        yaw = g(self._yawu) * (1 - w) + np.take_along_axis(
            self._yawu, k0 + 1, 1) * w
        v = np.take_along_axis(self._vseg,
                               np.clip(k0, 0, self._vseg.shape[1] - 1), 1)
        v = np.where((times > tN[:, None]) | (times < t0[:, None]), 0.0, v)
        return np.stack([x, y], -1), yaw, v

    def _want_obs(self) -> bool:
        want = self.obs_every > 0 and (
            self._cycle_count % self.obs_every == 0)
        self._cycle_count += 1
        return want

    def compute(self, t_now: float, poses: np.ndarray,
                feedback_v: np.ndarray):
        """One fleet cycle: poses (B, 3), feedback_v (B,). Returns (cmds
        (B, 2) = (v, w), lags (B,))."""
        assert self.B, "set_trajectories first"
        if self.pipeline == "device":
            return self._compute_device(t_now, poses, feedback_v)
        cfg = self.solver_cfg
        N = cfg.n_steps
        B = self.B
        dt = self._dt_max
        poses = np.asarray(poses, float)
        times = t_now + dt * np.arange(N)[None, :].repeat(B, 0)
        pts, yaws, speeds = self._sample(times)

        th = poses[:, 2]
        ct, st = np.cos(th), np.sin(th)
        dx = pts[..., 0] - poses[:, 0, None]
        dy = pts[..., 1] - poses[:, 1, None]
        x_veh = dx * ct[:, None] + dy * st[:, None]
        y_veh = dy * ct[:, None] - dx * st[:, None]

        # the batched cubic fit (normal equations; the degree capped by
        # the distinct abscissae, as in the single-robot tracker), one
        # padded solve for every order: the columns above a robot's order
        # are zeroed, which decouples them in the regularized equations
        n_distinct = (np.abs(np.diff(np.sort(x_veh, axis=1), axis=1))
                      > 1e-6).sum(axis=1) + 1
        order = np.minimum(np.minimum(cfg.poly_order, N - 1),
                           np.maximum(n_distinct - 1, 0))
        order = np.where(np.ptp(x_veh, axis=1) < 1e-3, 0, order)
        P = cfg.n_coeffs
        cols = [np.ones_like(x_veh)]
        for q in range(1, P):
            cols.append(cols[-1] * x_veh)
        V = np.stack(cols, axis=-1)                       # (B, N, P)
        qmask = (np.arange(P)[None, :] <= order[:, None]).astype(float)
        V = V * qmask[:, None, :]
        G = np.einsum("bni,bnj->bij", V, V) + 1e-12 * np.eye(P)
        rhs = np.einsum("bni,bn->bi", V, y_veh)
        coeffs = np.linalg.solve(G, rhs[..., None])[..., 0] * qmask

        cte = coeffs[:, 0]
        etheta = (th - yaws[:, 0] + np.pi) % (2.0 * np.pi) - np.pi
        hx, hy = np.cos(yaws[:, 0]), np.sin(yaws[:, 0])
        lag = dx[:, 0] * hx + dy[:, 0] * hy

        v_ref = np.clip(speeds + self.catchup_gain * lag[:, None], 0.0,
                        self.planner_cfg.max_speed)
        feedback_v = np.asarray(feedback_v, float)
        # one packed upload: z0 (6), coefficients (P), the setpoint
        # profile (N x 3), the poses of the blob transform (3)
        pack = np.zeros((B, 6 + P + 3 * N + 3))
        pack[:, 3] = feedback_v
        pack[:, 4] = cte
        pack[:, 5] = etheta
        pack[:, 6:6 + P] = coeffs
        pack[:, 6 + P + 2:6 + P + 3 * N:3] = v_ref
        pack[:, 6 + P + 3 * N:] = poses[:, :3]
        up = upload(pack, self.dtype, self.device)
        refs = up[:, 6 + P:6 + P + 3 * N].reshape(B, N, 3)

        u_init = None
        if self._warm_us is not None:
            # the bank stays on the device (the last solve's controls,
            # never fetched), shifted there
            w = self._warm_us.to(self.dtype)
            u_init = torch.cat([w[:, 1:], w[:, -1:]], dim=1)
        if cfg.model in ("diff_drive", "bicycle"):
            _solve = batch_solve_lane
        else:
            from ..engine.batch import batch_solve as _solve
        blobs = None
        if self._world_dev is not None:
            blobs = _blobs_to_frames(self._world_dev,
                                     up[:, 6 + P + 3 * N:], self.dtype)
        res = _solve(up[:, :6], up[:, 6:6 + P], self.params, cfg,
                     u_init=u_init, refs=refs, blobs=blobs)
        self._warm_us = res.us            # stays on the device
        dt_ = res.us.dtype
        tile = [res.us[:, 0, :]]
        want = self._want_obs()
        if want:
            tile += [res.cost[:, None], res.converged[:, None].to(dt_),
                     res.n_iters[:, None].to(dt_)]
        (got,) = fetch(torch.cat(tile, dim=1))
        got = np.asarray(got, float)
        u0 = got[:, :2]
        self.last_obs = (np.stack([cte, etheta, v_ref[:, 0], got[:, 2],
                                   got[:, 3], got[:, 4]])
                         if want else None)
        v_cmd = np.clip(feedback_v + u0[:, 1] * dt, 0.0,
                        self.planner_cfg.max_speed)
        return np.stack([v_cmd, u0[:, 0]], -1), lag

    def _compute_device(self, t_now: float, poses: np.ndarray,
                        feedback_v: np.ndarray):
        """The device cycle (`_traj_cycle`): one packed upload of the
        world state and [t_now, dt], one fetch."""
        B = self.B
        cfg = self.solver_cfg
        pack = np.empty(4 * B + 2, np.float32)
        world = pack[:4 * B].reshape(B, 4)
        world[:, :3] = poses
        world[:, 3] = feedback_v
        pack[4 * B:] = (t_now, self._dt_max)
        up = upload(pack, torch.float32, self.device)
        if self._warm_us is None:
            self._warm_us = torch.zeros((B, cfg.n_controls, 2),
                                        dtype=self.dtype, device=self.device)
        blob_leaves = ()
        if self._world_dev is not None:
            ob = self._world_dev
            blob_leaves = (ob.cx, ob.cy, ob.gamma, ob.w)
        world, tnow = up[:4 * B].reshape(B, 4), up[4 * B:]
        knobs = (cfg, float(self.planner_cfg.max_speed), self.catchup_gain,
                 float(max(self.planner_cfg.local_plan_length, 1e-6)),
                 self.dtype)
        if self.mesh is None:
            warm, out, obs = _traj_cycle(
                *knobs, self._dev_consts, self._warm_us, world, tnow,
                self.params, *blob_leaves)
        else:
            from ..parallel.sharded import gather_rows, split_rows

            mesh = self.mesh
            if isinstance(self._warm_us, torch.Tensor):
                self._warm_us = split_rows(mesh, self._warm_us, B)
            parts = []
            for i, (k, w, wd, pp, *bl) in enumerate(zip(
                    self._dev_consts, self._warm_us,
                    split_rows(mesh, world, B),
                    split_rows(mesh, self.params, B),
                    *(split_rows(mesh, a, B) for a in blob_leaves))):
                with mesh.on(i):
                    parts.append(_traj_cycle(
                        *knobs, k, w, wd, tnow.to(wd.device), pp, *bl))
            warm = [q[0] for q in parts]
            out = gather_rows([q[1] for q in parts], 1, self.device)
            obs = gather_rows([q[2] for q in parts], 1, self.device)
        self._warm_us = warm
        if self._want_obs():
            o, obs_h = fetch(out, obs)
            self.last_obs = np.asarray(obs_h, float)
        else:
            (o,) = fetch(out)
            self.last_obs = None
        o = np.asarray(o, float)
        return np.stack([o[0], o[1]], -1), o[2]
