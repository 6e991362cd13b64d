"""Fleet serving: the planner lifecycle for B robots with one batched solve
per cycle (counterpart of `mpc_ros_tpu/planner/fleet.py`).

A `FleetPlanner` owns B robots' plans, goal latches and FSM states. Each
cycle runs the whole path pipeline (cutoff, window, downsample,
robot-frame transform, polynomial fit, error-state extraction, speed
scheduling, delay-mode prediction) vectorized in numpy over padded plan
buffers, then dispatches one batched, warm-started `batch_solve_lane` for
the whole fleet. On the card, in float32 with B % 128 == 0, that solve is
one launch of the whole-solve kernel (K1) for every robot; the robots not
tracking ride the same launch as benign zero problems.

Semantics match `MPCPlanner` robot by robot: the stages are the JAX
package's vectorized transcriptions of the scalar pipeline, with the same
masking rules, kept in numpy here. The transfers follow the JAX package's
rules, with the card's own costs in mind: the parameters have a numpy twin
for the host math, the per-cycle host arrays go up as one packed tensor
(staged through pinned memory, so the copy does not synchronize the
stream), the warm-start bank stays on the device between cycles, and the
results come back in one fetch. `begin_cycle` reads nothing from the
device, so a serving loop can overlap the next cycle's host pipeline with
the solve in flight.

The planner runs on the card unless built with `device="cpu"`; without a
card it raises. Grid costmaps (`set_costmaps`) are fitted to blobs on the
device. With a device mesh (`mesh=`, `parallel.make_mesh`) the cycle's
solve is split over the mesh's data axis (`parallel.sharded_batch_solve`:
one K1 launch per shard on the card).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from ..config import MPCParams, PlannerConfig, SolverConfig
from ..models.base import get_model
from ..models.obstacles import (GaussianObstacles, ObstacleMap,
                                fit_gaussians_to_maps)
from ..solver.batch_lane import batch_solve_lane
from .fsm import DrivingState
from .tracking import _host_twin, resolve_device

# integer FSM codes for the vectorized bookkeeping
_TRACK, _ROT_PRE, _ROT_GOAL, _IDLE = range(4)

_STATE_OF = {
    _TRACK: DrivingState.TRACKING,
    _ROT_PRE: DrivingState.ROTATE_BEFORE_TRACKING,
    _ROT_GOAL: DrivingState.STOP_AND_ROTATE,
    _IDLE: DrivingState.REACHED_AND_IDLE,
}
_CODE_OF = {v: k for k, v in _STATE_OF.items()}


def _wrap(a):
    return (a + np.pi) % (2.0 * np.pi) - np.pi


def _shift_warm_impl(w: torch.Tensor, has: torch.Tensor) -> torch.Tensor:
    """The warm-start bank moved one knot on (the last knot repeated),
    zero for the robots without a warm start; on the bank's device."""
    shifted = torch.cat([w[:, 1:], w[:, -1:]], dim=1)
    return torch.where(has[:, None, None], shifted, 0.0)


def numpy_dtype(dtype: torch.dtype) -> np.dtype:
    return torch.empty(0, dtype=dtype).numpy().dtype


def upload(a, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """One host-to-device copy of a numpy array as `dtype`. The cast is
    made on the host (numpy rounds to nearest, as a device cast does); on
    the card the copy is staged through pinned memory and does not
    synchronize the stream (a pageable copy would)."""
    t = torch.from_numpy(np.array(a, dtype=numpy_dtype(dtype)))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def fetch(*tensors: torch.Tensor) -> list:
    """Device tensors as numpy arrays with one synchronization: on the card
    each is copied into pinned memory without blocking, then the stream
    is synchronized once."""
    if not tensors[0].is_cuda:
        return [t.detach().clone().numpy() for t in tensors]
    outs = [t.detach().to("cpu", non_blocking=True) for t in tensors]
    torch.cuda.current_stream(tensors[0].device).synchronize()
    return [o.numpy() for o in outs]


@dataclasses.dataclass
class FleetCycleInfo:
    """Per-cycle fleet observability record.

    On the device planner's lean cycles (`DeviceFleetPlanner` with
    `obs_every != 1`: commands only on the wire) every row but `cmds` is a
    placeholder: `states` is -1, the float rows are NaN, `converged` and
    `n_iters` zeros. Gate any aggregation on `observed`."""

    states: np.ndarray           # (B,) int FSM codes; -1 = not fetched
    cmds: np.ndarray             # (B, 2) applied (v, u0) commands
    ref_vel: np.ndarray          # (B,) scheduled reference speeds
    cte: np.ndarray              # (B,) extracted cross-track errors
    etheta: np.ndarray           # (B,) extracted heading errors
    cost: np.ndarray             # (B,) solve costs (nan off-track)
    converged: np.ndarray        # (B,) solve convergence (False off-track)
    n_iters: np.ndarray          # (B,) SQP iterations

    @property
    def observed(self) -> np.ndarray:
        """(B,) bool: True where the observability rows were fetched this
        cycle (False on lean device cycles)."""
        return self.states >= 0

    def state_enum(self, i: int) -> DrivingState:
        return _STATE_OF[int(self.states[i])]


class FleetPlanner:
    """B-robot planner with `MPCPlanner` semantics and one batched solve.

    Usage:
        fp = FleetPlanner(params, solver_cfg, planner_cfg)
        fp.initialize(n_robots)
        fp.set_plans(plans, poses)                  # list of (M_i, 3) arrays
        ok, cmds, info = fp.compute_velocity_commands(poses, feedback)
        done = fp.is_goal_reached(poses, feedback)  # (B,) bool

    Commands are (v, omega) for diff_drive and (v, delta) for the bicycle
    family (`SolverConfig.model`, shared by the fleet; numeric parameters
    such as the wheelbase may vary per robot as (B,) MPCParams leaves).
    """

    def __init__(self, params: MPCParams = MPCParams(),
                 solver_cfg: SolverConfig = SolverConfig(),
                 planner_cfg: PlannerConfig = PlannerConfig(),
                 dtype=torch.float32, mesh=None, device=None):
        """`mesh`: an optional `parallel.Mesh`; the per-cycle solve splits
        the robot batch over its data axis, B / n_data robots per shard
        (B divisible by n_data). The planner's own tensors stay on
        `device`."""
        self.device = resolve_device(device)
        self.mesh = mesh
        self.dtype = dtype
        self.solver_cfg = solver_cfg
        self.planner_cfg = planner_cfg
        self.model = get_model(solver_cfg.model)
        self._initialized = False
        self.world_obstacles = None
        self._world_dev = None
        self.reconfigure(params)

    def _refresh_host_params(self) -> None:
        # the numpy twin of the device leaves: the host stages read it, so
        # no cycle reads a parameter back from the device
        self._np_params = _host_twin(self.params, self.dtype)

    def reconfigure(self, params: MPCParams) -> None:
        """Hot-reload the numeric parameters (new device leaves and a new
        numpy twin, nothing rebuilt)."""
        self.params = params.astype(self.dtype, self.device)
        self._refresh_host_params()

    def _leaf(self, name: str, idx) -> np.ndarray:
        """Host value of a params leaf for the robot subset `idx`:
        per-robot (B,) leaves index through, scalars broadcast."""
        a = getattr(self._np_params, name)
        return np.broadcast_to(a[idx] if a.ndim else a, np.shape(idx))

    # -- lifecycle -----------------------------------------------------------

    def initialize(self, n_robots: int) -> None:
        B = int(n_robots)
        self.B = B
        self.plans: list[Optional[np.ndarray]] = [None] * B
        # padded plan buffers: xy padded +inf (the distance math
        # saturates), per-robot [start, length) cursors; arclength and
        # per-knot curvature are static per plan
        self._buf = np.full((B, 1, 3), np.inf)
        self._buf[..., 2] = 0.0
        self._len = np.zeros(B, np.int64)
        self._start = np.zeros(B, np.int64)
        self._arc = np.full((B, 1), np.inf)
        self._kappa = np.zeros((B, 1))
        self._span = np.zeros((B, 1), np.int64)
        self.states = np.full(B, _IDLE, np.int64)
        self.latch_xy = np.zeros(B, bool)
        self.latch_yaw = np.zeros(B, bool)
        self.set_new_goal = np.zeros(B, bool)
        T = self.solver_cfg.n_controls
        # the warm-start bank: host numpy until the first solve, then the
        # last solve's controls on the device
        self._warm = np.zeros((B, T, 2))
        self._has_warm = np.zeros(B, bool)
        # cross-cycle actuation state (TrackingController analogs)
        self.speed = np.zeros(B)
        self.w = np.zeros(B)
        self.throttle = np.ones(B)
        self._initialized = True

    def set_obstacles(self, blobs) -> None:
        """World-frame per-robot parametric obstacles (a
        `GaussianObstacles` with leaves (B, K); numpy or tensors), moved
        to the device once here. None clears."""
        self.world_obstacles = blobs
        self._world_dev = None if blobs is None else GaussianObstacles(*(
            torch.as_tensor(getattr(blobs, f), dtype=self.dtype,
                            device=self.device)
            for f in ("cx", "cy", "gamma", "w")))

    def set_costmaps(self, omaps, n_blobs: int = 4) -> None:
        """World-frame per-robot costmap snapshots fitted to blobs: the
        production costmap route. `omaps` is an `ObstacleMap` with leaves
        (B, ...) (grid (B, H, W), origin (B, 2) in world coordinates,
        resolution and weight (B,)), numpy or tensors, or None to clear.
        Host leaves go up in one pinned non-blocking copy; the greedy fit
        (`fit_gaussians_to_maps`) runs on the planner's device, and every
        cycle then solves with the blobs (on the card, K1's blob
        variant)."""
        if omaps is None:
            self.set_obstacles(None)
            return
        self.set_obstacles(fit_gaussians_to_maps(self._upload_maps(omaps),
                                                 n_blobs))

    def _upload_maps(self, omaps) -> ObstacleMap:
        """A batch of maps on the planner's device in its dtype: leaves
        already there are cast there; host leaves are packed into one
        (B, H*W + 4) array and copied once."""
        grid = omaps.grid
        if isinstance(grid, torch.Tensor) and grid.device == self.device:
            return omaps.to(self.dtype)
        nd = numpy_dtype(self.dtype)

        def host(a):
            a = a.cpu() if isinstance(a, torch.Tensor) else a
            return np.asarray(a, nd).reshape(B, -1)

        B, H, W = np.shape(grid)
        g = host(grid)

        # packed in the upload's dtype (the cast made once, on the host)
        flat = upload(np.concatenate(
            [g, host(omaps.origin), host(omaps.resolution),
             host(omaps.weight)], axis=1), self.dtype, self.device)
        return ObstacleMap(grid=flat[:, :H * W].reshape(B, H, W),
                           origin=flat[:, H * W:H * W + 2],
                           resolution=flat[:, H * W + 2],
                           weight=flat[:, H * W + 3],
                           sampling=omaps.sampling)

    def set_plans(self, plans: Sequence[np.ndarray],
                  poses: np.ndarray) -> np.ndarray:
        """Install per-robot global plans. plans[i]: (M_i, 3) world
        waypoints (x, y, yaw), or None to keep robot i's plan; poses
        (B, 3). Returns (B,) accept flags. 2-column plans get tangent
        headings synthesized."""
        assert self._initialized
        poses = np.asarray(poses, float)
        B = self.B
        ok = np.zeros(B, bool)
        norm: list[Optional[np.ndarray]] = list(self.plans)  # carry-over
        for i, plan in enumerate(plans):
            if plan is None:
                continue                 # keep this robot's existing plan
            plan = np.asarray(plan, float)
            if plan.ndim != 2 or len(plan) == 0:
                continue
            if plan.shape[1] < 3:
                yaw = np.zeros(len(plan))
                if len(plan) >= 2:
                    d = np.diff(plan[:, :2], axis=0)
                    yaw[:-1] = np.arctan2(d[:, 1], d[:, 0])
                    yaw[-1] = yaw[-2]
                plan = np.concatenate([plan[:, :2], yaw[:, None]], axis=1)
            norm[i] = plan
            ok[i] = True
        M = max((len(p) for p in norm if p is not None), default=1)
        old_start = self._start.copy()
        self._buf = np.full((B, M, 3), np.inf)
        self._buf[..., 2] = 0.0
        self._len = np.zeros(B, np.int64)
        self._start = np.zeros(B, np.int64)
        for i, plan in enumerate(norm):
            if plan is None:
                continue
            self.plans[i] = plan
            self._buf[i, :len(plan)] = plan
            self._len[i] = len(plan)
            if not ok[i]:                # carried plan: keep its cursor
                self._start[i] = old_start[i]
        self._recompute_plan_geometry()

        # seeding (the reference's setPlan): latches re-arm, the FSM seeds
        # from position and heading
        self.set_new_goal |= ok
        self._has_warm &= ~ok
        self.speed[ok] = 0.0
        self.w[ok] = 0.0
        self.throttle[ok] = 1.0
        start = self._cutoff(poses)
        pos = self._position_reached(poses, ok)
        below = self._below_heading(poses, start, ok)
        seeded = np.where(pos, _ROT_GOAL,
                          np.where(below, _TRACK, _ROT_PRE))
        self.states = np.where(ok, seeded, self.states)
        return ok

    def _recompute_plan_geometry(self) -> None:
        """The static per-plan geometry of the padded buffer: cumulative
        arclength, per-knot curvature |dheading| / mean segment (padding:
        arc = inf, kappa = 0), the lookahead span and the windowed
        curvature maximum of every knot."""
        B = self.B
        with np.errstate(invalid="ignore"):
            d = np.diff(self._buf[:, :, :2], axis=1)   # inf padding -> nan
            ds = np.hypot(d[:, :, 0], d[:, :, 1])          # (B, M-1)
        ds = np.where(np.isfinite(ds), ds, np.inf)
        self._arc = np.concatenate(
            [np.zeros((B, 1)), np.cumsum(ds, axis=1)], axis=1)
        with np.errstate(invalid="ignore"):
            h = np.arctan2(d[:, :, 1], d[:, :, 0])
            dh = _wrap(np.diff(h, axis=1))
            seg = np.maximum(0.5 * (ds[:, 1:] + ds[:, :-1]), 1e-6)
            kap = np.abs(dh) / seg
        # zero-length segments have no heading: their knots' curvature is
        # dropped
        tiny = (ds[:, 1:] <= 1e-9) | (ds[:, :-1] <= 1e-9)
        kap = np.where(tiny, 0.0, kap)
        self._kappa = np.where(np.isfinite(kap), kap, 0.0)  # (B, M-2)

        # per-knot lookahead span: span[i, t] = the first index j with
        # arc[i, j] > arc[i, t] + L (the pad sentinel clamps it to the
        # length), so the per-cycle window end is a (B,) gather. One flat
        # searchsorted: rows offset by C * i, C above every in-row value
        L = self.planner_cfg.local_plan_length
        M = self._arc.shape[1]
        finite = np.isfinite(self._arc)
        amax = float(self._arc[finite].max()) if finite.any() else 0.0
        C = amax + L + 2.0
        a = np.where(finite, self._arc, amax + L + 1.0)
        base = np.arange(B)[:, None] * C
        flat = (a + base).ravel()
        tgt = (a + L + base).ravel()
        j = np.searchsorted(flat, tgt, side="right")
        self._span = (j - (np.arange(B) * M).repeat(M)).reshape(B, M)

        # windowed curvature max per knot: kmax_win[i, t] = max kappa over
        # [t, end(t) - 2), end(t) being what _window_end returns for
        # start = t; a sparse table, so the per-cycle curvature scheduler
        # is a (B,) gather
        Mk = self._kappa.shape[1]
        if Mk > 0:
            t_idx = np.arange(M)[None, :]
            k_rel = np.maximum(
                np.minimum(self._span, self._len[:, None]) - t_idx, 2)
            e_of_t = np.minimum(t_idx + k_rel,
                                np.maximum(self._len[:, None], t_idx + 1))
            tk = np.arange(Mk)[None, :]
            wlen = np.clip(e_of_t[:, :Mk] - 2 - tk, 0, Mk - tk)
            levels = [self._kappa.astype(np.float32)]
            step = 1
            while 2 * step <= int(wlen.max(initial=1)):
                prev = levels[-1]
                if prev.shape[1] - step <= 0:
                    break
                levels.append(np.maximum(prev[:, : prev.shape[1] - step],
                                         prev[:, step:]))
                step *= 2
            kmax = np.zeros((B, Mk), np.float32)
            pos = wlen >= 1
            lvl = np.zeros(wlen.shape, np.int64)
            lvl[pos] = np.log2(wlen[pos]).astype(np.int64)
            for li, st_arr in enumerate(levels):
                m = pos & (lvl == li)
                if not m.any():
                    continue
                ii, tt = np.nonzero(m)
                off = wlen[m] - (1 << li)
                a1 = st_arr[ii, tt]
                a2 = st_arr[ii, np.minimum(tt + off, st_arr.shape[1] - 1)]
                kmax[ii, tt] = np.maximum(a1, a2)
            self._kmax_win = kmax
        else:
            self._kmax_win = np.zeros((B, 1), np.float32)

    # -- checkpoint / resume -------------------------------------------------

    _STATE_KEYS = ("states", "latch_xy", "latch_yaw", "set_new_goal",
                   "speed", "w", "throttle")

    def state_dict(self) -> dict:
        """The fleet's resumable serving state as numpy arrays (the JAX
        package's keys, so checkpoints cross between the two): plan
        buffers and cursors, FSM states, goal latches, the warm-start bank
        and the cross-cycle actuation state."""
        warm = self._warm
        if isinstance(warm, torch.Tensor):
            warm = fetch(warm)[0]
        sd = {
            "buf": self._buf.copy(), "len": self._len.copy(),
            "start": self._start.copy(),
            "warm": np.asarray(warm, float),
            "has_warm": self._has_warm.copy(),
        }
        for k in self._STATE_KEYS:
            sd[k] = getattr(self, k).copy()
        return sd

    def load_state_dict(self, sd: dict) -> None:
        """Restore `state_dict()` output into an `initialize(B)`-ed planner
        of the same fleet size and SolverConfig shape."""
        assert self._initialized
        buf = np.asarray(sd["buf"], float)
        assert buf.shape[0] == self.B, (buf.shape, self.B)
        self._buf = buf
        self._len = np.asarray(sd["len"], np.int64)
        self._start = np.asarray(sd["start"], np.int64)
        self._warm = np.asarray(sd["warm"], float)
        assert self._warm.shape == (self.B, self.solver_cfg.n_controls, 2)
        self._has_warm = np.asarray(sd["has_warm"], bool)
        for k in self._STATE_KEYS:
            dtype = getattr(self, k).dtype
            setattr(self, k, np.asarray(sd[k]).astype(dtype))
        self._recompute_plan_geometry()
        self.plans = [self._buf[i, :self._len[i]].copy()
                      if self._len[i] else None for i in range(self.B)]

    # -- vectorized pipeline stages (scalar twins in plan_utils/planner) -----

    def _has_plan(self) -> np.ndarray:
        return self._len > 0

    def _goals(self) -> np.ndarray:
        """(B, 3) goal poses (undefined rows where there is no plan)."""
        last = np.maximum(self._len - 1, 0)
        return self._buf[np.arange(self.B), last]

    def _cutoff(self, poses) -> np.ndarray:
        """Advance the start cursors past the walked-off prefix (the first
        distance increase ends the walk; the nearest waypoint is kept).
        Windowed: W knots from the cursor, extended only for rows whose
        distance keeps decreasing through the whole window; the +inf
        padding ends the walk at the plan's end as the full scan would."""
        B, M = self._buf.shape[:2]
        W = min(8, M)
        start = self._start.copy()
        px, py = poses[:, 0], poses[:, 1]
        pending = self._has_plan().copy()
        while pending.any():
            i = np.nonzero(pending)[0]
            j = start[i, None] + np.arange(W)[None, :]
            jc = np.minimum(j, M - 1)
            x = self._buf[i[:, None], jc, 0]
            y = self._buf[i[:, None], jc, 1]
            d2 = (x - px[i, None]) ** 2 + (y - py[i, None]) ** 2
            d2[j >= self._len[i, None]] = np.inf
            inc = d2[:, 1:] > d2[:, :-1]
            has_inc = inc.any(axis=1)
            k = inc.argmax(axis=1)
            end_i = self._len[i] - 1
            start[i] = np.where(has_inc, start[i] + k,
                                np.minimum(start[i] + W - 1, end_i))
            still = ~has_inc & (start[i] < end_i)
            pending[:] = False
            pending[i[still]] = True
        self._start = np.where(self._has_plan(), start, self._start)
        return self._start

    def _window_end(self, start) -> np.ndarray:
        """Vectorized truncate_by_length: the first knot beyond the
        lookahead arclength, at least 2 points, clamped to the plan length
        (a gather of the precomputed span)."""
        k = self._span[np.arange(self.B), start]
        k_rel = np.maximum(np.minimum(k, self._len) - start, 2)
        return np.minimum(start + k_rel, np.maximum(self._len, start + 1))

    def _downsample(self, start, end):
        """Vectorized downsample_plan on the [start, end) window: stride =
        path length / segments / first-segment length; the final waypoint
        is always included. Returns (offsets (B, S), n_tot (B,)), offsets
        into the buffer (clamped; mask with n_tot)."""
        segs = self.planner_cfg.downsample_segments
        b = np.arange(self.B)
        npts = np.maximum(end - start, 1)
        arc_s = self._arc[b, start]
        arc_e = self._arc[b, np.maximum(end - 1, 0)]
        pl = np.maximum(arc_e - arc_s, 0.0)
        first_seg = self._arc[b, np.minimum(start + 1,
                                            self._buf.shape[1] - 1)] - arc_s
        wd = np.where(first_seg > 0.0, first_seg,
                      np.maximum(pl / np.maximum(npts - 1, 1), 1e-9))
        with np.errstate(divide="ignore", invalid="ignore"):
            samp = np.maximum((pl / segs / wd).astype(np.int64), 1)
        n_s = -(-npts // samp)
        need_back = ((npts - 1) % samp) != 0
        n_tot = n_s + need_back
        # windows of <= 2 points pass through unsampled
        short = npts <= 2
        samp = np.where(short, 1, samp)
        n_tot = np.where(short, npts, n_tot)
        S = int(n_tot.max())
        off = np.arange(S)[None, :] * samp[:, None]
        off = np.minimum(off, (npts - 1)[:, None])
        return start[:, None] + off, n_tot

    def _position_reached(self, poses, active) -> np.ndarray:
        """The latched xy tolerance (vector twin of MPCPlanner's)."""
        has = self._has_plan() & active
        g = self._goals()
        within = (np.hypot(poses[:, 0] - g[:, 0], poses[:, 1] - g[:, 1])
                  <= self.planner_cfg.limits.xy_goal_tolerance)
        shortcut = ~self.set_new_goal & self.latch_xy
        upd = has & ~shortcut
        self.set_new_goal[upd] = False
        self.latch_xy[upd] = within[upd]
        return has & (shortcut | within)

    def _orientation_reached(self, poses, feedback, pos) -> np.ndarray:
        """Yaw tolerance and the stopped check (stopped alone for families
        that cannot rotate in place); latches yaw."""
        lim = self.planner_cfg.limits
        g = self._goals()
        angle = _wrap(poses[:, 2] - g[:, 2])
        yaw_ok = (np.abs(angle) <= lim.yaw_goal_tolerance
                  if self.model.can_rotate_in_place
                  else np.ones(self.B, bool))
        stopped = ((np.abs(feedback[:, 0]) <= lim.trans_stopped_vel)
                   & (np.abs(feedback[:, 1]) <= lim.theta_stopped_vel))
        reached = pos & yaw_ok & stopped
        self.latch_yaw[reached] = True
        return reached

    def _below_heading(self, poses, start, active) -> np.ndarray:
        """|yaw - the window's leading heading| <= threshold (True for
        families that cannot rotate in place)."""
        if not self.model.can_rotate_in_place:
            return active.copy()
        head = self._buf[np.arange(self.B), start, 2]
        err = np.abs(_wrap(poses[:, 2] - head))
        return active & (err <= self.planner_cfg.heading_yaw_error_threshold)

    def is_goal_reached(self, poses: np.ndarray,
                        feedback: np.ndarray) -> np.ndarray:
        """(B,) goal flags with the reference's consume-once latch pair."""
        poses = np.asarray(poses, float)
        feedback = np.asarray(feedback, float)
        has = self._has_plan()
        consume = has & self.latch_xy & self.latch_yaw
        self.latch_xy[consume] = False
        self.latch_yaw[consume] = False
        pos = self._position_reached(poses, has & ~consume)
        reached = self._orientation_reached(poses, feedback, pos)
        self.states = np.where(reached, _IDLE, self.states)
        return reached

    # -- the hot path --------------------------------------------------------

    def compute_velocity_commands(self, poses: np.ndarray,
                                  feedback: np.ndarray):
        """One fleet control cycle. poses (B, 3); feedback (B, 2) measured
        (v, yaw_rate). Returns (ok (B,), cmds (B, 2), FleetCycleInfo)."""
        return self.finish_cycle(self.begin_cycle(poses, feedback))

    def begin_cycle(self, poses: np.ndarray, feedback: np.ndarray) -> dict:
        """Pipelined serving, phase 1: the host pipeline and the FSM, then
        the batched solve dispatched without waiting for it (one packed
        upload, no read from the device). Returns the pending cycle's
        handle for `finish_cycle`.

        The only cross-cycle dependency that needs the device's answer is
        the fetched first controls: the warm-start bank feeds the next
        solve on the device, and the host pipeline reads only world inputs
        and cursors. A loop that calls begin(k+1) before finish(k) runs
        cycle k+1's host pipeline while solve k is in flight; its commands
        then lag one period and the delay-mode actuation state (w,
        throttle) is one cycle stale."""
        assert self._initialized
        poses = np.asarray(poses, float)
        feedback = np.asarray(feedback, float)
        B = self.B
        cfg = self.planner_cfg
        cmds = np.zeros((B, 2))
        cte_out = np.full(B, np.nan)
        eth_out = np.full(B, np.nan)
        refv_out = np.full(B, np.nan)

        # 1. plan bookkeeping and the FSM transition (vectorized)
        ok = self._has_plan()
        start = self._cutoff(poses)
        end = self._window_end(start)
        pos = self._position_reached(poses, ok)
        goal_reached = self._orientation_reached(poses, feedback, pos)
        below = self._below_heading(poses, start, ok & ~pos)
        st = self.states
        keep = np.isin(st, (_ROT_PRE, _TRACK))
        new_st = np.where(goal_reached, _IDLE,
                          np.where(pos, _ROT_GOAL,
                                   np.where(below, _TRACK,
                                            np.where(keep, st, _ROT_PRE))))
        self.states = np.where(ok, new_st, self.states)
        track = ok & (self.states == _TRACK) & (end > start)

        # 2. rotation commands (P control; zeros idle or non-rotating)
        if self.model.can_rotate_in_place:
            g = self._goals()
            rg = ok & (self.states == _ROT_GOAL)
            cmds[rg, 1] = cfg.rotate_p_gain * _wrap(g[rg, 2] - poses[rg, 2])
        head = self._buf[np.arange(B), start, 2]
        rp = ok & (self.states == _ROT_PRE)
        cmds[rp, 1] = cfg.rotate_p_gain * _wrap(head[rp] - poses[rp, 2])

        if not track.any():
            return {"ok": ok, "cmds": cmds, "cte": cte_out, "eth": eth_out,
                    "refv": refv_out, "track": track, "res": None,
                    "states": self.states.copy()}

        # 3. the batched fit and error-state extraction of the tracking
        # robots
        idx = np.nonzero(track)[0]
        offs, n_tot = self._downsample(start, end)
        z0s, coeffs, refv = self._batched_prepare(
            idx, poses, feedback, offs[idx], n_tot[idx],
            start[idx], end[idx])
        cte_out[idx] = z0s[:, 4]
        eth_out[idx] = z0s[:, 5]
        refv_out[idx] = refv

        # 4. one batched solve for the whole fleet (fixed batch B; the
        # robots not tracking get benign zero problems), dispatched, not
        # fetched
        res = self._solve_fleet(idx, z0s, coeffs, refv, poses)
        self._warm = res.us                       # the bank stays on device
        self._has_warm[:] = False
        self._has_warm[idx] = True
        return {"ok": ok, "cmds": cmds, "cte": cte_out, "eth": eth_out,
                "refv": refv_out, "track": track, "res": res, "idx": idx,
                "refv_sub": refv, "v_meas": feedback[idx, 0],
                "states": self.states.copy()}

    def finish_cycle(self, h: dict):
        """Pipelined serving, phase 2: one fetch of the first controls and
        the per-robot stats (the bank itself stays on the device), the
        cross-cycle actuation state updated. Returns (ok, cmds, info)."""
        if h["res"] is None:
            info = self._info(h["cmds"], h["cte"], h["eth"], h["refv"],
                              None, h["track"], states=h["states"])
            return h["ok"], h["cmds"], info

        res = h["res"]
        idx = h["idx"]
        cmds = h["cmds"]
        dt_ = res.us.dtype
        (out,) = fetch(torch.cat([
            res.us[:, 0, :], res.cost[:, None],
            res.converged[:, None].to(dt_), res.n_iters[:, None].to(dt_)],
            dim=1))
        out = np.asarray(out, float)
        dt = self._leaf("dt", idx)
        u0 = out[idx, :2]
        self.w[idx] = u0[:, 0]
        self.throttle[idx] = u0[:, 1]
        self.speed[idx] = np.minimum(h["v_meas"] + u0[:, 1] * dt,
                                     h["refv_sub"])
        cmds[idx, 0] = self.speed[idx]
        cmds[idx, 1] = self.w[idx]

        info = self._info(cmds, h["cte"], h["eth"], h["refv"],
                          (out[:, 2], out[:, 3] > 0.5,
                           out[:, 4].astype(np.int32)),
                          h["track"], states=h["states"])
        return h["ok"], cmds, info

    # -- internals -----------------------------------------------------------

    def _batched_prepare(self, idx, poses, feedback, offs, n_tot, start,
                         end):
        """Vectorized robot-frame transform, weighted least-squares fit and
        error-state extraction of the tracking subset `idx`. offs (n, S):
        buffer indices of the downsampled window; n_tot (n,): valid
        counts."""
        cfg = self.planner_cfg
        n = len(idx)
        S = offs.shape[1]
        n_coeffs = self.solver_cfg.n_coeffs
        pts = self._buf[idx[:, None], offs, :2]          # (n, S, 2)
        wts = (np.arange(S)[None, :] < n_tot[:, None]).astype(float)

        th = poses[idx, 2]
        ct, st = np.cos(th), np.sin(th)
        dx = (pts[:, :, 0] - poses[idx, 0, None]) * wts
        dy = (pts[:, :, 1] - poses[idx, 1, None]) * wts
        x_veh = dx * ct[:, None] + dy * st[:, None]
        y_veh = dy * ct[:, None] - dx * st[:, None]

        # weighted normal equations per robot: the single-robot polyfit's
        # least-squares problem; the degree drops with too few points
        coeffs = np.zeros((n, n_coeffs))
        order = np.minimum(self.solver_cfg.poly_order, n_tot - 1)
        for k in np.unique(order):
            sel = order == k
            xs = x_veh[sel]
            V = np.empty((xs.shape[0], S, k + 1))
            V[:, :, 0] = 1.0
            for q in range(1, k + 1):
                V[:, :, q] = V[:, :, q - 1] * xs
            Vw = (V * wts[sel][:, :, None]).transpose(0, 2, 1)
            G = np.matmul(Vw, V)
            G += 1e-12 * np.eye(k + 1)     # rank guard (degenerate windows)
            b = np.matmul(Vw, y_veh[sel][:, :, None])
            coeffs[sel, : k + 1] = np.linalg.solve(G, b)[..., 0]

        cte = coeffs[:, 0]
        # the 30% lookahead path direction, the continuity shim and the
        # heading wrap (the lookahead displacement sum telescopes to
        # pts[ns-1] - pts[0])
        ns = (n_tot * 0.3).astype(np.int64)
        j = np.clip(ns - 1, 0, S - 1)
        gx = np.take_along_axis(pts[:, :, 0], j[:, None], 1)[:, 0] - pts[:, 0, 0]
        gy = np.take_along_axis(pts[:, :, 1], j[:, None], 1)[:, 0] - pts[:, 0, 1]
        valid = (gx != 0.0) & (gy != 0.0) & (ns >= 2)
        traj = np.arctan2(gy, gx)
        temp = th.copy()
        bump = temp <= (-np.pi + traj)
        temp[bump] += 2.0 * np.pi
        use = valid & ((temp - traj) < 1.8 * np.pi)
        etheta = np.where(use, temp - traj, 0.0)
        if cfg.wrap_etheta:
            etheta = _wrap(etheta)

        # reference-speed scheduling: goal deceleration and the curvature
        # cap (per-robot (B,) MPCParams leaves throughout)
        g = self._goals()[idx]
        dist = np.hypot(poses[idx, 0] - g[:, 0], poses[idx, 1] - g[:, 1])
        v = feedback[idx, 0]
        max_thr = self._leaf("max_throttle", idx)
        ref_vel = self._leaf("ref_vel", idx).copy()
        brake = dist <= v * v / max_thr
        ref_vel[brake] = np.clip((max_thr * dist)[brake], cfg.min_speed,
                                 cfg.max_speed)
        if cfg.curvature_slowdown and self._kappa.shape[1] > 0:
            Mk = self._kmax_win.shape[1]
            kmax = self._kmax_win[idx, np.minimum(start, Mk - 1)].astype(
                float)
            with np.errstate(divide="ignore"):
                lim = np.where(kmax > 1e-9,
                               np.sqrt(cfg.max_lat_accel / kmax), np.inf)
            ref_vel = np.clip(np.minimum(ref_vel, lim), cfg.min_speed,
                              cfg.max_speed)

        # the delay-mode one-step prediction (tracking.py's compute)
        dt = self._leaf("dt", idx)
        if cfg.delay_mode:
            sign = self.solver_cfg.cte_vsin_sign
            hp = dataclasses.replace(self._np_params,
                                     lf=self._leaf("lf", idx))
            yaw_rate = np.asarray(
                self.model.yaw_rate(v, self.w[idx], hp), float)
            theta_act = yaw_rate * dt
            z0s = np.stack([
                v * dt,
                np.zeros(n),
                theta_act,
                v + self.throttle[idx] * dt,
                cte + sign * v * np.sin(etheta) * dt,
                etheta - sign * theta_act,
            ], axis=1)
        else:
            z0s = np.stack([np.zeros(n), np.zeros(n), np.zeros(n), v, cte,
                            etheta], axis=1)
        return z0s, coeffs, ref_vel

    def _solve_fleet(self, idx, z0s_sub, coeffs_sub, refv_sub, poses):
        """The full-width batched solve: the tracking robots carry their
        problems, the rest benign zeros (done in O(1) iterations). The
        cycle's host arrays (z0, coefficients, ref_vel, the warm flags and
        the poses of the blob transform) go up as one packed tensor."""
        B = self.B
        P = self.solver_cfg.n_coeffs
        pack = np.zeros((B, 6 + P + 5))
        pack[idx, :6] = z0s_sub
        pack[idx, 6:6 + P] = coeffs_sub
        pack[idx, 6 + P] = refv_sub
        pack[:, 7 + P] = self._has_warm
        pack[:, 8 + P:] = poses
        up = upload(pack, self.dtype, self.device)
        z0s, coeffs = up[:, :6], up[:, 6:6 + P]
        p = dataclasses.replace(self.params, ref_vel=up[:, 6 + P])
        if isinstance(self._warm, np.ndarray):
            # cold start or a restored checkpoint: the bank is still on the
            # host
            self._warm = upload(self._warm, self.dtype, self.device)
        warm = _shift_warm_impl(self._warm.to(self.dtype),
                                up[:, 7 + P] > 0.5)
        blobs = None
        if self._world_dev is not None:
            blobs = _blobs_to_frames(self._world_dev, up[:, 8 + P:],
                                     self.dtype)
        if self.mesh is not None:
            from ..parallel.sharded import sharded_batch_solve

            return sharded_batch_solve(self.mesh, z0s, coeffs, p,
                                       self.solver_cfg, u_init=warm,
                                       blobs=blobs)
        return batch_solve_lane(z0s, coeffs, p, self.solver_cfg,
                                u_init=warm, blobs=blobs)

    def _info(self, cmds, cte, eth, refv, fetched, track, states=None):
        """`fetched`: host (cost, converged, n_iters) arrays or None.
        `states`: the FSM snapshot taken at begin_cycle (pipelined serving
        may have advanced self.states for the next cycle already)."""
        B = self.B
        nan = np.full(B, np.nan)
        false = np.zeros(B, bool)
        zero = np.zeros(B, np.int32)
        if fetched is not None:
            cost_d, conv_d, iters_d = fetched
            cost = np.where(track, np.asarray(cost_d, float), np.nan)
            conv = np.asarray(conv_d, bool) & track
            iters = np.where(track, np.asarray(iters_d, np.int32), 0)
        else:
            cost, conv, iters = nan, false, zero
        if states is None:
            states = self.states.copy()
        return FleetCycleInfo(states=states, cmds=cmds.copy(),
                              ref_vel=refv, cte=cte, etheta=eth, cost=cost,
                              converged=conv, n_iters=iters)


def _blobs_to_frames(blobs, poses, dtype) -> GaussianObstacles:
    """World-frame blobs (leaves (B, K)) in each robot's frame (the batched
    `GaussianObstacles.to_frame`): poses (B, 3) a device tensor; the
    leaves are cast to `dtype` on its device."""
    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=poses.device)

    poses = poses.to(dtype)
    px, py, yaw = poses[:, 0:1], poses[:, 1:2], poses[:, 2:3]
    ct, st = torch.cos(yaw), torch.sin(yaw)
    dx = t(blobs.cx) - px
    dy = t(blobs.cy) - py
    return GaussianObstacles(cx=dx * ct + dy * st, cy=dy * ct - dx * st,
                             gamma=t(blobs.gamma), w=t(blobs.w))
