"""Tracking controller: error-state extraction and one NMPC solve per cycle
(counterpart of `mpc_ros_tpu/planner/tracking.py`).

Per cycle, on the host in float64 numpy: the reference-speed schedule
(deceleration near the goal, optionally the curvature cap), the world ->
robot transform of the downsampled plan, the cubic fit, cte = f(0), the
heading error by the 30% lookahead with the reference's 0 -> 2 pi shim
(wrapped to [-pi, pi] unless `wrap_etheta=False`), and the optional
one-step delay prediction. Then one solve on the device with the JAX
package's transfer diet: one packed upload of (6 + C + 1,) — state,
coefficients, the scheduled ref_vel — the previous optimum kept on the
device as the warm carry and shifted there, and one packed fetch of us,
zs, cost, converged, iterations, grad and reg. No parameter leaf is read
back per cycle: the host math reads the numpy twin of the parameters
(`_host_twin`).

The solve is the counterpart of JAX's `_cycle_jit`: a `CapturedSolve`
(`solver/graphed.py`, built by `captured_cycle`) per signature (which of
blobs and costmap are present, and the leaves' shapes), on the card three
CUDA graphs replayed each cycle, its packed input staged through pinned
memory, the warm carry a device buffer written in place (`reset` zeroes
it: a zero carry is the cold start), the parameter, blob and costmap
leaves copied into the captured buffers when they change, so that
`update_params` (in place) and a new costmap of the same shape need no
recapture. On the CPU the same bodies run eagerly. The private
`_graphed = False` runs the eager `_cycle` instead, for comparison.

The path fit runs in the native C++ core (`native.plan_fit`: the
transform, a Householder-QR fit, cte and the lookahead heading; the same
source as the JAX package's) unless `_native_prep` is set False, which
takes the numpy fit (`np.polyfit`). One difference from the JAX package
is deliberate: where it switches to numpy on a build or ABI failure, the
port raises, since a silent switch would hide a broken build.

The controller runs on the card unless the caller passes `device="cpu"`;
without a card it raises (`resolve_device`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..config import MPCParams, PlannerConfig, SolverConfig
from ..models.base import get_model
from ..solver import graphed, ilqr
from ..solver.types import SolveResult
from .fsm import normalize_angle
from .plan_utils import lookahead_heading


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card (`cuda`) unless the
    caller names another; asking for the card without one raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: this entry point runs on the card; pass "
            "device='cpu' (or --cpu) to run it on the CPU")
    return dev


def _host_twin(params: MPCParams, dtype) -> MPCParams:
    """Float64 numpy leaves of `params` rounded through `dtype`, the values
    the device leaves hold, for the per-cycle host math."""
    return MPCParams(**{k: np.asarray(v, float) for k, v in
                        params.astype(dtype).to_numpy().items()})


def unpack_cycle(flat: np.ndarray, cfg: SolverConfig) -> SolveResult:
    """The solve result (numpy leaves) from a cycle's packed fetch."""
    T, N = cfg.n_controls, cfg.n_steps
    us = flat[: T * 2].reshape(T, 2)
    zs = flat[T * 2: T * 2 + N * 6].reshape(N, 6)
    cost, convf, itersf, gnorm, reg = flat[T * 2 + N * 6:]
    return SolveResult(us=us, zs=zs, cost=cost, converged=bool(convf > 0.5),
                       n_iters=int(itersf), grad_norm=gnorm, reg=reg)


def pack_result(r: SolveResult) -> torch.Tensor:
    """Every observability output of a single solve in one flat tensor:
    us, zs, then cost, converged, iterations, grad and reg."""
    dtype = r.us.dtype
    return torch.cat([
        r.us.reshape(-1), r.zs.reshape(-1),
        torch.stack([r.cost, r.converged.to(dtype), r.n_iters.to(dtype),
                     r.grad_norm, r.reg])])


def _unpack_tracking(cfg: SolverConfig):
    """The tracking cycle's packed input: inp (6 + C + 1,) = state,
    coefficients and ref_vel -> (z0, coeffs, p, refs)."""
    nc = cfg.n_coeffs

    def unpack(inp, p):
        return (inp[:6], inp[6: 6 + nc],
                dataclasses.replace(p, ref_vel=inp[6 + nc]), None)

    return unpack


def _shifted(prev_us: torch.Tensor) -> torch.Tensor:
    """The warm start: the previous optimum shifted by one knot, its last
    control held (a zero carry is the cold start: the warm start clips to
    the same zeros)."""
    return torch.cat([prev_us[1:], prev_us[-1:]])


def _cycle(cfg: SolverConfig, inp: torch.Tensor, prev_us: torch.Tensor,
           p: MPCParams, blobs=None, omap=None, unpack=None):
    """One single-robot solve on the device, eagerly: the packed input as
    `unpack` reads it (by default the tracking cycle's), the warm start
    shifted from the previous optimum; `blobs` and `omap` are the
    robot-frame obstacles. Returns (the packed result, the new carry)."""
    z0, coeffs, p, refs = (unpack or _unpack_tracking(cfg))(inp, p)
    r = ilqr.solve(z0, coeffs, p, cfg, u_init=_shifted(prev_us), omap=omap,
                   blobs=blobs, refs=refs)
    return pack_result(r), r.us


def captured_cycle(cfg: SolverConfig, carry: torch.Tensor, params,
                   blobs, omap, n_inp: int,
                   unpack) -> graphed.CapturedSolve:
    """A single-robot cycle as a `CapturedSolve`: the static packed input
    "inp" (n_inp,), the warm carry (the caller's (T, 2) tensor: shifted by
    one knot into the warm start, overwritten with the new optimum in
    place), and buffers for the leaves of `params`, `blobs` and `omap`
    (None: absent); `unpack(inp, p) -> (z0, coeffs, p, refs)`. Its one
    output, "flat", is the packed result (`pack_result`)."""
    dtype, dev = carry.dtype, carry.device
    inputs = {"inp": torch.empty((n_inp,), dtype=dtype, device=dev),
              "carry": carry}
    for prefix, obj in (("p", params), ("blobs", blobs), ("omap", omap)):
        if obj is not None:
            inputs.update(graphed.leaf_buffers(prefix, obj, dtype, dev))

    def prologue(b):
        z0, coeffs, p, refs = unpack(b["inp"], graphed.rebuild("p", params,
                                                               b))
        return ilqr.prepare(z0, coeffs, p, cfg, u_init=_shifted(b["carry"]),
                            omap=graphed.rebuild("omap", omap, b),
                            blobs=graphed.rebuild("blobs", blobs, b),
                            refs=refs)

    def epilogue(b, prob, st):
        r = ilqr.result(prob, st)
        b["carry"].copy_(r.us)
        return {"flat": pack_result(r)}

    return graphed.CapturedSolve(cfg, dev, inputs, prologue, epilogue)


def run_captured(entries: dict, cfg: SolverConfig, carry: torch.Tensor,
                 inp: np.ndarray, params, blobs, omap,
                 unpack) -> np.ndarray:
    """One cycle through the `CapturedSolve` of its signature in `entries`
    (made on first use): the packed input, the changed leaves loaded, the
    solve, the packed result fetched to the host."""
    key = (cfg, graphed.leaf_signature(params),
           graphed.leaf_signature(blobs), graphed.leaf_signature(omap))
    entry = entries.get(key)
    if entry is None:
        entry = entries[key] = captured_cycle(cfg, carry, params, blobs,
                                              omap, len(inp), unpack)
    entry.load("inp", inp)
    for prefix, obj in (("p", params), ("blobs", blobs), ("omap", omap)):
        if obj is not None:
            entry.load_leaves(prefix, obj)
    return entry.fetch("flat", entry.run()["flat"])


@dataclasses.dataclass
class TrackingDebug:
    """Per-cycle observability record."""

    coeffs: np.ndarray
    state: np.ndarray
    ref_vel: float
    solve: Optional[SolveResult]
    cost: float


class TrackingController:
    """Owns the solver parameters (on the device, with their numpy twin)
    and the cross-cycle actuation state (w, speed, throttle)."""

    def __init__(self, params: MPCParams, solver_cfg: SolverConfig,
                 planner_cfg: PlannerConfig, dtype=torch.float64,
                 device=None):
        self.device = resolve_device(device)
        self.dtype = dtype
        self.solver_cfg = solver_cfg
        self.planner_cfg = planner_cfg
        # the family's yaw_rate maps (v, first control) to the heading rate
        # of the delay-mode prediction
        self.model = get_model(solver_cfg.model)
        self.params = None
        self.update_params(params)
        self.w = 0.0
        self.speed = 0.0
        self.throttle = 1.0
        self._warm_us: Optional[np.ndarray] = None
        # the previous optimum, kept on the device between cycles and
        # written in place (zeros: the cold start)
        self._warm_dev = torch.zeros((solver_cfg.n_controls, 2),
                                     dtype=dtype, device=self.device)
        # the captured solves, one per signature (`run_captured`); False
        # runs the eager `_cycle` (a comparison the tests and the smoke
        # make; nothing on the main path sets it)
        self._captured: dict = {}
        self._graphed = True
        # robot-frame GaussianObstacles (leaves (K,)), set per cycle by
        # the embedder (MPCPlanner)
        self.obstacles = None
        # the robot-frame local costmap (`obstacle_map`), on the device
        self._omap = None
        self._omap_src = None
        # the native C++ path fit (False: the numpy fit)
        self._native_prep = True

    def reset(self) -> None:
        self.w = 0.0
        self.speed = 0.0
        self.throttle = 1.0
        self.ref_vel = float(self._np_params.ref_vel)
        self._warm_us = None
        self._warm_dev.zero_()

    @property
    def obstacle_map(self):
        """The robot-frame local costmap (`ObstacleMap`) every cycle's
        solve samples, or None."""
        return self._omap

    @obstacle_map.setter
    def obstacle_map(self, omap) -> None:
        # moved to the controller's device and dtype (and spline_coeff
        # planes derived) once per map update; the same map set again is
        # not copied again
        if omap is not self._omap_src:
            self._omap_src = omap
            self._omap = (None if omap is None
                          else omap.for_solver(self.dtype, self.device))

    def update_params(self, params: MPCParams) -> None:
        """Hot-reload the solver parameters: the new values copied into the
        device leaves in place (a leaf whose shape changes is replaced, a
        new signature for the captured solve) and a new numpy twin,
        nothing rebuilt."""
        new = params.astype(self.dtype, self.device)
        if self.params is None:
            # leaves of our own: a reload writes them in place
            self.params = MPCParams(**{
                f.name: getattr(new, f.name).clone()
                for f in dataclasses.fields(new)})
        else:
            kept = {}
            for f in dataclasses.fields(new):
                old, v = getattr(self.params, f.name), getattr(new, f.name)
                if old.shape == v.shape:
                    old.copy_(v)
                    kept[f.name] = old
                else:
                    kept[f.name] = v.clone()
            self.params = MPCParams(**kept)
        self._np_params = _host_twin(params, self.dtype)
        self.ref_vel = float(self._np_params.ref_vel)

    def scheduled_ref_vel(self, pose: np.ndarray, goal: np.ndarray,
                          v: float) -> float:
        """Deceleration scheduling: inside the braking distance
        v^2 / max_throttle the reference speed scales with the distance to
        the goal, clamped to [min_speed, max_speed]."""
        dist = float(np.hypot(pose[0] - goal[0], pose[1] - goal[1]))
        max_thr = float(self._np_params.max_throttle)
        if dist <= v * v / max_thr:
            return float(np.clip(max_thr * dist,
                                 self.planner_cfg.min_speed,
                                 self.planner_cfg.max_speed))
        return self.ref_vel

    def curvature_speed_limit(self, ref_plan: np.ndarray) -> float:
        """v <= sqrt(max_lat_accel / kappa_max) over the local window (inf
        on a straight window)."""
        if len(ref_plan) < 3:
            return float("inf")
        d = np.diff(ref_plan[:, :2], axis=0)
        ds = np.hypot(d[:, 0], d[:, 1])
        keep = ds > 1e-9
        if keep.sum() < 2:
            return float("inf")
        h = np.arctan2(d[keep, 1], d[keep, 0])
        dsk = ds[keep]
        dh = (np.diff(h) + np.pi) % (2.0 * np.pi) - np.pi
        seg = np.maximum(0.5 * (dsk[1:] + dsk[:-1]), 1e-6)
        kappa = float(np.max(np.abs(dh) / seg))
        if kappa <= 1e-9:
            return float("inf")
        return float(np.sqrt(self.planner_cfg.max_lat_accel / kappa))

    def compute(self, pose: np.ndarray, goal: np.ndarray,
                feedback_v: float, ref_plan: np.ndarray,
                raw_plan: Optional[np.ndarray] = None):
        """One Tracking cycle. pose: (x, y, yaw); ref_plan: (M, >=2) world
        waypoints (downsampled); `raw_plan`: the window before downsampling
        (the curvature cap measures it). Returns ((v_cmd, w_cmd),
        TrackingDebug)."""
        if len(ref_plan) == 0:
            # no reference: hold the previous command, flag no solve
            return (self.speed, self.w), TrackingDebug(
                coeffs=np.zeros(self.solver_cfg.n_coeffs),
                state=np.zeros(6), ref_vel=self.ref_vel, solve=None,
                cost=float("nan"))

        px, py, theta = float(pose[0]), float(pose[1]), float(pose[2])
        v = float(feedback_v)
        dt = float(self._np_params.dt)
        pcfg = self.planner_cfg

        ref_vel_eff = self.scheduled_ref_vel(pose, goal, v)
        if pcfg.curvature_slowdown:
            kplan = ref_plan if raw_plan is None else raw_plan
            ref_vel_eff = float(np.clip(
                min(ref_vel_eff, self.curvature_speed_limit(kplan)),
                pcfg.min_speed, pcfg.max_speed))

        # world -> robot frame and the cubic fit (the degree drops with
        # the number of waypoints): the native core, or numpy where it
        # returns None (a degenerate fit) or `_native_prep` is False
        order = min(self.solver_cfg.poly_order, len(ref_plan) - 1)
        fit = None
        if self._native_prep:
            from ..native.runtime import plan_fit

            fit = plan_fit(ref_plan[:, :2], (px, py, theta), order)
        coeffs = np.zeros(self.solver_cfg.n_coeffs)
        if fit is not None:
            c, cte, traj_deg, valid = fit
            coeffs[: len(c)] = c
        else:
            ct, st = np.cos(theta), np.sin(theta)
            dx = ref_plan[:, 0] - px
            dy = ref_plan[:, 1] - py
            x_veh = dx * ct + dy * st
            y_veh = dy * ct - dx * st
            c = np.polyfit(x_veh, y_veh, order)[::-1]
            coeffs[: len(c)] = c
            cte = float(np.polyval(coeffs[::-1], 0.0))
            # the 30% lookahead path direction
            traj_deg, valid = lookahead_heading(ref_plan)
        # the 0 -> 2 pi shim
        temp_theta = theta
        if temp_theta <= -np.pi + traj_deg:
            temp_theta += 2.0 * np.pi
        if valid and (temp_theta - traj_deg) < 1.8 * np.pi:
            etheta = temp_theta - traj_deg
        else:
            etheta = 0.0
        if pcfg.wrap_etheta:
            etheta = normalize_angle(etheta)

        # one-step delay prediction; w holds the previous first control,
        # which the family maps to a heading rate (on the numpy twin)
        if pcfg.delay_mode:
            sign = self.solver_cfg.cte_vsin_sign
            theta_act = float(
                self.model.yaw_rate(v, self.w, self._np_params)) * dt
            state = np.array([v * dt, 0.0, theta_act,
                              v + self.throttle * dt,
                              cte + sign * v * np.sin(etheta) * dt,
                              etheta - sign * theta_act])
        else:
            state = np.array([0.0, 0.0, 0.0, v, cte, etheta])

        cfg = self.solver_cfg
        inp = np.concatenate([state, coeffs, [ref_vel_eff]])
        if self._graphed and graphed.capturable(cfg):
            flat = run_captured(self._captured, cfg, self._warm_dev, inp,
                                self.params, self.obstacles, self._omap,
                                _unpack_tracking(cfg))
        else:
            flat_t, us = _cycle(
                cfg, torch.tensor(inp, dtype=self.dtype, device=self.device),
                self._warm_dev, self.params, self.obstacles, self._omap)
            self._warm_dev.copy_(us)
            flat = flat_t.cpu().numpy()
        res = unpack_cycle(flat.astype(float), cfg)
        self._warm_us = res.us

        self.w = float(res.us[0, 0])
        self.throttle = float(res.us[0, 1])
        self.speed = min(v + self.throttle * dt, ref_vel_eff)
        dbg = TrackingDebug(coeffs=coeffs, state=state, ref_vel=ref_vel_eff,
                            solve=res, cost=float(res.cost))
        return (self.speed, self.w), dbg
