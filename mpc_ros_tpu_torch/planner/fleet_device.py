"""Device-resident fleet serving: the whole per-cycle pipeline on the
device (counterpart of `mpc_ros_tpu/planner/fleet_device.py`).

`FleetPlanner` runs the plan pipeline in numpy on the host and dispatches
one batched solve. `DeviceFleetPlanner` moves the whole cycle to the
device:

    upload:  poses (B, 3) ++ feedback (B, 2), one (B, 5) tile
    device:  cutoff walk -> lookahead window -> goal latches + FSM ->
             downsample -> robot-frame transform -> batched weighted
             polynomial fit -> cte/etheta extraction -> reference-speed
             scheduling -> delay-mode prediction -> warm-started solve
             (one K1 launch on the card in float32 at B % 128 == 0) ->
             command extraction                       (`_cycle`)
    fetch:   the (2, B) commands, and at the `obs_every` cadence the
             (8, B) observability tile, with one synchronization

The cross-cycle state (plan cursors, FSM codes, goal latches, actuation
state, the warm-start bank) lives on the device as a dict of tensors that
each cycle replaces; the static per-plan geometry (padded plan buffer,
arclength, lookahead spans, windowed curvature maxima) is computed once per
`set_plans` on the host and uploaded then.

Semantics match `FleetPlanner` robot by robot: each stage is a torch
transcription of the numpy stage with the same masking rules. The cutoff
scans the whole plan for the first distance increase from the cursor, and
the fit solves the same weighted normal equations in float32 with the
abscissa scaled by the lookahead length, so the Gram matrix stays
well-conditioned (the coefficients are unscaled exactly). The JAX program
reads cursor-indexed rows by one-hot masked sums (gathers are slow on the
TPU); on the card a row gather reads the same single element, so the
values are equal and the gathers stand in for the sums.

The JAX cycle is one compiled program with a donated carry. Here it runs
as eager torch ops; capturing it as a CUDA graph is ROADMAP Queue 1
item 4b. With a device mesh (`mesh=`) the whole cycle runs per data shard
(the JAX program under `shard_map`): the plan constants and the carry are
kept as one dict per shard on the shard's device, each shard runs `_cycle`
on its B / n_data robots (one K1 launch per shard on the card), and the
commands and observability rows are concatenated in shard order.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import PlannerConfig, SolverConfig
from ..models.base import get_model
from ..models.obstacles import GaussianObstacles
from ..solver.batch_lane import batch_solve_lane
from .fleet import (_IDLE, _ROT_GOAL, _ROT_PRE, _TRACK, FleetCycleInfo,
                    FleetPlanner, _blobs_to_frames, fetch, upload)

_REPLICATED = ("wire_scales",)

_TWO_PI = 2.0 * np.pi


def _twrap(a: torch.Tensor) -> torch.Tensor:
    return (a + np.pi) % _TWO_PI - np.pi


# observability-tile row indices (fetched at the obs_every cadence)
(OB_CTE, OB_ETH, OB_REFV, OB_COST, OB_CONV, OB_ITERS,
 OB_STATE, OB_TRACK) = range(8)


def _chol_solve_small(G: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """Batched SPD solve by a fully unrolled Cholesky: G (B, P, P), rhs
    (B, P) -> (B, P), elementwise ops only. Pivots are clamped at a tiny
    floor so rank-deficient Gram matrices (degenerate windows; zeroed
    reduced-order columns carry only the 1e-12 ridge) stay finite."""
    P = G.shape[-1]
    L = [[None] * P for _ in range(P)]
    for j in range(P):
        s = G[:, j, j]
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        L[j][j] = torch.sqrt(torch.clamp(s, min=1e-30))
        inv_d = 1.0 / L[j][j]
        for i in range(j + 1, P):
            s = G[:, i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = s * inv_d
    y = [None] * P
    for i in range(P):                      # L y = rhs
        s = rhs[:, i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    x = [None] * P
    for i in reversed(range(P)):            # L' x = y
        s = y[i]
        for k in range(i + 1, P):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return torch.stack(x, dim=-1)


_CARRY_KEYS = ("start", "states", "latch_xy", "latch_yaw", "set_new_goal",
               "speed", "w", "throttle", "warm", "has_warm")
_CONST_KEYS = ("buf", "plen", "arc", "span", "kmax", "goals",
               "arc_next", "kmax_pad")


# The 16-bit wire (DeviceFleetPlanner(wire="i16")): fixed-point scales of
# the (x, y, yaw, v, yaw_rate) upload columns. Poses ride as int16 deltas
# against an int32 tick mirror kept identically on the host and the device
# (integer accumulation, bit-exact on both sides); commands return as
# int16 absolute fixed point. Ranges: +-3.27 m / +-0.327 rad / +-3.27 m/s
# per cycle for the deltas (a larger jump triggers a float32 keyframe
# cycle), +-8.19 command units at 2.5e-4 resolution.
_WIRE_SCALES = (1e-4, 1e-4, 1e-5, 1e-4, 1e-4)
_WIRE_CMD_SCALE = 2.5e-4


def _cycle(solver_cfg: SolverConfig, planner_cfg: PlannerConfig, dtype,
           wire: str, consts: dict, carry: dict, world: torch.Tensor, p,
           *blob_leaves):
    """One fleet cycle on the device: (consts, carry, world, p,
    *blob_leaves) -> (carry2, cmds (2, B), obs (8, B)).

    `world` (B, 5): poses (x, y, yaw) ++ feedback (v, yaw_rate), float32.
    wire="i16": world is (B, 5) int16 deltas against the int32 tick mirror
    in the carry; wire="kf" (keyframe): world is float32 and the mirror is
    (re)seeded from it. The float32 decode ticks * scale is one IEEE
    multiply, as on the host mirror. `blob_leaves`: world-frame
    (cx, cy, gamma, w), each (B, K)."""
    cfg = solver_cfg
    pc = planner_cfg
    lim = pc.limits
    model = get_model(cfg.model)
    can_rot = model.can_rotate_in_place
    n_coeffs = cfg.n_coeffs
    sign = cfg.cte_vsin_sign
    L_scale = float(max(pc.local_plan_length, 1e-6))

    wire_ticks = None
    if wire == "i16":
        wire_ticks = carry["wire_ticks"] + world.to(torch.int32)
    elif wire == "kf":
        wire_ticks = torch.round(world / consts["wire_scales"]).to(
            torch.int32)
    if wire_ticks is not None:
        world = wire_ticks.to(torch.float32) * consts["wire_scales"]
    buf = consts["buf"]              # (B, M, 3), xy padded +inf
    plen = consts["plen"]            # (B,) int32
    arc = consts["arc"]              # (B, M), +inf padded
    span = consts["span"]            # (B, M) int32
    Mk = consts["kmax"].shape[1]
    B, M = buf.shape[:2]
    fdt = buf.dtype
    dev = buf.device
    idx = torch.arange(M, device=dev, dtype=torch.int32)
    poses = world[:, :3]
    feedback = world[:, 3:5]
    px, py, pth = poses[:, 0], poses[:, 1], poses[:, 2]
    v_meas = feedback[:, 0]
    has = plen > 0

    # ---- cutoff: the first distance increase from the cursor ends the
    # walk (the +inf padding ends it at the plan's end) ----
    dxp = buf[:, :, 0] - px[:, None]
    dyp = buf[:, :, 1] - py[:, None]
    d2 = dxp * dxp + dyp * dyp
    d2 = torch.where(idx[None] >= plen[:, None], float("inf"), d2)
    d2p = torch.cat([d2, torch.full((B, 1), float("inf"), dtype=fdt,
                                    device=dev)], dim=1)
    inc = (d2p[:, 1:] > d2p[:, :-1]) & (idx[None] >= carry["start"][:, None])
    # the first True (argmax over an integer cast keeps the first maximum)
    first = torch.argmax(inc.to(torch.int32), dim=1).to(torch.int32)
    can_walk = has & (carry["start"] < plen - 1)
    start = torch.where(can_walk, first, carry["start"])
    start_l = start.long()[:, None]

    def at(a, i):
        """a[b, i[b]] for each robot (the row's element at the index)."""
        return a.gather(1, i).squeeze(1)

    # ---- lookahead window end (the precomputed span) ----
    k = at(span, start_l)
    k_rel = torch.clamp(torch.minimum(k, plen) - start, min=2)
    end = torch.minimum(start + k_rel, torch.maximum(plen, start + 1))

    # ---- goal latches and the FSM transition ----
    goals = consts["goals"]          # (B, 3), static per set_plans
    latch_xy = carry["latch_xy"]
    latch_yaw = carry["latch_yaw"]
    sng = carry["set_new_goal"]
    within = (torch.hypot(px - goals[:, 0], py - goals[:, 1])
              <= lim.xy_goal_tolerance)
    shortcut = (~sng) & latch_xy
    upd_m = has & ~shortcut
    sng = torch.where(upd_m, False, sng)
    latch_xy = torch.where(upd_m, within, latch_xy)
    pos = has & (shortcut | within)
    ang = _twrap(pth - goals[:, 2])
    yaw_ok = (torch.abs(ang) <= lim.yaw_goal_tolerance if can_rot
              else torch.ones(B, dtype=torch.bool, device=dev))
    stopped = ((torch.abs(feedback[:, 0]) <= lim.trans_stopped_vel)
               & (torch.abs(feedback[:, 1]) <= lim.theta_stopped_vel))
    reached = pos & yaw_ok & stopped
    latch_yaw = torch.where(reached, True, latch_yaw)
    head = at(buf[:, :, 2], start_l)
    if can_rot:
        below = (has & ~pos) & (torch.abs(_twrap(pth - head))
                                <= pc.heading_yaw_error_threshold)
    else:
        below = has & ~pos
    st = carry["states"]
    keep = (st == _ROT_PRE) | (st == _TRACK)
    new_st = torch.where(
        reached, _IDLE,
        torch.where(pos, _ROT_GOAL,
                    torch.where(below, _TRACK,
                                torch.where(keep, st, _ROT_PRE))))
    states = torch.where(has, new_st, st).to(torch.int32)
    track = has & (states == _TRACK) & (end > start)

    # ---- rotation commands (P control; the states are disjoint) ----
    cmd_w = torch.zeros(B, dtype=fdt, device=dev)
    if can_rot:
        rg = has & (states == _ROT_GOAL)
        cmd_w = torch.where(rg, pc.rotate_p_gain * _twrap(goals[:, 2] - pth),
                            cmd_w)
    rp = has & (states == _ROT_PRE)
    cmd_w = torch.where(rp, pc.rotate_p_gain * _twrap(head - pth), cmd_w)

    # ---- downsample (twin of FleetPlanner._downsample) ----
    npts = torch.clamp(end - start, min=1)
    arc_s = at(arc, start_l)
    arc_e = at(arc, torch.clamp(end - 1, min=0).long()[:, None])
    pl_len = torch.clamp(arc_e - arc_s, min=0.0)
    first_seg = at(consts["arc_next"], start_l) - arc_s
    wd = torch.where(first_seg > 0.0, first_seg,
                     torch.clamp(pl_len / torch.clamp(npts - 1, min=1),
                                 min=1e-9))
    segs = float(pc.downsample_segments)
    ratio = torch.clamp(pl_len / segs / wd, max=1e6)   # int32-safe clamp
    samp = torch.clamp(ratio.to(torch.int32), min=1)
    n_s = (npts + samp - 1) // samp
    need_back = (((npts - 1) % samp) != 0).to(torch.int32)
    n_tot = n_s + need_back
    short = npts <= 2
    samp = torch.where(short, 1, samp)
    n_tot = torch.where(short, npts, n_tot)

    # ---- robot-frame transform and the weighted fit. The downsampled
    # knots {start + k samp : k < ceil(npts / samp)} U {start + npts - 1}
    # are a membership mask over the whole buffer, each knot once (the
    # host offset list's padding duplicates carry weight 0); the abscissa
    # is scaled by the lookahead length for the float32 Gram matrix ----
    rel = idx[None] - start[:, None]                  # (B, M)
    in_win = (rel >= 0) & (rel < npts[:, None])
    sel = in_win & (((rel % samp[:, None]) == 0)
                    | (rel == (npts - 1)[:, None]))
    wts = sel.to(fdt)
    ct, stn = torch.cos(pth), torch.sin(pth)
    dx = torch.where(sel, dxp, 0.0)
    dy = torch.where(sel, dyp, 0.0)
    x_veh = dx * ct[:, None] + dy * stn[:, None]
    y_veh = dy * ct[:, None] - dx * stn[:, None]
    order = torch.clamp(n_tot - 1, max=cfg.poly_order)     # (B,)
    xs = x_veh * (1.0 / L_scale)
    cols = [wts]                                      # V0 = 1 on sel
    for _ in range(1, n_coeffs):
        cols.append(cols[-1] * xs)
    V = torch.stack(cols, dim=-1)                     # (B, M, P)
    qmask = (torch.arange(n_coeffs, device=dev)[None, :]
             <= order[:, None]).to(fdt)               # (B, P)
    V = V * qmask[:, None, :]
    G = torch.einsum("bmi,bmj->bij", V, V)   # 0/1 weights fold into V
    G = G + 1e-12 * torch.eye(n_coeffs, dtype=fdt, device=dev)
    rhs = torch.einsum("bmi,bm->bi", V, y_veh)
    c_s = _chol_solve_small(G, rhs)                   # (B, P)
    unscale = (1.0 / L_scale) ** torch.arange(n_coeffs, dtype=fdt,
                                              device=dev)
    coeffs = c_s * unscale[None, :]
    cte = coeffs[:, 0]

    # the 30% lookahead path direction, the continuity shim and the wrap;
    # downsampled index ns-1 is buffer knot start + min((ns-1) samp,
    # npts-1)
    ns = (n_tot.to(fdt) * 0.3).to(torch.int32)
    j30 = (start + torch.minimum(torch.clamp(ns - 1, min=0) * samp,
                                 npts - 1)).long()[:, None]
    gx = at(buf[:, :, 0], j30) - at(buf[:, :, 0], start_l)
    gy = at(buf[:, :, 1], j30) - at(buf[:, :, 1], start_l)
    valid = (gx != 0.0) & (gy != 0.0) & (ns >= 2)
    traj = torch.atan2(gy, gx)
    temp = torch.where(pth <= (-np.pi + traj), pth + _TWO_PI, pth)
    use = valid & ((temp - traj) < 1.8 * np.pi)
    etheta = torch.where(use, temp - traj, 0.0)
    if pc.wrap_etheta:
        etheta = _twrap(etheta)

    # ---- reference-speed scheduling ----
    def bz(leaf):
        return torch.as_tensor(leaf, dtype=fdt, device=dev).expand(B)

    dist = torch.hypot(px - goals[:, 0], py - goals[:, 1])
    max_thr = bz(p.max_throttle)
    ref_vel = bz(p.ref_vel)
    brake = dist <= v_meas * v_meas / max_thr
    ref_vel = torch.where(
        brake, torch.clamp(max_thr * dist, pc.min_speed, pc.max_speed),
        ref_vel)
    if pc.curvature_slowdown and Mk > 0:
        kmax = at(consts["kmax_pad"], start_l)   # edge-padded to M cols
        vlim = torch.where(kmax > 1e-9, torch.sqrt(pc.max_lat_accel / kmax),
                           float("inf"))
        ref_vel = torch.clamp(torch.minimum(ref_vel, vlim), pc.min_speed,
                              pc.max_speed)

    # ---- the delay-mode one-step prediction ----
    dt = bz(p.dt)
    w_prev = carry["w"]
    thr_prev = carry["throttle"]
    if pc.delay_mode:
        yaw_rate = model.yaw_rate(v_meas, w_prev, p)
        theta_act = yaw_rate * dt
        z0s = torch.stack([
            v_meas * dt,
            torch.zeros(B, dtype=fdt, device=dev),
            theta_act,
            v_meas + thr_prev * dt,
            cte + sign * v_meas * torch.sin(etheta) * dt,
            etheta - sign * theta_act,
        ], dim=1)
    else:
        z = torch.zeros(B, dtype=fdt, device=dev)
        z0s = torch.stack([z, z, z, v_meas, cte, etheta], dim=1)

    # ---- one batched warm solve (benign zero problems off-track) ----
    z0s = torch.where(track[:, None], z0s, 0.0).to(dtype)
    coeffs_s = torch.where(track[:, None], coeffs, 0.0).to(dtype)
    refv_s = torch.where(track, ref_vel, 0.0).to(dtype)
    p2 = dataclasses.replace(p, ref_vel=refv_s)
    warm = carry["warm"]
    warm = torch.where(carry["has_warm"][:, None, None],
                       torch.cat([warm[:, 1:], warm[:, -1:]], dim=1),
                       0.0).to(dtype)
    blobs = None
    if blob_leaves:
        blobs = _blobs_to_frames(GaussianObstacles(*blob_leaves), poses,
                                 dtype)
    res = batch_solve_lane(z0s, coeffs_s, p2, cfg, u_init=warm, blobs=blobs)

    # ---- command extraction and the cross-cycle actuation state ----
    u0 = res.us[:, 0, :].to(fdt)
    speed_t = torch.minimum(v_meas + u0[:, 1] * dt, ref_vel)
    speed = torch.where(track, speed_t, carry["speed"])
    w_new = torch.where(track, u0[:, 0], w_prev)
    thr_new = torch.where(track, u0[:, 1], thr_prev)
    cmd_v = torch.where(track, speed_t, 0.0)
    cmd_w = torch.where(track, u0[:, 0], cmd_w)

    nan = float("nan")
    # the commands (fetched every cycle) and the observability tile
    # (fetched at the obs_every cadence); the tile reports the solver's
    # input error state (delay-mode predicted), as the host pipeline does
    cmds_out = torch.stack([cmd_v, cmd_w])
    if wire != "f32":
        # the 16-bit command wire: absolute fixed point of the fetched copy
        # only (the actuation state stays exact float32)
        cmds_out = torch.round(
            torch.clamp(cmds_out, -8.19, 8.19) * (1.0 / _WIRE_CMD_SCALE)
        ).to(torch.int16)
    obs = torch.stack([
        torch.where(track, z0s[:, 4].to(fdt), nan),
        torch.where(track, z0s[:, 5].to(fdt), nan),
        torch.where(track, ref_vel, nan),
        torch.where(track, res.cost.to(fdt), nan),
        (res.converged & track).to(fdt),
        torch.where(track, res.n_iters, 0).to(fdt),
        states.to(fdt),
        track.to(fdt),
    ])
    carry2 = {
        "start": start, "states": states,
        "latch_xy": latch_xy, "latch_yaw": latch_yaw,
        "set_new_goal": sng,
        "speed": speed, "w": w_new, "throttle": thr_new,
        "warm": res.us, "has_warm": track,
    }
    if wire_ticks is not None:
        carry2["wire_ticks"] = wire_ticks
    return carry2, cmds_out, obs


def _goal(planner_cfg: PlannerConfig, can_rot: bool, consts: dict,
          latch_xy, latch_yaw, sng, poses, feedback):
    """Device twin of FleetPlanner.is_goal_reached (the consume-once latch
    pair); off the hot path."""
    lim = planner_cfg.limits
    goals = consts["goals"]
    has = consts["plen"] > 0
    B = has.shape[0]
    consume = has & latch_xy & latch_yaw
    latch_xy = torch.where(consume, False, latch_xy)
    latch_yaw = torch.where(consume, False, latch_yaw)
    active = has & ~consume
    within = (torch.hypot(poses[:, 0] - goals[:, 0],
                          poses[:, 1] - goals[:, 1])
              <= lim.xy_goal_tolerance)
    shortcut = (~sng) & latch_xy
    upd = active & ~shortcut
    sng = torch.where(upd, False, sng)
    latch_xy = torch.where(upd, within, latch_xy)
    pos = active & (shortcut | within)
    ang = _twrap(poses[:, 2] - goals[:, 2])
    yaw_ok = (torch.abs(ang) <= lim.yaw_goal_tolerance if can_rot
              else torch.ones(B, dtype=torch.bool, device=has.device))
    stopped = ((torch.abs(feedback[:, 0]) <= lim.trans_stopped_vel)
               & (torch.abs(feedback[:, 1]) <= lim.theta_stopped_vel))
    reached = pos & yaw_ok & stopped
    latch_yaw = torch.where(reached, True, latch_yaw)
    return latch_xy, latch_yaw, sng, reached


class DeviceFleetPlanner(FleetPlanner):
    """FleetPlanner with the per-cycle pipeline on the device (one upload,
    one fetch per cycle). The same public API and robot-by-robot
    semantics; `state_dict`/`load_state_dict` go through the host mirrors,
    so checkpoints cross between this planner, the host planner and the
    JAX package's."""

    def __init__(self, *args, obs_every: int = 1, wire: str = "f32",
                 **kwargs):
        """`obs_every`: fetch the per-robot observability tile (cte,
        etheta, ref_vel, cost, converged, iters, states) every K cycles (1
        = every cycle, as the host planner does; 0 = never on the hot
        path: `FleetCycleInfo` rows then carry nan and stale markers).
        Commands are fetched every cycle.

        `wire`: "f32" (default) or "i16", the 16-bit fixed-point wire:
        (B, 5) int16 pose and feedback deltas up against an int32 tick
        mirror kept bit-identically on the host and the device
        (resolution 0.1 mm / 1e-5 rad, a float32 keyframe cycle on any
        larger jump), (2, B) int16 commands down (2.5e-4 resolution): 14
        bytes per robot on the wire instead of 28. The quantization
        touches only the fetched copy; the device actuation state stays
        exact float32."""
        super().__init__(*args, **kwargs)
        self.obs_every = int(obs_every)
        assert wire in ("f32", "i16")
        self.wire = wire
        self._wire_ticks = None    # host int32 tick mirror (wire="i16")
        self._wire_dirty = False   # keyframe after a non-finite frame
        self._consts = None
        self._carry = None
        self._cycle_count = 0

    # -- device state --------------------------------------------------------

    def _upload(self) -> None:
        """Push the plan constants and the cross-cycle state to the device
        (per set_plans / load_state_dict: per goal, not per cycle)."""
        f32 = torch.float32
        i32 = torch.int32
        dev = self.device

        def up(a, dtype):
            return upload(a, dtype, dev)

        M = self._buf.shape[1]
        goals = self._buf[np.arange(self.B), np.maximum(self._len - 1, 0)]
        arc_next = np.concatenate([self._arc[:, 1:], self._arc[:, -1:]], 1)
        # the curvature window maximum, edge-padded to M columns (the host
        # lookup clamps at Mk - 1; the edge padding is that clamp)
        kmax_pad = np.repeat(self._kmax_win[:, -1:], M, axis=1)
        kmax_pad[:, : self._kmax_win.shape[1]] = self._kmax_win
        self._consts = dict(zip(_CONST_KEYS, (
            up(self._buf, f32), up(self._len, i32), up(self._arc, f32),
            up(self._span, i32), up(self._kmax_win, f32), up(goals, f32),
            up(arc_next, f32), up(kmax_pad, f32))))
        self._consts["wire_scales"] = up(np.asarray(_WIRE_SCALES), f32)
        T = self.solver_cfg.n_controls
        warm = self._warm
        if isinstance(warm, torch.Tensor):
            warm = fetch(warm)[0]
        warm = np.asarray(warm, np.float32).reshape(self.B, T, 2)
        self._carry = {
            "start": up(self._start, i32),
            "states": up(self.states, i32),
            "latch_xy": up(self.latch_xy, torch.bool),
            "latch_yaw": up(self.latch_yaw, torch.bool),
            "set_new_goal": up(self.set_new_goal, torch.bool),
            "speed": up(self.speed, f32),
            "w": up(self.w, f32),
            "throttle": up(self.throttle, f32),
            "warm": up(warm, self.dtype),
            "has_warm": up(self._has_warm, torch.bool),
        }
        if self.wire == "i16":
            # fresh tick mirrors (host and device, identical zeros); the
            # first begin_cycle sees a jump beyond the delta range and
            # sends a float32 keyframe that seeds both sides
            self._wire_ticks = np.zeros((self.B, 5), np.int32)
            self._carry["wire_ticks"] = up(self._wire_ticks, i32)
        if self.mesh is not None:
            self._consts = self._split(self._consts)
            self._carry = self._split(self._carry)

    def _split(self, d: dict) -> list:
        """A dict of the fleet's device tensors as one dict per data
        shard, on the shard's device (the entries of `_REPLICATED` whole
        on each)."""
        from ..parallel.sharded import split_rows

        rows = {k: v for k, v in d.items() if k not in _REPLICATED}
        parts = split_rows(self.mesh, rows, self.B)
        for part, dev in zip(parts, self.mesh.data_devices()):
            part.update({k: d[k].to(dev) for k in _REPLICATED if k in d})
        return parts

    def _joined(self, key: str) -> torch.Tensor:
        """A carry entry over the whole fleet (gathered from the shards
        under a mesh)."""
        if self.mesh is None:
            return self._carry[key]
        from ..parallel.sharded import gather_rows

        return gather_rows([c[key] for c in self._carry], device=self.device)

    def _sync_to_host(self) -> None:
        """The device carry into the host mirror fields (checkpoints, the
        host seeding of set_plans)."""
        if self._carry is None:
            return
        keys = _CARRY_KEYS
        c = dict(zip(keys, fetch(*(self._joined(k) for k in keys))))
        self._start = np.array(c["start"], np.int64)
        self.states = np.array(c["states"], np.int64)
        self.latch_xy = np.array(c["latch_xy"], bool)
        self.latch_yaw = np.array(c["latch_yaw"], bool)
        self.set_new_goal = np.array(c["set_new_goal"], bool)
        self.speed = np.array(c["speed"], float)
        self.w = np.array(c["w"], float)
        self.throttle = np.array(c["throttle"], float)
        self._warm = np.array(c["warm"], float)
        self._has_warm = np.array(c["has_warm"], bool)

    # -- lifecycle -----------------------------------------------------------

    def initialize(self, n_robots: int) -> None:
        # drop a previous fleet's device carry before the host mirrors
        # reset: set_plans syncs device -> host first, and a stale carry
        # would bring the old fleet's state back (or break on a new B)
        self._consts = None
        self._carry = None
        self._cycle_count = 0
        super().initialize(n_robots)

    def set_plans(self, plans, poses):
        # mid-run goal changes: the live latches, warm bank and actuation
        # state ride the device carry; pull them down before the host
        # seeding mutates the mirrors, then push the merged state up
        self._sync_to_host()
        ok = super().set_plans(plans, poses)
        self._upload()
        return ok

    def state_dict(self) -> dict:
        self._sync_to_host()
        return super().state_dict()

    def load_state_dict(self, sd: dict) -> None:
        super().load_state_dict(sd)
        self._upload()

    def is_goal_reached(self, poses, feedback):
        assert self._consts is not None, "set_plans first"
        world = np.empty((self.B, 5), np.float32)
        world[:, :3] = poses
        world[:, 3:] = feedback
        world = upload(world, torch.float32, self.device)

        def goal(consts, c, wd):
            lx, ly, sng, reached = _goal(
                self.planner_cfg, self.model.can_rotate_in_place, consts,
                c["latch_xy"], c["latch_yaw"], c["set_new_goal"],
                wd[:, :3], wd[:, 3:])
            return dict(c, latch_xy=lx, latch_yaw=ly, set_new_goal=sng,
                        states=torch.where(reached, _IDLE, c["states"])), \
                reached

        if self.mesh is None:
            self._carry, reached = goal(self._consts, self._carry, world)
        else:
            from ..parallel.sharded import gather_rows, split_rows

            out = []
            for i, (k, c, wd) in enumerate(zip(
                    self._consts, self._carry,
                    split_rows(self.mesh, world, self.B))):
                with self.mesh.on(i):
                    out.append(goal(k, c, wd))
            self._carry = [o[0] for o in out]
            reached = gather_rows([o[1] for o in out], device=self.device)
        return np.asarray(fetch(reached)[0], bool)

    # -- the hot path --------------------------------------------------------

    def begin_cycle(self, poses, feedback) -> dict:
        assert self._initialized and self._consts is not None
        # one upload: poses ++ feedback as a (B, 5) tile, float32, or
        # int16 deltas under the 16-bit wire
        world = np.empty((self.B, 5), np.float32)
        world[:, :3] = poses
        world[:, 3:] = feedback
        wire_mode = "f32"
        if self.wire == "i16":
            scl32 = np.asarray(_WIRE_SCALES, np.float32)
            finite = bool(np.isfinite(world).all())
            # Keyframe triggers:
            # * non-finite poses or feedback (NaN compares False, so a
            #   plain `dq > 32767` test would cast NaN to int16 and corrupt
            #   the tick mirror), and the cycle after one, because NaN
            #   ticks cast differently on the device: both mirrors reseed
            #   together from the first finite frame;
            # * the yaw-tick budget: the yaw mirror accumulates unwrapped
            #   yaw (the delta is wrapped, the running sum is not);
            #   ~628k ticks per lap at 1e-5 rad per tick coarsens the
            #   float32 decode, and keyframing reseeds from the wrapped yaw;
            # * a teleport or a fresh mirror: a delta beyond int16 range.
            need_kf = (not finite or self._wire_dirty
                       or np.abs(self._wire_ticks[:, 2]).max() > 1e7)
            if not need_kf:
                # decode the mirror as the device does (float32 ops)
                mirror = self._wire_ticks.astype(np.float32) * scl32
                dlt = world.astype(np.float64) - mirror.astype(np.float64)
                # yaw delta wrapped: the mirror tracks yaw modulo 2 pi
                # (every use of yaw in the cycle is 2 pi-periodic)
                dlt[:, 2] = (dlt[:, 2] + np.pi) % (2.0 * np.pi) - np.pi
                dq = np.round(dlt / np.asarray(_WIRE_SCALES, np.float64))
                need_kf = not (np.abs(dq).max() <= 32767)
            if need_kf:
                # a float32 keyframe cycle reseeds the tick mirror on both
                # sides from the true poses (nan_to_num keeps the host
                # mirror finite so the wire recovers once the poses do)
                wire_mode = "kf"
                self._wire_ticks = np.round(
                    np.nan_to_num(world) / scl32).astype(np.int32)
                self._wire_dirty = not finite
            else:
                wire_mode = "i16"
                d16 = dq.astype(np.int16)
                self._wire_ticks = self._wire_ticks + d16.astype(np.int32)
                world = d16
        world = upload(world, torch.from_numpy(world).dtype, self.device)
        blob_leaves = ()
        if self._world_dev is not None:
            ob = self._world_dev
            blob_leaves = (ob.cx, ob.cy, ob.gamma, ob.w)
        if self.mesh is None:
            self._carry, cmds_out, obs = _cycle(
                self.solver_cfg, self.planner_cfg, self.dtype, wire_mode,
                self._consts, self._carry, world, self.params, *blob_leaves)
        else:
            cmds_out, obs = self._cycle_sharded(wire_mode, world,
                                                blob_leaves)
        want_obs = self.obs_every > 0 and (
            self._cycle_count % self.obs_every == 0)
        self._cycle_count += 1
        return {"cmds": cmds_out, "obs": obs if want_obs else None,
                "ok": self._has_plan()}

    def _cycle_sharded(self, wire_mode: str, world, blob_leaves):
        """`_cycle` on every data shard of the mesh, each on its B / n_data
        robots and its own carry; the (2, B) commands and (8, B) rows
        concatenated in shard order on the planner's device."""
        from ..parallel.sharded import gather_rows, split_rows

        B, mesh = self.B, self.mesh
        out = []
        for i, args in enumerate(zip(
                self._consts, self._carry, split_rows(mesh, world, B),
                split_rows(mesh, self.params, B),
                *(split_rows(mesh, a, B) for a in blob_leaves))):
            with mesh.on(i):
                out.append(_cycle(self.solver_cfg, self.planner_cfg,
                                  self.dtype, wire_mode, *args))
        self._carry = [o[0] for o in out]
        return (gather_rows([o[1] for o in out], 1, self.device),
                gather_rows([o[2] for o in out], 1, self.device))

    def finish_cycle(self, h: dict):
        def decode(cm):
            cmds = np.asarray(cm, np.float64).T.copy()
            if self.wire == "i16":
                cmds *= _WIRE_CMD_SCALE
            return cmds

        if h["obs"] is not None:
            cm, obs = fetch(h["cmds"], h["obs"])
            obs = np.asarray(obs, np.float64)
            track = obs[OB_TRACK] > 0.5
            cmds = decode(cm)
            info = FleetCycleInfo(
                states=obs[OB_STATE].astype(np.int64),
                cmds=cmds,
                ref_vel=obs[OB_REFV],
                cte=obs[OB_CTE],
                etheta=obs[OB_ETH],
                cost=obs[OB_COST],
                converged=(obs[OB_CONV] > 0.5) & track,
                n_iters=obs[OB_ITERS].astype(np.int32),
            )
        else:
            # a lean cycle: commands only on the wire; the observability
            # rows carry nan and stale markers (states -1 = not fetched;
            # gate consumers on FleetCycleInfo.observed)
            (cm,) = fetch(h["cmds"])
            cmds = decode(cm)
            B = cmds.shape[0]
            nan = np.full(B, np.nan)
            info = FleetCycleInfo(
                states=np.full(B, -1, np.int64), cmds=cmds, ref_vel=nan,
                cte=nan, etheta=nan, cost=nan,
                converged=np.zeros(B, bool),
                n_iters=np.zeros(B, np.int32),
            )
        # the host actuation mirrors stay stale between syncs by design;
        # the live values ride the device carry
        return h["ok"], cmds, info
