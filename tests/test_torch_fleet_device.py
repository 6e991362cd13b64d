"""The port's device-pipeline fleet (`DeviceFleetPlanner`) against the
JAX package's and against the port's host fleet, on the CPU.

The device cycle runs the plan pipeline in float32 (the fit on a scaled
abscissa) and the solve in the planner's dtype; the host fleet runs the
pipeline in float64 numpy. The bars are the JAX package's own
(tests/test_fleet_device.py): FSM states and cursors equal, commands within
2e-3, cte and etheta within 1e-3, ref_vel within 1e-5; on the 16-bit wire
cursors within one knot on at most 3 robots, commands within 3e-3 on equal
cursors and 3e-2 on all. The port's device fleet is held to those bars
against the port's host fleet. Against the JAX device fleet, which runs the
same float32 cycle on the same inputs, it is held to bars set from the
measured gap with margin (`JAX_BARS`): equal states, cursors and
iterations, and commands, cte, etheta and ref_vel close. The gap comes
from the float32 fit's normal equations summed in another order; the JAX
fleet moves as far itself when the poses change by one float32 ulp. The
host and device tick mirrors of the 16-bit wire are equal bit for bit
every cycle, through keyframes after a jump and after a NaN frame. Then mid-run replans, re-initialization, goal latches, the bicycle
with the curvature scheduler, world obstacles, lean cycles and
checkpoints crossing between the packages and the pipelines.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_ros_tpu.config import MPCParams as JMPCParams
from mpc_ros_tpu.config import PlannerConfig as JPlannerConfig
from mpc_ros_tpu.config import SolverConfig as JSolverConfig
from mpc_ros_tpu.planner import FleetPlanner as JFleet
from mpc_ros_tpu.planner.fleet_device import DeviceFleetPlanner as JDevice
from mpc_ros_tpu_torch.config import MPCParams, PlannerConfig, SolverConfig
from mpc_ros_tpu_torch.models.obstacles import GaussianObstacles
from mpc_ros_tpu_torch.planner import DeviceFleetPlanner, FleetPlanner
from mpc_ros_tpu_torch.planner import fleet_device
from mpc_ros_tpu_torch.testing import fleet_courses, step_poses, torch_threads

LEAVES = dict(max_angvel=1.5, w_cte=300.0, w_angvel_d=10.0, w_accel_d=10.0)
SOLVER = dict(n_steps=12, max_sqp_iters=25)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these tests run many small ops, and the suite
    runs in several processes at once (`testing.torch_threads`)."""
    with torch_threads(1):
        yield


def _configs(model="diff_drive", curvature=False, leaves=None):
    leaves = dict(LEAVES, **(leaves or {}))
    if model == "bicycle":
        leaves.update(lf=0.25, max_steer=0.6)
    return (leaves, dict(SOLVER, model=model),
            dict(local_plan_length=2.5, curvature_slowdown=curvature))


def _port(kind, B, model="diff_drive", curvature=False, dtype=torch.float32,
          **kw):
    leaves, solver, planner = _configs(model, curvature)
    cls = DeviceFleetPlanner if kind == "device" else FleetPlanner
    fp = cls(MPCParams(**leaves), SolverConfig(**solver),
             PlannerConfig(**planner), dtype=dtype, device="cpu", **kw)
    fp.initialize(B)
    return fp


def _jax(kind, B, dtype=jnp.float32, **kw):
    leaves, solver, planner = _configs()
    cls = JDevice if kind == "device" else JFleet
    fp = cls(params=JMPCParams(**leaves), solver_cfg=JSolverConfig(**solver),
             planner_cfg=JPlannerConfig(**planner), dtype=dtype, **kw)
    fp.initialize(B)
    return fp


def _plans(B, stagger=True):
    return fleet_courses(B, offset=3.0, stagger=37 if stagger else 0)


def _start_poses(plans, seed=0):
    poses = np.stack([p[0] for p in plans]).astype(float)
    poses[:, :2] += np.random.default_rng(seed).normal(0, 0.05,
                                                       (len(plans), 2))
    return poses


def _cursor(fp):
    start = fp._carry["start"] if "Device" in type(fp).__name__ else (
        fp._start)
    return np.asarray(start).astype(np.int64)


def _hold(host, dev, out_h, out_d, cyc, wire="f32", skip=()):
    """The JAX bars between a host and a device fleet's cycle outputs."""
    (ok_h, cmd_h, info_h), (ok_d, cmd_d, info_d) = out_h, out_d
    keep = np.ones(len(ok_h), bool)
    keep[list(skip)] = False
    np.testing.assert_array_equal(ok_h, ok_d)
    np.testing.assert_array_equal(info_h.states[keep], info_d.states[keep],
                                  err_msg=f"cycle {cyc}")
    dcur = np.abs(_cursor(host) - _cursor(dev))[keep]
    dcmd = np.abs(cmd_h - cmd_d)[keep].max(axis=1)
    if wire == "f32":
        assert dcur.max() == 0, (cyc, dcur)
        assert dcmd.max() < 2e-3, (cyc, dcmd)
    else:
        assert dcur.max() <= 1 and (dcur > 0).sum() <= 3, (cyc, dcur)
        assert dcmd[dcur == 0].max() < 3e-3, (cyc, dcmd)
        assert dcmd.max() < 3e-2, (cyc, dcmd)
    tr = (info_h.states == 0) & keep
    if tr.any() and wire == "f32":
        assert np.nanmax(np.abs(info_h.cte - info_d.cte)[tr]) < 1e-3
        assert np.nanmax(np.abs(info_h.etheta - info_d.etheta)[tr]) < 1e-3
        assert np.nanmax(np.abs(info_h.ref_vel - info_d.ref_vel)[tr]) < 1e-5


# Port device fleet against JAX device fleet, 12 robots over 6 cycles on
# the CPU (solve dtype or wire: commands, cte, etheta, ref_vel). Measured
# gaps: float32 2.04e-4, 2.11e-5, 2.04e-5, 0; float64 2.46e-6, 2.04e-5,
# 2.46e-7, 0; the 16-bit wire 2.5e-4 (one command tick), 1.22e-4, 9.6e-6,
# 0. The JAX fleet's own response to a one-ulp float32 change of the poses
# is 2.04e-4, 5.08e-5, 2.04e-5 (float32) and 4.5e-6, 4.7e-5, 6.6e-7
# (float64).
JAX_BARS = {"float32": (5e-4, 1e-4, 1e-4, 1e-7),
            "float64": (1e-5, 1e-4, 1e-6, 1e-7),
            "i16": (fleet_device._WIRE_CMD_SCALE * (1 + 1e-6), 3e-4, 5e-5,
                    1e-7)}


def _close(ref, dev, out_j, out_d, cyc, bars):
    """The port's device fleet against the JAX device fleet: states,
    cursors and iterations equal, the outputs within `bars`."""
    (ok_j, cmd_j, info_j), (ok_d, cmd_d, info_d) = out_j, out_d
    np.testing.assert_array_equal(ok_j, ok_d)
    np.testing.assert_array_equal(info_j.states, info_d.states,
                                  err_msg=f"cycle {cyc}")
    np.testing.assert_array_equal(_cursor(ref), _cursor(dev))
    np.testing.assert_array_equal(info_j.n_iters, info_d.n_iters)
    b_cmd, b_cte, b_eth, b_rv = bars
    assert np.abs(cmd_j - cmd_d).max() <= b_cmd, (cyc, cmd_j - cmd_d)
    tr = info_j.states == 0
    for k, bar in (("cte", b_cte), ("etheta", b_eth), ("ref_vel", b_rv)):
        gap = np.abs(getattr(info_j, k) - getattr(info_d, k))[tr]
        assert gap.size == 0 or gap.max() <= bar, (cyc, k, gap)


def _run(fleets, plans, cycles, poses=None, events=None, lf=None):
    """Every fleet on the first fleet's pose stream; yields (cycle, the
    outputs of each fleet). `events[cycle](poses, seen)` edits the poses
    (from then on) or the copy the fleets see that cycle."""
    poses = _start_poses(plans) if poses is None else poses
    fb = np.zeros((len(plans), 2))
    for fp in fleets:
        assert fp.set_plans(plans, poses).all()
    for cyc in range(cycles):
        seen = poses.copy()
        if events and cyc in events:
            events[cyc](poses, seen)
        outs = [fp.compute_velocity_commands(seen, fb) for fp in fleets]
        yield cyc, outs
        fb = step_poses(poses, outs[0][1], 0.1, lf)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_device_matches_jax_device_and_host(dtype):
    """12 robots on staggered infinity courses, 6 cycles: the port's
    device fleet against the JAX device fleet and against the port's host
    fleet at the JAX bars, and against the JAX device fleet at
    `JAX_BARS`."""
    B = 12
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    host = _port("host", B, dtype=tdt)
    dev = _port("device", B, dtype=tdt)
    ref = _jax("device", B, dtype=jdt)
    for cyc, (o_h, o_d, o_j) in _run([host, dev, ref], _plans(B), 6):
        _hold(host, dev, o_h, o_d, cyc)
        _close(ref, dev, o_j, o_d, cyc, JAX_BARS[dtype])
    assert dev._carry["warm"].dtype == tdt


def test_i16_wire_matches_jax_and_host():
    """The 16-bit wire: the first cycle is a keyframe (robots up to ~33 m
    out, beyond the delta range), later cycles int16 deltas; the host tick
    mirror equals the device's and the JAX fleet's bit for bit every
    cycle; commands at the 16-bit bars against the host fleet, and
    against the JAX 16-bit fleet at `JAX_BARS` (commands within one
    tick)."""
    B = 12
    host = _port("host", B)
    dev = _port("device", B, wire="i16")
    ref = _jax("device", B, wire="i16")
    for cyc, (o_h, o_d, o_j) in _run([host, dev, ref], _plans(B), 6):
        _hold(host, dev, o_h, o_d, cyc, wire="i16")
        _close(ref, dev, o_j, o_d, cyc, JAX_BARS["i16"])
        np.testing.assert_array_equal(dev._wire_ticks, ref._wire_ticks)
        np.testing.assert_array_equal(
            dev._wire_ticks, dev._carry["wire_ticks"].numpy())
    assert np.abs(dev._wire_ticks[:, 0]).max() > 0


def test_i16_keyframes_after_a_jump_and_a_nan_frame():
    """A 4 m jump of robot 0 along its plan, beyond the delta range (cycle 2),
    and a NaN pose of robot 1 (cycle 4) each send a float32 keyframe; the
    frame after the NaN one is a keyframe too (the NaN ticks cast differently on each side), and from
    it on the mirrors are equal again and the wire back on deltas. The
    other robots hold the 16-bit bars against the float32-wire fleet fed
    the same stream throughout."""
    B = 8
    f32 = _port("device", B)
    dev = _port("device", B, wire="i16")
    modes = []
    cycle = fleet_device._cycle

    def spy(*a, **kw):
        if a[3] != "f32":           # the 16-bit fleet's cycles
            modes.append(a[3])
        return cycle(*a, **kw)

    plans = _plans(B)
    # robot 0 on a straight 20 m plan, so its cursor follows the jump
    n = 400
    plans[0] = np.stack([np.linspace(0, 20, n), np.zeros(n), np.zeros(n)],
                        1)

    def jump(poses, seen):
        poses[0, 0] += 4.0
        seen[0] = poses[0]

    def nan(poses, seen):
        seen[1, 0] = np.nan

    fleet_device._cycle = spy
    try:
        for cyc, (o_f, o_d) in _run([f32, dev], plans, 8,
                                    events={2: jump, 4: nan}):
            if cyc == 2:
                jumped = o_d
            _hold(f32, dev, o_f, o_d, cyc, wire="i16",
                  skip=(1,) if cyc >= 4 else ())
            if cyc != 4:
                np.testing.assert_array_equal(
                    dev._wire_ticks, dev._carry["wire_ticks"].numpy())
    finally:
        fleet_device._cycle = cycle
    assert modes == ["kf", "i16", "kf", "i16", "kf", "kf", "i16", "i16"]
    assert not dev._wire_dirty
    assert np.isfinite(jumped[1]).all()


def test_midrun_replan_keeps_live_state():
    """set_plans on a running fleet merges the live device state (warm
    bank, latches, actuation), not stale host mirrors."""
    B = 6
    host, dev = _port("host", B), _port("device", B)
    plans = _plans(B)
    for _ in _run([host, dev], plans, 3):
        pass
    poses = np.stack([pl[3] for pl in plans]).astype(float)
    new_plans = [pl[::-1].copy() if i < 3 else None
                 for i, pl in enumerate(plans)]
    for i in range(3):
        d = np.diff(new_plans[i][:, :2], axis=0)
        new_plans[i][:-1, 2] = np.arctan2(d[:, 1], d[:, 0])
        new_plans[i][-1, 2] = new_plans[i][-2, 2]
    np.testing.assert_array_equal(host.set_plans(new_plans, poses),
                                  dev.set_plans(new_plans, poses))
    np.testing.assert_array_equal(host.states, dev._carry["states"].numpy())
    np.testing.assert_array_equal(host._has_warm,
                                  dev._carry["has_warm"].numpy())
    fb = np.zeros((B, 2))
    _hold(host, dev, host.compute_velocity_commands(poses, fb),
          dev.compute_velocity_commands(poses, fb), "replan")


def test_reinitialize_drops_the_stale_carry():
    B = 6
    dev = _port("device", B)
    for _ in _run([dev], _plans(B), 2):
        pass
    dev.initialize(4)
    plans = _plans(4, stagger=False)
    poses = np.stack([pl[0] for pl in plans]).astype(float)
    assert dev.set_plans(plans, poses).all()
    assert not dev._carry["has_warm"].any()
    _, cmds, info = dev.compute_velocity_commands(poses, np.zeros((4, 2)))
    assert np.isfinite(cmds).all()
    assert (info.states == 0).any()


def test_goal_latches_match_host():
    """The consume-once latch pair through the device twin of
    is_goal_reached, equal to the host fleet's."""
    host, dev = _port("host", 4), _port("device", 4)
    plans = _plans(4, stagger=False)
    poses = np.stack([pl[-1] for pl in plans]).astype(float)
    fb = np.zeros((4, 2))
    host.set_plans(plans, poses)
    dev.set_plans(plans, poses)
    for _ in range(3):
        np.testing.assert_array_equal(host.is_goal_reached(poses, fb),
                                      dev.is_goal_reached(poses, fb))
        for k in ("latch_xy", "latch_yaw", "set_new_goal"):
            np.testing.assert_array_equal(getattr(host, k),
                                          dev._carry[k].numpy())
    np.testing.assert_array_equal(host.states, dev._carry["states"].numpy())


def test_bicycle_with_curvature_matches_host():
    B = 8
    host = _port("host", B, model="bicycle", curvature=True)
    dev = _port("device", B, model="bicycle", curvature=True)
    for cyc, (o_h, o_d) in _run([host, dev], _plans(B), 4, lf=0.25):
        _hold(host, dev, o_h, o_d, cyc)


def test_world_obstacles_match_host():
    """Per-robot world-frame blobs through the device cycle (the frame
    transform and the solve's blob terms) as through the host fleet."""
    B = 4
    n = 100
    plan = np.stack([np.linspace(0, 6, n), np.zeros(n), np.zeros(n)], 1)
    blobs = GaussianObstacles.from_sigmas(
        torch.tensor([[3.0], [3.0], [50.0], [50.0]]),
        torch.tensor([[0.05], [0.05], [50.0], [50.0]]),
        torch.full((B, 1), 0.3), torch.full((B, 1), 50.0))
    host, dev = _port("host", B), _port("device", B)
    host.set_obstacles(blobs)
    dev.set_obstacles(blobs)
    poses = np.stack([plan[0]] * B).astype(float)
    for cyc, (o_h, o_d) in _run([host, dev], [plan.copy()] * B, 5,
                                poses=poses):
        _hold(host, dev, o_h, o_d, cyc)


def test_lean_cycles_fetch_commands_only():
    """obs_every=2: every other cycle fetches only the commands (states
    -1, observed False); the commands equal those of a fleet that fetches
    every cycle."""
    B = 4
    full, lean = _port("device", B), _port("device", B, obs_every=2)
    for cyc, (o_f, o_l) in _run([full, lean], _plans(B), 4):
        np.testing.assert_array_equal(o_f[1], o_l[1])
        assert o_l[2].observed.all() == (cyc % 2 == 0)
        assert o_f[2].observed.all()


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_checkpoints_cross_between_packages_and_pipelines(direction):
    """A JAX host fleet's `state_dict()` loaded into the port's device
    fleet continues with the JAX fleet's commands, and the port's device
    checkpoint loaded into a JAX host fleet continues with the port's,
    at the device-against-host bars."""
    B = 6
    plans = _plans(B)
    src = _jax("host", B) if direction == "jax_to_port" else _port(
        "device", B)
    for _ in _run([src], plans, 2):
        pass
    dst = _port("device", B) if direction == "jax_to_port" else _jax(
        "host", B)
    dst.load_state_dict(src.state_dict())
    poses = np.stack([pl[2] for pl in plans]).astype(float)
    fb = np.full((B, 2), 0.1)
    for cyc in range(3):
        outs = [fp.compute_velocity_commands(poses, fb) for fp in (src, dst)]
        host, dev = (src, dst) if direction == "jax_to_port" else (dst, src)
        o_h, o_d = outs if direction == "jax_to_port" else outs[::-1]
        _hold(host, dev, o_h, o_d, cyc)
        fb = step_poses(poses, outs[0][1], 0.1)
