"""The port's planner node (`planner/node.py`) and the paced closed loop:
the three cases of tests/test_node.py with the port's `MPCPlanner` on the
CPU (float32, the XLA lane path's solver), the node serving another OS
process over shared-memory topics (the planner process is
`testing.node_over_shm`), and `run_closed_loop(realtime=True)` for a few
cycles with its rate statistics."""

import os
import struct
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from mpc_ros_tpu_torch.config import MPCParams, PlannerConfig, SolverConfig
from mpc_ros_tpu_torch.planner import MPCPlanner
from mpc_ros_tpu_torch.planner.node import (TWIST_FMT, PlannerNode,
                                            pack_pose, pack_twist)
from mpc_ros_tpu_torch.testing import torch_threads

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with torch_threads(1):
        yield


def _planner(n_steps=10, **leaves):
    return MPCPlanner(params=MPCParams(**leaves),
                      solver_cfg=SolverConfig(n_steps=n_steps,
                                              backward="xla"),
                      planner_cfg=PlannerConfig(local_plan_length=2.0),
                      device="cpu")


def _straight(n=100, length=5.0):
    xs = np.linspace(0, length, n)
    return np.stack([xs, np.zeros(n), np.zeros(n)], axis=1)


def test_node_closed_loop_over_topics():
    """A simulated plant publishes pose and feedback over topics; the node
    drives it along a straight plan, commands flowing back over the cmd
    topic, the predicted horizon over the trajectory topic."""
    planner = _planner(dt=0.05, ref_vel=0.5, w_cte=300.0)
    planner.initialize()
    node = PlannerNode(planner, period_s=0.02)
    pose = np.array([0.0, 0.15, 0.0])   # off the path
    vel = (0.0, 0.0)
    node.pose_topic.publish(pack_pose(*pose))
    node.feedback_topic.publish(pack_twist(*vel))
    assert node.set_plan(_straight())
    node.start()
    try:
        # the plant runs until it passes 1 m and the node has run 20
        # cycles (the port's cycle on one CPU thread outlasts the period)
        t_end = time.time() + 10.0
        applied = 0
        while time.time() < t_end and (pose[0] < 1.0 or node.cycles <= 20):
            raw = node.cmd_topic.read()
            if raw is not None:
                v, w = struct.unpack(TWIST_FMT, raw)
                pose = pose + 0.02 * np.array(
                    [v * np.cos(pose[2]), v * np.sin(pose[2]), w])
                vel = (v, w)
                applied += 1
            node.pose_topic.publish(pack_pose(*pose))
            node.feedback_topic.publish(pack_twist(*vel))
            time.sleep(0.004)
    finally:
        assert node.stop()
    assert node.cycles > 20
    assert node.errors == 0, node.last_error
    assert applied > 20
    assert pose[0] > 0.3, f"robot did not advance: {pose}"
    assert abs(pose[1]) < 0.2, f"lateral error grew: {pose}"
    raw_traj = node.traj_topic.read()
    assert raw_traj is not None
    traj = np.frombuffer(raw_traj, dtype=np.float64).reshape(-1, 3)
    assert traj.shape[0] == 10
    assert node.rate_stats["cycles"] >= node.cycles


def test_failed_cycle_always_publishes_explicit_stop():
    """A failed cycle with no SafetyMonitor publishes an explicit stop, so
    the last nonzero command does not stay latched."""
    planner = _planner()
    planner.initialize()
    node = PlannerNode(planner, period_s=0.05)
    plan = np.stack([np.linspace(0, 2, 20), np.zeros(20), np.zeros(20)], 1)
    node.pose_topic.publish(pack_pose(0.0, 0.0, 0.0))
    node.feedback_topic.publish(pack_twist(0.2, 0.0))
    assert node.set_plan(plan)
    node._cycle()
    planner.global_plan = None           # the fault: the plan is lost
    node.cmd_topic.publish(pack_twist(9.0, 9.0))
    node._cycle()
    v, w = struct.unpack("<2d", node.cmd_topic.read())
    assert (v, w) == (0.0, 0.0), (v, w)


def test_stop_reports_alive_thread():
    """A second start() is refused while the loop runs; stop() joins it."""
    planner = _planner()
    planner.initialize()
    node = PlannerNode(planner, period_s=0.02)
    node.start()
    try:
        with pytest.raises(RuntimeError):
            node.start()
    finally:
        assert node.stop(timeout=5.0)
    assert node._thread is None


def test_planner_node_serves_over_shm_cross_process():
    """The plant runs here, the node in another OS process; pose, feedback
    and commands cross over POSIX shared-memory seqlock topics. The plant
    runs until it passes 0.3 m (at most 60 s), then asks the node's
    process to stop over a fifth topic."""
    from mpc_ros_tpu_torch.native import ShmTopic

    prefix = f"/mpcrt_torch_node_{os.getpid()}"
    topics = [ShmTopic(prefix + s, cap, create=True) for s, cap in (
        ("_pose", 64), ("_fb", 64), ("_cmd", 64), ("_traj", 4096),
        ("_stop", 64))]
    pose_t, fb_t, cmd_t, _, stop_t = topics
    try:
        pose, vel = np.array([0.0, 0.1, 0.0]), (0.0, 0.0)
        pose_t.publish(pack_pose(*pose))
        fb_t.publish(pack_twist(*vel))
        proc = subprocess.Popen(
            [sys.executable, "-c",
             "import sys; from mpc_ros_tpu_torch.testing import "
             "node_over_shm; node_over_shm(sys.argv[1], float(sys.argv[2]))",
             prefix, "60.0"], cwd=ROOT, stdout=subprocess.PIPE,
            env=dict(os.environ, PYTHONPATH=ROOT))
        applied = 0
        deadline = time.time() + 60.0
        while (time.time() < deadline and proc.poll() is None
               and not (pose[0] > 0.3 and applied > 20)):
            raw = cmd_t.read()
            if raw is not None:
                v, w = struct.unpack(TWIST_FMT, raw)
                pose = pose + 0.02 * np.array(
                    [v * np.cos(pose[2]), v * np.sin(pose[2]), w])
                vel = (v, w)
                applied += 1
            pose_t.publish(pack_pose(*pose))
            fb_t.publish(pack_twist(*vel))
            time.sleep(0.004)
        stop_t.publish(b"stop")
        out, _ = proc.communicate(timeout=120)
        assert proc.returncode == 0, out
        assert b"errors 0" in out, out
        assert applied > 20
        assert pose[0] > 0.2, f"robot did not advance: {pose}"
        assert abs(pose[1]) < 0.2, f"lateral error grew: {pose}"
    finally:
        for t in topics:
            t.close()
            t.unlink()


def test_realtime_closed_loop_reports_rate_stats():
    """`run_closed_loop(realtime=True)`: the pacer arms after the first two
    cycles and its statistics ride the result (the deadlines themselves
    are the card's to keep: ROADMAP Queue 3 item 8)."""
    from mpc_ros_tpu_torch.sim import infinity, run_closed_loop

    planner = _planner(dt=0.05, ref_vel=0.5, w_cte=300.0)
    res = run_closed_loop(planner, infinity(n_points=300), max_cycles=8,
                          realtime=True)
    assert res.n_cycles == 8
    rs = res.rate_stats
    assert rs is not None and rs["cycles"] == 6
    assert 0 <= rs["overruns"] <= rs["cycles"]
    assert np.isfinite(rs["worst_late_ms"])
    assert res.wall_time_s >= 6 * 0.05 * 0.9
    plain = run_closed_loop(planner, infinity(n_points=300), max_cycles=3)
    assert plain.rate_stats is None
    assert torch.get_num_threads() == 1
