"""Planner node: the move_base-equivalent control loop over native topics
(counterpart of `mpc_ros_tpu/planner/node.py`).

The reference is a plugin inside move_base: ROS topics in (feedback_vel),
tf/costmap for pose, cmd_vel out, driven at controller_frequency
(mpc_ros's src/mpc_planner_ros.cpp:38-92,397). This node is
the standalone successor: a control loop paced by the native rate executor
(deadline-monitored) that consumes pose/feedback from seqlock Topics
(tear-free — the reference's handoff was racy, SURVEY.md §5.2) and
publishes the command and predicted trajectory to Topics.

Message framing is plain little-endian doubles (struct), matching the
fixed-size Twist/Pose payloads the reference exchanged. The planner is
the port's `MPCPlanner`, on the card unless it was built with
`device="cpu"`.
"""

from __future__ import annotations

import struct
import threading
from typing import Optional

import numpy as np

from ..native import RateLoop, Topic
from .planner import MPCPlanner

POSE_FMT = "<3d"        # x, y, yaw
TWIST_FMT = "<2d"       # v, w


def pack_pose(x: float, y: float, yaw: float) -> bytes:
    return struct.pack(POSE_FMT, x, y, yaw)


def pack_twist(v: float, w: float) -> bytes:
    return struct.pack(TWIST_FMT, v, w)


class PlannerNode:
    """Runs `MPCPlanner` at a fixed rate against topic inputs.

    Topics:
      pose      (in):  (x, y, yaw) POSE_FMT
      feedback  (in):  (v, w)      TWIST_FMT   (reference: feedback_vel)
      cmd       (out): (v, w)      TWIST_FMT   (reference: cmd_vel)
      mpc_traj  (out): N x (x, y, yaw) doubles (reference: mpc_trajectory)
    """

    def __init__(self, planner: MPCPlanner, period_s: Optional[float] = None,
                 recovery=None, safety=None, topics: Optional[dict] = None):
        """`recovery`: optional RecoverySupervisor (planner/recovery.py) —
        the move_base recovery-ladder role; `safety`: optional SafetyMonitor
        (planner/safety.py) — command validation + controlled stop. Both
        default off, preserving the bare reference-plugin behavior.

        `topics`: optional {"pose": t, "feedback": t, "cmd": t, "traj": t}
        overrides — pass `native.ShmTopic` instances to serve another OS
        process over shared memory (the reference's cross-process TCPROS
        boundary); omitted keys get in-process `Topic` slots."""
        self.planner = planner
        self.recovery = recovery
        self.safety = safety
        self.period_s = period_s or float(planner.params.dt)
        topics = topics or {}
        n = planner.solver_cfg.n_steps
        self.pose_topic = topics.get("pose") or Topic(64)
        self.feedback_topic = topics.get("feedback") or Topic(64)
        self.cmd_topic = topics.get("cmd") or Topic(64)
        self.traj_topic = topics.get("traj") or Topic(n * 3 * 8 + 16)
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        # serializes planner-state mutation between the loop thread and
        # callers of set_plan (an unsynchronized set_plan could be
        # overwritten by the loop's in-flight plan pruning, silently
        # losing the new goal)
        self._plan_lock = threading.Lock()
        self.cycles = 0
        self.errors = 0
        self.last_error: Optional[str] = None
        self.rate_stats: dict = {}

    # -- lifecycle ---------------------------------------------------------

    def set_plan(self, plan: np.ndarray) -> bool:
        raw = self.pose_topic.read()
        pose = np.array(struct.unpack(POSE_FMT, raw)) if raw else plan[0]
        with self._plan_lock:
            if self.recovery is not None:
                return self.recovery.set_plan(plan, pose)
            return self.planner.set_plan(plan, pose)

    def start(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            raise RuntimeError("PlannerNode loop already running")
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def stop(self, timeout: float = 5.0) -> bool:
        """Stop the loop; returns False if the thread is still alive after
        `timeout` (e.g. blocked in a long cycle) — the handle is kept so a
        retry can join it and start() cannot spawn a second publisher."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout)
            if self._thread.is_alive():
                return False
            self._thread = None
        return True

    # -- the loop ----------------------------------------------------------

    def _loop(self) -> None:
        rate = RateLoop(self.period_s)
        try:
            while not self._stop.is_set():
                try:
                    self._cycle()
                except Exception:  # noqa: BLE001 — control loop must survive
                    # A raising cycle must not kill the loop thread while
                    # the last nonzero command stays latched in cmd_topic —
                    # publish an explicit stop, count the fault, keep going
                    # (move_base's recovery role, SURVEY.md §5.3).
                    self.errors += 1
                    import traceback

                    self.last_error = traceback.format_exc()
                    try:
                        self.cmd_topic.publish(pack_twist(0.0, 0.0))
                    except Exception:  # noqa: BLE001
                        pass
                rate.sleep()
        finally:
            self.rate_stats = rate.stats
            rate.close()

    def _cycle(self) -> None:
        raw_pose = self.pose_topic.read()
        if raw_pose is None:
            return
        pose = np.array(struct.unpack(POSE_FMT, raw_pose))
        raw_fb = self.feedback_topic.read()
        fb = struct.unpack(TWIST_FMT, raw_fb) if raw_fb else (0.0, 0.0)

        with self._plan_lock:
            if self.planner.is_goal_reached(pose, fb):
                if self.safety is not None:
                    # keep the monitor's speed memory fresh (the controlled
                    # stop bleeds from the last observed command)
                    self.safety.check(True, (0.0, 0.0), None)
                self.cmd_topic.publish(pack_twist(0.0, 0.0))
                self.cycles += 1
                return
            ok, (v, w), info = self.planner.compute_velocity_commands(
                pose, fb)
            if self.recovery is not None:
                ok, (v, w) = self.recovery.on_cycle(ok, (v, w), pose, fb)
                # a successful recovery is the operator-ack equivalent:
                # without this, the safety fault latched during the outage
                # would permanently override the recovered commands
                if (ok and self.safety is not None
                        and self.safety.status.fault
                        and getattr(self.recovery.state, "value", "")
                        == "normal"):
                    self.safety.clear_fault()
        if not ok:
            self.errors += 1
            # ALWAYS publish something explicit on a failed cycle — with no
            # monitor the last nonzero command would stay latched in
            # cmd_topic (e.g. the recovery ladder's rotate command spinning
            # the robot forever after an abort)
            if self.safety is not None:
                v, w = self.safety.check(False, (v, w), info)
            else:
                v, w = 0.0, 0.0
            self.cmd_topic.publish(pack_twist(v, w))
            return
        if self.safety is not None:
            v, w = self.safety.check(True, (v, w), info)
        self.cmd_topic.publish(pack_twist(v, w))
        if info is not None and info.mpc_trajectory is not None:
            traj = np.ascontiguousarray(info.mpc_trajectory, dtype=np.float64)
            self.traj_topic.publish(traj.tobytes())
        self.cycles += 1
