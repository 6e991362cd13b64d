"""Serve a robot fleet with the whole per-cycle pipeline on the device
(counterpart of the repository's `examples/fleet_serving.py`).

`DeviceFleetPlanner` runs the plan cutoff, lookahead window, goal latches
and driving FSM, downsampling, robot-frame polynomial fit, error-state
extraction, reference-speed scheduling, delay-mode prediction, the warm-
started solve and command extraction on the device; the host uploads the
fleet's world state and fetches the commands once per cycle.

    python -m mpc_ros_tpu_torch.examples.fleet_serving [--cpu]

Reference analog: one move_base process per robot, each re-taping its NLP
every cycle (mpc_ros's src/mpc_planner_ros.cpp:397-448).
"""

import argparse

import numpy as np

from mpc_ros_tpu_torch.config import MPCParams, PlannerConfig, SolverConfig
from mpc_ros_tpu_torch.planner import DeviceFleetPlanner
from mpc_ros_tpu_torch.sim import get_shape


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    B = 32                           # fleet size
    base = get_shape("infinity")
    plans = []
    for i in range(B):
        pl = base.copy()
        pl[:, :2] += 5.0 * (i % 8), 5.0 * (i // 8)
        plans.append(pl)

    fp = DeviceFleetPlanner(
        params=MPCParams(max_angvel=1.5, w_cte=300.0,
                         w_angvel_d=10.0, w_accel_d=10.0),
        solver_cfg=SolverConfig(n_steps=20, ls_iters=4, ddp=True),
        planner_cfg=PlannerConfig(local_plan_length=2.5),
        obs_every=5,                 # full observability every 5th cycle
        device="cpu" if args.cpu else None,
    )
    fp.initialize(B)
    poses = np.stack([pl[0] for pl in plans]).astype(float)
    feedback = np.zeros((B, 2))
    assert fp.set_plans(plans, poses).all()

    dt = 0.1
    for cycle in range(40):
        ok, cmds, info = fp.compute_velocity_commands(poses, feedback)
        # a toy plant (a deployment feeds robot odometry)
        v, w = cmds[:, 0], cmds[:, 1]
        poses[:, 0] += dt * v * np.cos(poses[:, 2])
        poses[:, 1] += dt * v * np.sin(poses[:, 2])
        poses[:, 2] += dt * w
        feedback = cmds.copy()
        if cycle % 5 == 0:           # an observability cycle
            tracking = (info.states == 0).sum()
            print(f"cycle {cycle:3d}: tracking {tracking}/{B}, "
                  f"mean|cte| {np.nanmean(np.abs(info.cte)):.3f} m, "
                  f"conv {info.converged.mean():.2f}")
    done = fp.is_goal_reached(poses, feedback)
    print(f"after 40 cycles: {done.sum()}/{B} at goal (long course: "
          f"expected 0), mean speed {feedback[:, 0].mean():.2f} m/s")


if __name__ == "__main__":
    main()
