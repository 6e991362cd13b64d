"""Closed-loop obstacle avoidance with world-frame parametric obstacles
(counterpart of the repository's `examples/obstacle_navigation.py`).

A Gaussian obstacle sits on the global plan; each Tracking cycle moves the
world-frame blobs into the robot frame (`MPCPlanner.set_obstacles`) and
the trajectory optimization swerves around them while it tracks the path.

    python -m mpc_ros_tpu_torch.examples.obstacle_navigation [--cpu]
"""

import argparse

import numpy as np
import torch

from mpc_ros_tpu_torch.config import MPCParams, PlannerConfig, SolverConfig
from mpc_ros_tpu_torch.models.obstacles import GaussianObstacles
from mpc_ros_tpu_torch.planner import MPCPlanner
from mpc_ros_tpu_torch.sim import run_closed_loop


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    # a straight 6 m course; two blobs on or near it
    x = np.linspace(0.0, 6.0, 120)
    plan = np.stack([x, np.zeros_like(x), np.zeros_like(x)], -1)
    f64 = dict(dtype=torch.float64)
    blobs = GaussianObstacles.from_sigmas(
        cx=torch.tensor([2.0, 4.0], **f64), cy=torch.tensor([0.05, -0.1], **f64),
        sigma=torch.tensor([0.3, 0.25], **f64),
        w=torch.tensor([50.0, 50.0], **f64))

    p = MPCParams(dt=0.1, ref_vel=0.5, max_angvel=1.5,
                  w_angvel_d=10.0, w_accel_d=10.0)
    planner = MPCPlanner(params=p, solver_cfg=SolverConfig(n_steps=20),
                         planner_cfg=PlannerConfig(local_plan_length=2.5),
                         device="cpu" if args.cpu else None)
    planner.initialize()
    planner.set_obstacles(blobs)

    res = run_closed_loop(planner, plan, max_cycles=900)
    assert res.reached, "goal not reached"

    cx, cy = blobs.cx.numpy(), blobs.cy.numpy()
    for k in range(len(cx)):
        d = np.hypot(res.poses[:, 0] - cx[k], res.poses[:, 1] - cy[k])
        print(f"blob {k} at ({cx[k]:.1f}, {cy[k]:+.2f}): "
              f"closest approach {d.min():.3f} m")
    dev = np.abs(res.poses[:, 1])
    print(f"course done in {res.n_cycles} cycles "
          f"({res.course_time_s:.1f} s); max lateral excursion "
          f"{dev.max():.3f} m; mean |cte| {res.mean_abs_cte:.4f}")


if __name__ == "__main__":
    main()
