"""Quickstart: one NMPC solve, a solve around an obstacle and a closed-loop
course (counterpart of the repository's `examples/quickstart.py`).

    python -m mpc_ros_tpu_torch.examples.quickstart          # on the card
    python -m mpc_ros_tpu_torch.examples.quickstart --cpu
"""

import argparse

import numpy as np
import torch

from mpc_ros_tpu_torch import MPCParams, PlannerConfig, SolverConfig
from mpc_ros_tpu_torch.planner import MPCPlanner
from mpc_ros_tpu_torch.planner.tracking import resolve_device
from mpc_ros_tpu_torch.sim import infinity, run_closed_loop
from mpc_ros_tpu_torch.solver import solve_jit


def single_solve(dev):
    # robot 5 cm left of a curved path, moving at 0.3 m/s
    f32 = dict(dtype=torch.float32, device=dev)
    coeffs = torch.tensor([0.05, -0.1, 0.2, -0.02], **f32)
    z0 = torch.tensor([0, 0, 0, 0.3, 0.05, float(np.arctan(-0.1))], **f32)
    p = MPCParams(ref_vel=0.5).astype(torch.float32, dev)
    res = solve_jit(z0, coeffs, p, SolverConfig(n_steps=30))
    omega, accel = res.control.tolist()
    print(f"single solve: omega={omega:.4f} rad/s accel={accel:.4f} m/s^2 "
          f"cost={float(res.cost):.3f} iters={int(res.n_iters)}")


def solve_around_obstacle(dev):
    # a straight reference with a Gaussian obstacle just off the path: the
    # optimal trajectory bends around it
    from mpc_ros_tpu_torch.models.obstacles import GaussianObstacles
    from mpc_ros_tpu_torch.solver.ilqr import solve

    f32 = dict(dtype=torch.float32, device=dev)
    z0 = torch.tensor([0, 0, 0, 0.5, 0, 0], **f32)
    coeffs = torch.zeros((4,), **f32)
    p = MPCParams(ref_vel=0.5, w_cte=50.0).astype(torch.float32, dev)
    blobs = GaussianObstacles.from_sigmas(
        torch.tensor([0.6], **f32), torch.tensor([0.05], **f32),
        torch.tensor([0.25], **f32), torch.tensor([200.0], **f32))
    res = solve(z0, coeffs, p, SolverConfig(n_steps=20), blobs=blobs)
    ys = res.zs[:, 1].cpu().numpy()
    print(f"obstacle solve: max lateral deviation {ys.min():.3f} m "
          f"(steers around the blob at (0.6, 0.05))")


def closed_loop(dev):
    p = MPCParams(dt=0.1, ref_vel=0.5, max_angvel=1.5, w_cte=300.0,
                  w_angvel_d=10.0, w_accel_d=10.0)
    planner = MPCPlanner(params=p, solver_cfg=SolverConfig(n_steps=20),
                         planner_cfg=PlannerConfig(local_plan_length=2.5),
                         device=dev)
    res = run_closed_loop(planner, infinity(), max_cycles=1200)
    print(f"infinity course: reached={res.reached} in {res.course_time_s:.1f}"
          f" s (sim), mean|cte|={res.mean_abs_cte:.4f} m")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    dev = resolve_device("cpu" if args.cpu else None)
    single_solve(dev)
    solve_around_obstacle(dev)
    closed_loop(dev)


if __name__ == "__main__":
    main()
