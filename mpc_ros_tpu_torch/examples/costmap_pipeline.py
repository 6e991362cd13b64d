"""The costmap pipeline: grid snapshot -> Gaussian blobs -> solve
(counterpart of the repository's `examples/costmap_pipeline.py`).

Three routes:

  1. `MPCPlanner.set_costmap(omap)`: a single robot; the host greedy blob
     fit installs parametric obstacles, moved into the robot frame and
     solved each cycle;
  2. `FleetPlanner.set_costmaps(omaps)`: a fleet; the batched device fit
     (`fit_gaussians_to_maps`) converts every robot's map at once;
  3. `ObstacleMap(sampling="spline").with_spline_coeffs()`: the solver
     samples the grid itself through the C1 quadratic-B-spline
     reconstruction from precomputed per-cell coefficient planes
     (re-derived on grid updates through `with_grid`); "bilinear" is the
     costmap_2d-exact C0 mode.

    python -m mpc_ros_tpu_torch.examples.costmap_pipeline [--cpu]
"""

import argparse

import numpy as np

from mpc_ros_tpu_torch.config import MPCParams, PlannerConfig, SolverConfig
from mpc_ros_tpu_torch.models.obstacles import (ObstacleMap,
                                                fit_gaussians_to_maps,
                                                gaussian_blob_map)
from mpc_ros_tpu_torch.planner import FleetPlanner, MPCPlanner
from mpc_ros_tpu_torch.planner.tracking import resolve_device
from mpc_ros_tpu_torch.sim import run_closed_loop


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    dev = resolve_device("cpu" if args.cpu else None)
    n = 120
    plan = np.stack([np.linspace(0, 6, n), np.zeros(n), np.zeros(n)], -1)
    p = MPCParams(dt=0.1, ref_vel=0.5, max_angvel=1.5,
                  w_angvel_d=10.0, w_accel_d=10.0)
    kw = dict(params=p, solver_cfg=SolverConfig(n_steps=20),
              planner_cfg=PlannerConfig(local_plan_length=2.5), device=dev)

    # a world-frame costmap snapshot with an obstacle near the plan
    omap = gaussian_blob_map((3.0, 0.2), sigma=0.3, extent=8.0, weight=50.0)

    # route 1: a single robot through the costmap door
    planner = MPCPlanner(**kw)
    planner.initialize()
    planner.set_costmap(omap)           # greedy fit + install
    res = run_closed_loop(planner, plan, max_cycles=600)
    d = np.min(np.hypot(res.poses[:, 0] - 3.0, res.poses[:, 1] - 0.2))
    print(f"single robot: reached={res.reached} "
          f"min clearance to obstacle {d:.2f} m")

    # route 2: the fleet's batched device fit
    B = 4
    omaps = ObstacleMap(
        grid=omap.grid[None].expand(B, *omap.grid.shape),
        origin=omap.origin[None].expand(B, 2),
        resolution=omap.resolution.expand(B),
        weight=omap.weight.expand(B)).to(device=dev)
    blobs = fit_gaussians_to_maps(omaps, n_blobs=4)
    print(f"fleet fit: {B} maps -> blob weights "
          f"{np.round(blobs.w[0].cpu().numpy(), 1)} (one batched fit)")
    fleet = FleetPlanner(**kw)
    fleet.initialize(B)
    poses = np.stack([plan[0]] * B)
    fleet.set_plans([plan] * B, poses)
    fleet.set_costmaps(omaps)           # the fleet's costmap door
    ok, cmds, info = fleet.compute_velocity_commands(poses, np.zeros((B, 2)))
    print(f"fleet cycle: commands {np.round(cmds[0], 3)} x{B} robots")

    # route 3: solve against the C1 spline grid directly, the coefficient
    # planes precomputed once per costmap update
    spline = ObstacleMap(grid=omap.grid, origin=omap.origin,
                         resolution=omap.resolution, weight=omap.weight,
                         sampling="spline").with_spline_coeffs()
    planner2 = MPCPlanner(**kw)
    planner2.initialize()
    planner2.set_plan(plan, plan[0].copy())
    planner2.tracker.obstacle_map = spline   # a robot-frame grid per cycle
    ok, (v, w), _ = planner2.compute_velocity_commands(plan[0].copy(),
                                                       (0.2, 0.0))
    print(f"spline-grid cycle: cmd=({v:.3f}, {w:.3f})")


if __name__ == "__main__":
    main()
