"""Closed-loop simulation CLI (counterpart of `mpc_ros_tpu/sim/run.py`):

    python -m mpc_ros_tpu_torch.sim.run --shape infinity --log mpc.csv
    python -m mpc_ros_tpu_torch.sim.run --cpu --max-cycles 5

runs the planner stack against the built-in kinematic plant, prints one
JSON line and optionally writes a tracking CSV in the reference's schema.
The solves run on the card; `--cpu` runs them on the CPU. Without a card
and without `--cpu` it exits with an error.
"""

from __future__ import annotations

import argparse
import dataclasses
import json


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--shape", choices=["infinity", "epitrochoid", "square"],
                    default="infinity")
    ap.add_argument("--controller",
                    choices=["mpc", "pure_pursuit", "dwa", "trajectory"],
                    default="mpc",
                    help="'mpc': the path-tracking planner; 'trajectory': "
                         "the time-parameterized reference (a moving "
                         "point); 'pure_pursuit' and 'dwa': the baseline "
                         "controllers of the reference's A/B comparison")
    ap.add_argument("--traj-speed", type=float, default=0.4,
                    help="trajectory mode: reference speed [m/s] used to "
                         "time-parameterize the course")
    ap.add_argument("--config", type=str, default=None,
                    help="YAML config file (canonical nested schema or the "
                         "reference's flat rosparam schema, see "
                         "config_io.py); flags below override it")
    ap.add_argument("--model", choices=["diff_drive", "bicycle"],
                    default=None,
                    help="vehicle family (mpc controller only)")
    ap.add_argument("--n-steps", type=int, default=None,
                    help="MPC horizon N (default 20)")
    ap.add_argument("--dt", type=float, default=None)
    ap.add_argument("--ref-vel", type=float, default=None)
    ap.add_argument("--w-cte", type=float, default=None)
    ap.add_argument("--max-cycles", type=int, default=3000)
    ap.add_argument("--log", type=str, default=None, help="tracking CSV path")
    ap.add_argument("--realtime", action="store_true",
                    help="pace cycles with the native rate executor (not "
                         "ported)")
    ap.add_argument("--cpu", action="store_true",
                    help="run the solves on the CPU instead of the card")
    args = ap.parse_args(argv)

    import numpy as np

    from ..config import MPCParams, PlannerConfig, SolverConfig
    from ..obs import RunStats
    from ..planner import MPCPlanner
    from .shapes import get_shape
    from .simulator import run_closed_loop

    device = "cpu" if args.cpu else "cuda"

    plan = get_shape(args.shape)
    if args.config is not None:
        from ..config_io import load_config

        p, scfg, pcfg = load_config(args.config)
    else:
        # the CLI's defaults, tuned for the built-in courses (a config
        # file carries its own values)
        p = MPCParams(max_angvel=1.5, w_cte=300.0, w_angvel_d=10.0,
                      w_accel_d=10.0)
        scfg = SolverConfig(n_steps=20)
        pcfg = PlannerConfig(local_plan_length=2.5)
        if args.model == "bicycle":
            # the courses reach curvature ~1.6-2.4 1/m: steering authority
            # to match (max_steer / lf = 2.4)
            p = dataclasses.replace(p, lf=0.25, max_steer=0.6)
    # explicit flags override whichever source supplied the base config
    over = {k: v for k, v in (("dt", args.dt), ("ref_vel", args.ref_vel),
                              ("w_cte", args.w_cte)) if v is not None}
    p = dataclasses.replace(p, **over)
    if args.n_steps is not None:
        scfg = dataclasses.replace(scfg, n_steps=args.n_steps)
    if args.model is not None:
        scfg = dataclasses.replace(scfg, model=args.model)
    if args.controller == "trajectory":
        from ..planner.trajectory import TimedTrajectory, TrajectoryTracker
        from .simulator import run_trajectory_tracking

        traj = TimedTrajectory.from_path(plan, args.traj_speed)
        tracker = TrajectoryTracker(p, scfg, pcfg, device=device)
        res = run_trajectory_tracking(tracker, traj,
                                      max_cycles=args.max_cycles,
                                      log_path=args.log)
        d = res.dist_to_ref if len(res.poses) else np.zeros(1)
        out = {
            "shape": args.shape,
            "controller": "trajectory",
            "device": str(tracker.device),
            "traj_speed": args.traj_speed,
            "reached": res.reached,
            "cycles": res.n_cycles,
            "course_time_s": res.course_time_s,
            "schedule_s": round(traj.duration, 2),
            "wall_time_s": round(res.wall_time_s, 2),
            "mean_abs_cte": (round(float(np.abs(res.records[:, 1]).mean()), 4)
                             if len(res.records) else None),
            "dist_to_ref_mean_m": round(float(d.mean()), 4),
            "dist_to_ref_max_m": round(float(d.max()), 4),
            "lag_mean_m": (round(float(res.lags.mean()), 4)
                           if len(res.lags) else None),
        }
        print(json.dumps(out))
        return
    if args.controller == "mpc":
        planner = MPCPlanner(params=p, solver_cfg=scfg, planner_cfg=pcfg,
                             device=device)
    elif args.controller == "pure_pursuit":
        from ..planner import PurePursuitPlanner

        planner = PurePursuitPlanner(params=p, planner_cfg=pcfg,
                                     device=device)
    else:
        from ..planner import DWAPlanner

        planner = DWAPlanner(params=p, planner_cfg=pcfg, device=device)
    stats = RunStats()
    planner.on_cycle = stats.record_cycle
    res = run_closed_loop(planner, plan, max_cycles=args.max_cycles,
                          log_path=args.log, realtime=args.realtime)

    d = (np.array([np.min(np.hypot(plan[:, 0] - q[0], plan[:, 1] - q[1]))
                   for q in res.poses]) if len(res.poses) else np.zeros(1))
    out = {
        "shape": args.shape,
        "controller": args.controller,
        "device": str(planner.device),
        "reached": res.reached,
        "cycles": res.n_cycles,
        "course_time_s": res.course_time_s,
        "wall_time_s": round(res.wall_time_s, 2),
        "mean_abs_cte": (round(res.mean_abs_cte, 4) if len(res.records)
                         else None),
        "geo_err_mean_m": round(float(d.mean()), 4),
        "geo_err_max_m": round(float(d.max()), 4),
        **stats.summary(),
    }
    if res.rate_stats:
        out["rate"] = res.rate_stats
    print(json.dumps(out))


if __name__ == "__main__":
    main()
