"""Three-controller A/B benchmark: NMPC vs DWA vs Pure Pursuit
(counterpart of `mpc_ros_tpu/sim/compare.py`).

Regenerates the reference's benchmark artifact (its
assets/{mpc,dwa,pure_pursuit}.csv) with the built-in controllers on the
built-in courses:

    python -m mpc_ros_tpu_torch.sim.compare --shape infinity --out-dir out
    python -m mpc_ros_tpu_torch.sim.compare --cpu --max-cycles 60

writes the three CSVs in the reference schema and prints one comparison
table (course time, cycles, mean/max |cte|, mean speed), plus a JSON line
for tooling. The controllers run on the card; `--cpu` runs them on the
CPU, and without a card and without `--cpu` it exits with an error.
"""

from __future__ import annotations

import argparse
import json
import os


def run_one(kind: str, shape: str, *, n_steps: int, dt: float,
            ref_vel: float, max_cycles: int, log_path=None, device=None,
            dtype=None):
    """One controller ("mpc", "pure_pursuit" or "dwa") over one course:
    the summary row. `device` and `dtype` go to the planner (its defaults:
    the card, float32)."""
    import numpy as np

    from ..config import MPCParams, PlannerConfig, SolverConfig
    from ..planner import DWAPlanner, MPCPlanner, PurePursuitPlanner
    from .shapes import get_shape
    from .simulator import run_closed_loop

    plan = get_shape(shape)
    p = MPCParams(dt=dt, ref_vel=ref_vel, max_angvel=1.5, w_cte=300.0,
                  w_angvel_d=10.0, w_accel_d=10.0)
    pcfg = PlannerConfig(local_plan_length=2.5)
    kw = {"device": device}
    if dtype is not None:
        kw["dtype"] = dtype
    if kind == "mpc":
        planner = MPCPlanner(params=p, solver_cfg=SolverConfig(n_steps=n_steps),
                             planner_cfg=pcfg, **kw)
    elif kind == "pure_pursuit":
        planner = PurePursuitPlanner(params=p, planner_cfg=pcfg, **kw)
    else:
        planner = DWAPlanner(params=p, planner_cfg=pcfg, **kw)
    res = run_closed_loop(planner, plan, max_cycles=max_cycles,
                          log_path=log_path)
    d = (np.array([np.min(np.hypot(plan[:, 0] - q[0], plan[:, 1] - q[1]))
                   for q in res.poses]) if len(res.poses) else np.zeros(1))
    v_cmd = res.records[:, 3] if len(res.records) else np.zeros(1)
    return {
        "controller": kind,
        "reached": res.reached,
        "cycles": res.n_cycles,
        "course_time_s": round(res.course_time_s, 2),
        "mean_abs_cte": round(float(np.mean(np.abs(res.records[:, 1]))), 4)
        if len(res.records) else None,
        "max_abs_cte": round(float(np.max(np.abs(res.records[:, 1]))), 4)
        if len(res.records) else None,
        "geo_err_mean_m": round(float(d.mean()), 4),
        "geo_err_max_m": round(float(d.max()), 4),
        "mean_speed": round(float(np.mean(v_cmd)), 3),
        "max_speed": round(float(np.max(v_cmd)), 3),
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--shape", choices=["infinity", "epitrochoid", "square"],
                    default="infinity")
    ap.add_argument("--n-steps", type=int, default=20)
    ap.add_argument("--dt", type=float, default=0.1)
    ap.add_argument("--ref-vel", type=float, default=0.5)
    ap.add_argument("--max-cycles", type=int, default=3000)
    ap.add_argument("--out-dir", type=str, default=None,
                    help="write {mpc,dwa,pure_pursuit}.csv here")
    ap.add_argument("--reference-assets", type=str, default=None,
                    help="directory with the reference's benchmark CSVs "
                         "(its assets/) — appends their stats rows for "
                         "side-by-side context; note the reference course "
                         "differs from the built-in ones")
    ap.add_argument("--cpu", action="store_true",
                    help="run the controllers on the CPU instead of the card")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else None

    if args.out_dir:
        os.makedirs(args.out_dir, exist_ok=True)

    rows = []
    for kind in ("mpc", "dwa", "pure_pursuit"):
        log = (os.path.join(args.out_dir, f"{kind}.csv")
               if args.out_dir else None)
        rows.append(run_one(kind, args.shape, n_steps=args.n_steps,
                            dt=args.dt, ref_vel=args.ref_vel,
                            max_cycles=args.max_cycles, log_path=log,
                            device=device))

    if args.reference_assets:
        import numpy as np

        from .logger import read_tracking_csv

        for kind in ("mpc", "dwa", "pure_pursuit"):
            path = os.path.join(args.reference_assets, f"{kind}.csv")
            if not os.path.exists(path):
                continue
            rec, course_time = read_tracking_csv(path)
            if not len(rec):
                continue
            rows.append({
                "controller": f"ref:{kind}",
                "reached": True,
                "cycles": len(rec),
                "course_time_s": (round(course_time, 2)
                                  if course_time == course_time else None),
                "mean_abs_cte": round(float(np.mean(np.abs(rec[:, 1]))), 4),
                "max_abs_cte": round(float(np.max(np.abs(rec[:, 1]))), 4),
                "geo_err_mean_m": None,   # reference logged cte only
                "geo_err_max_m": None,
                "mean_speed": round(float(np.mean(rec[:, 3])), 3),
                "max_speed": round(float(np.max(rec[:, 3])), 3),
            })

    cols = ["controller", "reached", "cycles", "course_time_s",
            "mean_abs_cte", "max_abs_cte", "geo_err_mean_m", "geo_err_max_m",
            "mean_speed", "max_speed"]
    widths = [max(len(c), *(len(str(r[c])) for r in rows)) for c in cols]
    print(" | ".join(c.ljust(w) for c, w in zip(cols, widths)))
    print("-+-".join("-" * w for w in widths))
    for r in rows:
        print(" | ".join(str(r[c]).ljust(w) for c, w in zip(cols, widths)))
    print(json.dumps({"shape": args.shape, "results": rows}))


if __name__ == "__main__":
    main()
