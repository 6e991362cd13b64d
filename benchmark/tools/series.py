#!/usr/bin/env python3
"""Runs one cell several times, each in its own process, and summarizes
the spread of each metric: the distance between the first and third
quartiles (`statistics.quantiles(values, n=4)`) as a share of the median.

    python3 benchmark/tools/series.py --workload <cell> --seeds 11,12,13 \\
        --seconds 10 [--trace 0|1] [--out results.jsonl]

Each run's last line of standard output is appended to `--out`, with the
seed and the exit code; the summary goes to standard output.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def spread(values):
    if len(values) < 2:
        return float("nan")
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / abs(q2) if q2 else float("nan")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    rows = []
    for s in [int(x) for x in args.seeds.split(",") if x]:
        t0 = time.perf_counter()
        p = subprocess.run(
            [sys.executable, str(ROOT / "benchmark" / "run.py"),
             "--workload", args.workload, "--seed", str(s), "--seconds",
             str(args.seconds), "--trace", str(args.trace)],
            cwd=ROOT, capture_output=True, text=True)
        wall = time.perf_counter() - t0
        lines = p.stdout.strip().splitlines()
        res = None
        if p.returncode == 0 and lines:
            try:
                res = json.loads(lines[-1])
            except json.JSONDecodeError:
                res = None
        row = {"workload": args.workload, "seed": s, "rc": p.returncode,
               "wall_s": wall, "result": res,
               "log": [ln for ln in p.stderr.splitlines()
                       if ln.startswith(("set-up", "judged"))]}
        if res is None:
            row["stderr_tail"] = p.stderr[-3000:]
        rows.append(row)
        print(json.dumps({"seed": s, "rc": p.returncode, "wall_s": wall,
                          "correct": res and res["correct"],
                          "metrics": res and {k: v["value"] for k, v in
                                              res["metrics"].items()},
                          "checks": res and {k: v["value"] for k, v in
                                             res["checks"].items()}}),
              flush=True)
        if res is None:
            print(p.stderr[-3000:], flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(row) + "\n")
    ok = [r["result"] for r in rows if r["result"]]
    names = sorted({k for r in ok for k in r["metrics"]})
    summary = {}
    for k in names:
        vals = [r["metrics"][k]["value"] for r in ok if k in r["metrics"]]
        summary[k] = {"median": statistics.median(vals),
                      "spread": spread(vals), "n": len(vals)}
    print(json.dumps({"workload": args.workload, "runs": len(rows),
                      "correct": sum(bool(r["correct"]) for r in ok),
                      "summary": summary}), flush=True)
    return 0 if len(ok) == len(rows) else 1


if __name__ == "__main__":
    sys.exit(main())
