#!/usr/bin/env python3
"""The readings a cell's limits are set from, in one process on the
card: the compared numbers of the program's runs on many seeds (the lower
readings: the largest over the seeds), and of its control, the plain
reference in bfloat16 put in the program's place (`reference.control`;
the upper readings: the smallest over the seeds), each at the cell's own
size with a short window.

    python3 benchmark/tools/readings.py --workload <cell> \\
        --seeds 1,2,...,12 --control-seeds 21,22,23 --seconds 3

One JSON line per run, then a summary line. The limits in the traffic
file are ignored here: only the numbers are read.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(BENCH))
sys.path.insert(1, str(BENCH.parent))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    import torch

    from harness import core
    from harness.controls import control_for

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    spec = core.load_spec()
    cell = core.find_cell(spec, args.workload)
    cfg, traffic = core.cell_files(spec, cell)
    entry = traffic["entry"]
    seen = {"program": {}, "control": {}}
    runs = [("program", s) for s in args.seeds.split(",") if s] + [
        ("control", s) for s in args.control_seeds.split(",") if s]
    for kind, s in runs:
        ctl = (control_for(entry, cfg) if kind == "control"
               else contextlib.nullcontext())
        with ctl:
            t0 = time.perf_counter()
            out = core.run_cell(args.workload, int(s), args.seconds, False,
                                dev, t0, spec=spec)
        vals = {k: v["value"] for k, v in out["checks"].items()}
        for k, v in vals.items():
            seen[kind].setdefault(k, []).append(v)
        print(json.dumps({"kind": kind, "seed": int(s), "checks": vals,
                          "attempted": out["attempted"],
                          "metrics": {k: v["value"] for k, v in
                                      out["metrics"].items()}}), flush=True)
        torch.cuda.empty_cache()
    summary = {k: {"program_max": max(v),
                   "control_min": min(seen["control"].get(k, [float("nan")]))}
               for k, v in seen["program"].items()}
    print(json.dumps({"workload": args.workload, "summary": summary}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
