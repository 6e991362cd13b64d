#!/usr/bin/env python3
"""Run every mode of `bench_cuda.py` on one GPU, one process each, and
collect their JSON lines.

    python3 tools/bench_cuda_modes.py [OUT.jsonl] [--only NAME,...]

Writes one JSON object per mode to OUT.jsonl (default
chiprun_out/bench_cuda_modes.jsonl): the mode's name, its flags, its exit
code and seconds, and the JSON lines it printed (`--roofline` prints two).
Every mode is expected to exit 0. Prints one summary line per mode and
exits 1 if any mode did not do what it should. Needs the card (`bench_cuda.py`
without `--quick` exits non-zero without one).
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# (name, flags): the main path and its knobs, the obstacle, presort,
# smart-init, generic-engine and bicycle paths, the sweep, serving, the
# fleets and the trajectory fleet, and the grid ensemble in its three
# samplings (B=4,096, the XLA lane path), as bench.py runs them. The
# generic engine runs at B=16,384: at the default 524,288 one call takes
# ~30 s.
MODES = [
    ("main", ["--roofline"]),
    ("verify", ["--verify"]),
    ("n48_compact", ["--n-steps", "48"]),
    ("no_ddp", ["--no-ddp"]),
    ("sorted", ["--schedule", "sorted"]),
    ("obstacles", ["--obstacles"]),
    ("presort", ["--presort"]),
    ("presort_obstacles", ["--presort", "--obstacles"]),
    ("smart_init", ["--smart-init"]),
    ("vmap", ["--engine", "vmap", "--batch", "16384", "--pipeline", "2"]),
    ("bicycle", ["--model", "bicycle"]),
    ("sweep", ["--sweep"]),
    ("serving", ["--serving"]),
    ("serving_obstacles", ["--serving", "--obstacles"]),
    ("fleet_device", ["--fleet"]),
    ("fleet_device_8192", ["--fleet", "--batch", "8192"]),
    ("fleet_device_i16", ["--fleet", "--fleet-wire", "i16"]),
    ("fleet_device_obs0", ["--fleet", "--fleet-obs-every", "0"]),
    ("fleet_device_pipelined", ["--fleet", "--fleet-pipelined"]),
    ("fleet_host", ["--fleet", "--fleet-host"]),
    ("fleet_host_8192", ["--fleet", "--fleet-host", "--batch", "8192"]),
    ("fleet_host_pipelined", ["--fleet", "--fleet-host",
                              "--fleet-pipelined"]),
    ("fleet_bicycle", ["--fleet", "--model", "bicycle"]),
    ("fleet_trajectory", ["--fleet-trajectory"]),
    ("fleet_trajectory_obstacles", ["--fleet-trajectory", "--obstacles"]),
    ("obstacles_grid", ["--obstacles-grid"]),
    ("obstacles_grid_spline", ["--obstacles-grid", "--grid-sampling",
                               "spline"]),
    ("obstacles_grid_bilinear", ["--obstacles-grid", "--grid-sampling",
                                 "bilinear"]),
]
# a mode that runs longer is stopped and recorded with rc 124
MODE_TIMEOUT_S = 600


def main(argv) -> int:
    out = ROOT / "chiprun_out" / "bench_cuda_modes.jsonl"
    only = None
    args = list(argv)
    if "--only" in args:
        i = args.index("--only")
        only = set(args[i + 1].split(","))
        del args[i: i + 2]
    if args:
        out = Path(args[0])
    out.parent.mkdir(parents=True, exist_ok=True)
    bad = 0
    with open(out, "w") as f:
        for name, flags in MODES:
            if only is not None and name not in only:
                continue
            t0 = time.perf_counter()
            try:
                r = subprocess.run(
                    [sys.executable, str(ROOT / "bench_cuda.py"), *flags],
                    capture_output=True, text=True, cwd=str(ROOT),
                    timeout=MODE_TIMEOUT_S)
            except subprocess.TimeoutExpired as e:
                r = subprocess.CompletedProcess(
                    e.cmd, 124, *((b or b"").decode(errors="replace")
                                  for b in (e.stdout, e.stderr)))
            lines = [json.loads(ln) for ln in r.stdout.splitlines()
                     if ln.startswith("{")]
            rec = {"mode": name, "flags": flags, "rc": r.returncode,
                   "seconds": time.perf_counter() - t0, "lines": lines}
            ok = r.returncode == 0 and len(lines) >= 1
            if not ok:
                rec["stderr_tail"] = r.stderr[-3000:]
            rec["ok"] = ok
            bad += not ok
            f.write(json.dumps(rec) + "\n")
            f.flush()
            head = lines[0] if lines else {}
            print(json.dumps({"mode": name, "ok": ok, "rc": r.returncode,
                              "seconds": round(rec["seconds"], 1),
                              "metric": head.get("metric"),
                              "value": head.get("value")}), flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
