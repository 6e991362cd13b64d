#!/usr/bin/env python3
"""The benchmark of `mpc_ros_tpu_torch` on NVIDIA GPUs: one run of one
cell of `BENCHMARK.json`.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Run from the root of a checkout. It makes the cell's inputs on the card
from the seed, builds and warms every shape the cell uses (set-up), runs
the traffic for `--seconds`, holds what the timed path produced against
the plain reference in `benchmark/reference/`, and prints, as the last
line of standard output, one JSON object: `correct`, `attempted`,
`failed`, `metrics` (the cell's end-to-end metrics; with `--trace 1` its
per-layer metrics, read from a profiler trace of the window), `device`,
with `--trace 1` a `breakdown`, and last `checks`, each number compared
with its limit (also the last lines of standard error).

It exits non-zero and prints no result without a CUDA device, with fewer
devices than the cell asks for, when the program is not beside it, or
when JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# every build and kernel cache in the checkout, at fixed paths (K1's own
# builds go to build/kernels/, fixed by the program)
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton"),
                 ("PYTORCH_KERNEL_CACHE_PATH", "torch_kernels"),
                 ("CUDA_CACHE_PATH", "cuda")):
    os.environ[var] = str(ROOT / "build" / "bench_cache" / sub)
os.environ.setdefault("OMP_NUM_THREADS", "2")
os.environ["USE_FLAX"] = "0"
sys.path.insert(0, str(ROOT))


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=[0, 1], default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    from harness import core

    if not (ROOT / "BENCHMARK.json").is_file() or not (
            ROOT / "mpc_ros_tpu_torch").is_dir():
        print("run.py: no program here: run from the root of a checkout "
              "that holds BENCHMARK.json and mpc_ros_tpu_torch/",
              file=sys.stderr)
        return 2
    spec = core.load_spec()
    cell = core.find_cell(spec, args.workload)
    import torch

    print(f"set-up: torch imported at {time.perf_counter() - T_START:.2f} s",
          file=sys.stderr)
    if not torch.cuda.is_available():
        print("run.py: no CUDA device", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < int(cell["chips"]):
        print(f"run.py: the cell needs {cell['chips']} devices, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    torch.set_num_threads(2)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = core.run_cell(args.workload, args.seed, args.seconds,
                        bool(args.trace), torch.device("cuda", 0), T_START,
                        spec=spec)
    found = core.forbidden_modules()
    if found:
        print(f"run.py: loaded {', '.join(found)}", file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
