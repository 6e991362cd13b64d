"""Shared set-up of the benchmark's own tests: the paths the harness
imports from, and the tiny sizes of the CPU rehearsals (K1's plain version
stands in for the kernel: `backward="mega"`)."""

from __future__ import annotations

import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(ROOT), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)

from harness import core  # noqa: E402

SPEC = core.load_spec()

# per traffic entry: the rehearsal's sizes
TINY = {
    "batch_solve": {"batch": 256, "pool": 2, "sample_lanes": 64,
                    "sample_calls": 2, "warmup_calls": 1},
    "rollout": {"batch": 128, "sample_robots": 32, "sample_calls": 2,
                "pool": 2, "warmup_calls": 1},
}


def workloads():
    return [w["name"] for w in SPEC["workloads"]]


def entry_of(workload: str) -> str:
    cell = core.find_cell(SPEC, workload)
    return core.cell_files(SPEC, cell)[1]["entry"]


def rehearse(workload: str, seed: int = 2 ** 31 + 5, traced: bool = False,
             seconds: float = 0.3, log=lambda msg: None) -> dict:
    """One run of a cell on the CPU at its rehearsal size."""
    import torch

    over = {"config": {"solver": {"backward": "mega"}},
            "traffic": TINY[entry_of(workload)]}
    return core.run_cell(workload, seed, seconds, traced,
                         torch.device("cpu"), time.perf_counter(),
                         overrides=over, spec=SPEC, log=log)
