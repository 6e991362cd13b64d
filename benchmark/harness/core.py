"""One run of one cell: the cell's files found by name, its set-up, its
measured window, the comparison that decides `correct`, and the result.

A cell (`BENCHMARK.json`'s `workloads`) names a configuration and a
traffic mix. The configuration is `benchmark/configs/<name>.json`; the
traffic mix is `benchmark/traffic/<name>.json`, whose `entry` names the
generator that drives it (`benchmark/drivers/<entry>.py`); each metric is
`benchmark/metrics/<name>.py` with a `read(record)` that returns a number,
or None where it finds nothing to read. Adding a cell, a configuration, a
mix or a metric adds files; it edits none.

A driver module has three functions:

    setup(ctx) -> state           inputs from the seed, every shape warmed
    window(ctx, state, seconds) -> Record    the measured window
    judge(ctx, state, record) -> [Check]     after the window, against the
                                             plain reference
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import sys
import time
import zlib
from pathlib import Path
from types import SimpleNamespace

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "mpc_ros_tpu")


@dataclasses.dataclass
class Check:
    """One number compared with the reference and its limit: it passes
    while finite and no larger than the limit."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


@dataclasses.dataclass
class Record:
    """What a window leaves for the metric readers."""

    window_s: float
    attempted: int
    failed: int
    counts: dict = dataclasses.field(default_factory=dict)
    spans: object = None          # trace.Spans of the window
    trace: object = None          # trace.Trace, in a traced run
    setup_s: float = float("nan")
    cfg: dict = dataclasses.field(default_factory=dict)
    traffic: dict = dataclasses.field(default_factory=dict)


def subseed(seed: int, *tags) -> int:
    """A generator seed derived from the run's seed and a tag: stable
    across processes, below 2**63."""
    h = zlib.crc32(repr(tags).encode())
    return (int(seed) * 0x9E3779B1 + h * 0x85EBCA77 + 1) % (2 ** 63)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_spec() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def find_cell(spec: dict, workload: str) -> dict:
    for w in spec["workloads"]:
        if w["name"] == workload:
            return w
    raise SystemExit(f"run.py: no workload {workload!r} in BENCHMARK.json")


def cell_files(spec: dict, cell: dict):
    """The cell's configuration and traffic mix, read from their files."""
    conf = next(c for c in spec["configs"] if c["name"] == cell["config"])
    cfg = load_json(ROOT / conf["file"])
    traffic = load_json(BENCH_DIR / "traffic" / f"{cell['traffic']}.json")
    return cfg, traffic


def cell_metrics(spec: dict, cell: dict, traced: bool) -> list:
    """The metrics this cell reports: its end-to-end ones untraced, its
    per-layer ones traced (a metric without `workloads` is every cell's)."""
    group = spec["per_layer"] if traced else spec["end_to_end"]
    return [m for m in group
            if cell["name"] in m.get("workloads", [cell["name"]])]


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared as whole names (the port's own name begins with the JAX
    package's)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def sync(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def merged(base: dict, over: dict) -> dict:
    """`base` with `over`'s keys replaced (nested dicts merged)."""
    out = dict(base)
    for k, v in (over or {}).items():
        out[k] = merged(out[k], v) if isinstance(v, dict) and isinstance(
            out.get(k), dict) else v
    return out


def program_config(cfg: dict, device):
    """The program's parameters and solver configuration, as the
    configuration file states them."""
    import torch
    from mpc_ros_tpu_torch.config import MPCParams, SolverConfig

    dtype = getattr(torch, cfg["dtype"])
    params = MPCParams(**cfg["params"]).astype(dtype, device)
    solver = SolverConfig(**cfg["solver"])
    return params, solver, dtype


def run_cell(workload: str, seed: int, seconds: float, traced: bool,
             device, t_start: float, overrides: dict | None = None,
             spec: dict | None = None, log=None) -> dict:
    """One run: set-up, window, the reference's comparison, the metrics.
    Returns the result line's object (the caller prints it). `overrides`
    replaces keys of the configuration (`"config"`) and of the traffic
    mix (`"traffic"`): the CPU rehearsals shrink a cell with it."""
    import torch

    from .trace import Spans, Trace, profiled

    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    spec = spec or load_spec()
    cell = find_cell(spec, workload)
    cfg, traffic = cell_files(spec, cell)
    overrides = overrides or {}
    cfg = merged(cfg, overrides.get("config"))
    traffic = merged(traffic, overrides.get("traffic"))
    driver = load_module(BENCH_DIR / "drivers" / f"{traffic['entry']}.py",
                         f"bench_driver_{traffic['entry']}")
    on_device = device.type == "cuda"
    if traced:
        seconds = min(seconds, float(traffic.get("trace_seconds", seconds)))
    spans = Spans(traced)
    def mark(what):
        log(f"set-up: {what} at {time.perf_counter() - t_start:.2f} s")

    ctx = SimpleNamespace(cfg=cfg, traffic=traffic, seed=int(seed),
                          device=device, spans=spans, traced=traced,
                          log=log, mark=mark)
    mark("the driver's set-up starts")
    state = driver.setup(ctx)
    sync(device)
    setup_s = time.perf_counter() - t_start
    log(f"set-up {setup_s:.2f} s")
    with profiled(traced, on_device) as prof:
        rec = driver.window(ctx, state, seconds)
    rec.spans, rec.setup_s, rec.cfg, rec.traffic = spans, setup_s, cfg, \
        traffic
    if prof is not None:
        rec.trace = Trace.read(prof, on_device)
    peak = (torch.cuda.max_memory_allocated(device) if on_device else 0)
    metrics = {}
    for m in cell_metrics(spec, cell, traced):
        mod = load_module(BENCH_DIR / "metrics" / f"{m['name']}.py",
                          "bench_metric_" + m["name"].replace(".", "_"))
        v = mod.read(rec)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    checks = driver.judge(ctx, state, rec)
    dev = {"platform": "gpu" if on_device else "cpu",
           "kind": (torch.cuda.get_device_name(device) if on_device
                    else "cpu"),
           "count": int(cell["chips"]) if on_device else 1,
           "memory_peak_bytes": int(peak)}
    out = {"correct": bool(checks) and all(c.ok for c in checks),
           "attempted": int(rec.attempted), "failed": int(rec.failed),
           "metrics": metrics, "device": dev}
    if rec.trace is not None:
        dev["busy_s"] = rec.trace.busy_s
        dev["window_s"] = rec.trace.window_s
        out["breakdown"] = rec.trace.breakdown()
    out["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                     for c in checks}
    return out
