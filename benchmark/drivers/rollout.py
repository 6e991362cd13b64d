"""Closed-loop serving: `engine.receding.receding_horizon_rollout` of a
batch of robots over a few control cycles per call (the first cold, the
rest warm-started from the last solution shifted by one knot).

Traffic keys: `batch` (robots per call), `n_cycles`, `pool` (distinct
batches of initial states and paths made on the device at set-up, used in
turn), `warmup_calls`, `scenarios` (the generator's `pose_scale`,
`curve_scale`), `sample_calls` and `sample_robots` (a reservoir of calls
drawn from the seed, and in each the same seeded robots),
`trace_seconds`, `limits`.

The inputs are made before the window, so that the window's device work
is the serving loop's alone. Each call's applied controls are fetched
into pinned host memory before the next call. The window ends at the
first call completed past `--seconds`; `robot_cycles` counts robots times
cycles of every call in it.
"""

from __future__ import annotations

import random
import time
from types import SimpleNamespace

import torch

from frozen.scenarios import make_random_scenarios
from harness.core import Check, Record, program_config, subseed, sync
from reference import nlp

WINDOW = "bench.window"
SERVE = "serve.receding_horizon_rollout"


def _serve_fn():
    from mpc_ros_tpu_torch.engine import receding
    return receding


def setup(ctx):
    tr, dev = ctx.traffic, ctx.device
    params, solver, dtype = program_config(ctx.cfg, dev)
    B, C = int(tr["batch"]), int(tr["n_cycles"])
    pool = []
    for j in range(int(tr["pool"])):
        g = torch.Generator(device=dev).manual_seed(
            subseed(ctx.seed, "pool", j))
        pool.append(make_random_scenarios(g, B, dtype, **tr["scenarios"]))
    gl = torch.Generator().manual_seed(subseed(ctx.seed, "robots"))
    robots = torch.randperm(B, generator=gl)[
        :int(tr["sample_robots"])].sort().values.to(dev)
    fetched = torch.empty((C, B, 2), dtype=dtype,
                          pin_memory=dev.type == "cuda")
    st = SimpleNamespace(params=params, solver=solver, dtype=dtype,
                         pool=pool, robots=robots, fetched=fetched,
                         mod=_serve_fn())
    ctx.mark("inputs made")
    # builds K1 (the first run in a checkout) and warms the one shape
    for n in range(int(tr.get("warmup_calls", 2))):
        out = st.mod.receding_horizon_rollout(*pool[n % len(pool)], params,
                                              solver, n_cycles=C)
        fetched.copy_(out.us)
        ctx.mark(f"warm call {n} done")
    return st


def window(ctx, st, seconds):
    tr, dev, spans = ctx.traffic, ctx.device, ctx.spans
    B, C, K = int(tr["batch"]), int(tr["n_cycles"]), int(tr["sample_calls"])
    P = len(st.pool)
    rng = random.Random(subseed(ctx.seed, "calls"))
    samples = []
    warm_iters = torch.zeros((), dtype=torch.int64, device=dev)
    all_iters = torch.zeros((), dtype=torch.int64, device=dev)
    n = 0
    sync(dev)
    with spans.span(WINDOW):
        t0 = time.perf_counter()
        while True:
            j = n % P
            with spans.span(SERVE):
                tr_ = st.mod.receding_horizon_rollout(
                    *st.pool[j], st.params, st.solver, n_cycles=C)
            slot = n if n < K else rng.randrange(n + 1)
            if slot < K:
                r = st.robots
                kept = (j, tr_.zs[:, r], tr_.us[:, r], tr_.iters[:, r])
                if slot < len(samples):
                    samples[slot] = kept
                else:
                    samples.append(kept)
            if ctx.traced:
                warm_iters += tr_.iters[1:].sum()
                all_iters += tr_.iters.sum()
            with spans.span("client.fetch"):
                st.fetched.copy_(tr_.us)
            del tr_
            n += 1
            if time.perf_counter() - t0 >= seconds:
                break
        sync(dev)
        t1 = time.perf_counter()
    st.samples = samples
    # every robot-cycle is one solve (one K1 lane)
    counts = {"calls": n, "robot_cycles": n * B * C, "solves": n * B * C}
    if ctx.traced:
        counts["warm_iterations"] = int(warm_iters)
        counts["warm_solves"] = n * B * (C - 1)
        counts["lane_iterations"] = int(all_iters)
    return Record(window_s=t1 - t0, attempted=n * B * C, failed=0,
                  counts=counts)


def judge(ctx, st, rec):
    """The sampled robots' closed loops against the reference's own closed
    loop from the same initial states and paths, in float64: for each
    robot the largest gap of its plant states and of its applied controls
    over the cycles, compared at the 99th percentile over the robots, and
    the share of solves whose SQP iterations differ. (A closed loop may meet
    a solve on the edge of the stopping rule, where a start that differs
    by rounding stops early at another point: the reference, started from
    the program's own state and warm start there, stops where the program
    does. Such a robot parts from the reference's loop by a whole control,
    so the widest gap of one robot is no measure of the program.)"""
    cfg, lim, tr = ctx.cfg, ctx.traffic["limits"], ctx.traffic
    kn = nlp.Knobs.from_config(cfg)
    z0, c = [], []
    for j, *_ in st.samples:
        zi, ci = st.pool[j]
        z0.append(zi[st.robots].double())
        c.append(ci[st.robots].double())
    ref = nlp.receding(torch.cat(z0), torch.cat(c), nlp.stated_params(cfg), kn,
                       int(tr["n_cycles"]))
    pz = torch.cat([s[1] for s in st.samples], dim=1).double()
    pu = torch.cat([s[2] for s in st.samples], dim=1).double()
    pit = torch.cat([s[3] for s in st.samples], dim=1).double()
    zg = (pz - ref.zs).abs().amax(dim=(0, 2))      # per robot
    ug = (pu - ref.us).abs().amax(dim=(0, 2))
    vals = {
        "z_gap_p99": float(torch.quantile(zg, 0.99)),
        "u_gap_p99": float(torch.quantile(ug, 0.99)),
        "iters_mismatch": float((pit != ref.iters.double()).double().mean()),
    }
    ctx.log(f"judged {len(st.samples)} calls x {len(st.robots)} robots; "
            f"widest gaps z {float(zg.max())!r} u {float(ug.max())!r}")
    return [Check(k, v, float(lim[k])) for k, v in vals.items()]
