"""Batch solves: `solver.batch_lane.batch_solve_lane` on whole batches of
seeded scenarios, dispatched back to back.

Traffic keys: `batch` (lanes per call), `pool` (distinct batches made on
the device at set-up, used in turn), `in_flight` (calls the host may run
ahead of the device), `warmup_calls`, `scenarios` (the generator's
`pose_scale`, `curve_scale`), `sample_calls` and `sample_lanes` (the
answers held against the reference: a reservoir of calls drawn from the
seed, and in each the same seeded lanes of its batch), `trace_seconds`,
`limits`.

The window ends at the first completed call past `--seconds` and a
synchronize; `solves` counts every lane of every call dispatched in it.
"""

from __future__ import annotations

import collections
import random
import time
from types import SimpleNamespace

import torch

from frozen.scenarios import make_random_scenarios
from harness.core import Check, Record, program_config, subseed, sync
from reference import nlp

WINDOW = "bench.window"


def _solve_fn():
    from mpc_ros_tpu_torch.solver import batch_lane
    return batch_lane


def setup(ctx):
    tr, dev = ctx.traffic, ctx.device
    params, solver, dtype = program_config(ctx.cfg, dev)
    B, P, L = int(tr["batch"]), int(tr["pool"]), int(tr["sample_lanes"])
    pool, lanes = [], []
    for j in range(P):
        g = torch.Generator(device=dev).manual_seed(
            subseed(ctx.seed, "pool", j))
        pool.append(make_random_scenarios(g, B, dtype, **tr["scenarios"]))
        gl = torch.Generator().manual_seed(subseed(ctx.seed, "lanes", j))
        lanes.append(torch.randperm(B, generator=gl)[:L].sort().values.to(
            dev))
    st = SimpleNamespace(params=params, solver=solver, pool=pool,
                         lanes=lanes, mod=_solve_fn())
    ctx.mark("inputs made")
    # builds K1 (the first run in a checkout) and warms the allocator for
    # the one shape this cell uses
    for j in range(int(tr.get("warmup_calls", 2))):
        st.mod.batch_solve_lane(*pool[j % P], params, solver)
        sync(dev)
        ctx.mark(f"warm call {j} done")
    return st


def window(ctx, st, seconds):
    tr, dev, spans = ctx.traffic, ctx.device, ctx.spans
    B, P = int(tr["batch"]), len(st.pool)
    depth = int(tr["in_flight"])
    K = int(tr["sample_calls"])
    rng = random.Random(subseed(ctx.seed, "calls"))
    on_dev = dev.type == "cuda"
    samples = []
    queue = collections.deque()
    iters = torch.zeros((), dtype=torch.int64, device=dev)
    n = 0
    sync(dev)
    with spans.span(WINDOW):
        t0 = time.perf_counter()
        while True:
            j = n % P
            with spans.span("dispatch.batch_solve_lane"):
                res = st.mod.batch_solve_lane(*st.pool[j], st.params,
                                              st.solver)
            slot = n if n < K else rng.randrange(n + 1)
            if slot < K:
                idx = st.lanes[j]
                kept = (j, n, res.us[idx], res.cost[idx],
                        res.converged[idx], res.n_iters[idx])
                if slot < len(samples):
                    samples[slot] = kept
                else:
                    samples.append(kept)
            if ctx.traced:
                iters += res.n_iters.sum()
            del res
            n += 1
            if on_dev:
                ev = torch.cuda.Event()
                ev.record()
                queue.append(ev)
                if len(queue) > depth:
                    queue.popleft().synchronize()
            if time.perf_counter() - t0 >= seconds:
                break
        sync(dev)
        t1 = time.perf_counter()
    st.samples = samples
    counts = {"calls": n, "solves": n * B}
    if ctx.traced:
        counts["lane_iterations"] = int(iters)
    return Record(window_s=t1 - t0, attempted=n * B, failed=0,
                  counts=counts)


def judge(ctx, st, rec):
    """The sampled answers against the reference's solve of the same lanes
    in float64: the shares of lanes whose iterations or converged flag
    differ, each lane's largest control gap and its cost gap to the
    reference's answer at the 99th percentile over the lanes, and the
    largest gap between a reported cost and the reference's cost of the
    program's own controls. (About one lane in 200,000 sits on the edge of
    the stopping rule, where float32 rounding stops it at another point
    than float64: its controls part by up to a whole control, so the
    widest gap of one lane is no measure of the program.)"""
    dev, cfg, lim = ctx.device, ctx.cfg, ctx.traffic["limits"]
    kn = nlp.Knobs.from_config(cfg)
    params = nlp.stated_params(cfg)
    used = sorted({s[0] for s in st.samples})
    inputs = {j: tuple(a[st.lanes[j]].double() for a in st.pool[j])
              for j in used}
    st.pool = None
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    z0 = torch.cat([inputs[j][0] for j in used])
    c = torch.cat([inputs[j][1] for j in used])
    ref = nlp.solve(z0, c, params, kn)
    L = len(st.lanes[0])
    at = {j: i * L for i, j in enumerate(used)}
    smp = st.samples
    pus = torch.cat([s[2].reshape(L, -1) for s in smp]).double()
    pcost, pconv, piters = (torch.cat([s[k] for s in smp]).double()
                            for k in (3, 4, 5))
    sel = torch.cat([torch.arange(L, device=dev) + at[s[0]] for s in smp])
    rus = ref.us.reshape(len(ref.us), -1)[sel]
    rcost, rconv, riters = (ref.cost[sel], ref.converged[sel].double(),
                            ref.iters[sel].double())
    wscl = nlp.Params(params, torch.float64, dev, 1).wscl
    J = nlp.evaluate(z0[sel], pus.reshape(len(pus), kn.T, 2), c[sel],
                     params, kn)
    du = (pus - rus).abs().amax(dim=1)                 # per lane
    cg = (pcost - rcost).abs() / (wscl + rcost.abs())
    vals = {
        "iters_mismatch": float((piters != riters).double().mean()),
        "conv_mismatch": float((pconv != rconv).double().mean()),
        "du_p99": float(torch.quantile(du, 0.99)),
        "cost_gap_p99": float(torch.quantile(cg, 0.99)),
        "cost_self_gap": float(((pcost - J).abs()
                                / (wscl + J.abs())).max()),
    }
    ctx.log(f"judged {len(st.samples)} calls x {L} lanes; widest gaps "
            f"du {float(du.max())!r} cost {float(cg.max())!r}")
    return [Check(k, v, float(lim[k])) for k, v in vals.items()]
