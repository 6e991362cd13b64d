#!/usr/bin/env python3
"""Compare the whole-solve kernel (K1) of this checkout with another tree's,
on one GPU: do the variants both trees build compile to the same machine
code, and does `chip_smoke.py`'s phase 9 (N=48, seed 6, B=131,072: the
per-block exit cold, then the resumed pass) give the same outputs bit for
bit on both sides?

    git archive <commit> | tar -x -C build/other     # build/ is ignored
    python3 tools/compare_k1_builds.py build/other
    python3 tools/compare_k1_builds.py --timing build/other [build/more ...]
    python3 tools/compare_k1_builds.py --timing --only k5 build/other ...

Each tree runs in its own process (both import the package by the same
name) and leaves its outputs under $TMPDIR; the SASS of each variant is
read with the CUDA toolkit's cuobjdump, without its addresses and
encodings. A change that adds template options to K1 must leave the
variants without them identical: NVPTX's choice of which a*b + c to fuse
depends on the instruction order around it, so moving shared code changes
the rounding. Prints one line per comparison and exits 1 on a difference.

`--timing` times this tree's K1 against one or more other trees' in one
run on one card, on the same inputs: the N=30 main path (B=524,288), the
setpoint-profile path (B=524,288), and both compact passes of the
obstacle path (N=30, B=524,288, K=4) and of the N=48 path (B=131,072),
each the median of `LAUNCHES` launches with the SM clock and power
before and after (`chip_smoke.device_window`), the trees run in turns (the
others, this, this, the others in reverse). It then holds this tree's
outputs against each other's under `chip_smoke.py`'s gates (the
single-pass rule; the compact rule for the compact schedules, with
acceptance ties apart on the obstacle path), since a redesign changes the
machine code on purpose. Exits 1 on a broken gate.

The timing also holds the line-search kernel (K5, case `k5`): each tree
runs the two-kernel route at B=524,288 (`chip_smoke.py`'s phase-7 shape)
with the plain stages, so every tree sees the same inputs, and times its
own K5 on the inputs of each of the 12 iterations; per tree run the
median of each iteration and their sum per route solve. This tree's
outputs on iterations 1, 4, 8 and 12 (every 16th lane) are held against
each other tree's at phase 6's rule (`chip_smoke.acceptance`,
`lanes_within`). `--only CASE,...` times only the cases named (n30,
setpoints, blobs, n48, k5).
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile
from pathlib import Path

# the variants phase 9 launches: (n_ls, ddp, fast, adaptive, tile_exit)
VARIANTS = [(4, True, True, True, True), (4, True, True, True, False)]
FIELDS = {1: "us", 2: "cost", 3: "conv", 4: "iters", 6: "mu", 7: "done"}


def run_tree(root: str, out: str) -> None:
    """In a child process: phase 9's comparisons on `root`'s package, the
    kernel and plain outputs saved to `out`, and each variant's library."""
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs
    from mpc_ros_tpu_torch.kernels import _build, solve_mega

    assert Path(cs.__file__).resolve().parent == Path(root).resolve()
    cs.CARD = cs.card_line()
    dev = torch.device("cuda", 0)
    saved = {}
    for variant, rec, (_, _, _, o_k, o_p) in cs.long_variants(
            dev, cs.B_LONG, cs.LONG_SEED, gate=False):
        print(f"{root}: {variant} gates ok {rec['ok']} max du "
              f"{rec['max_du']}", flush=True)
        for side, o in (("kernel", o_k), ("plain", o_p)):
            for i, f in FIELDS.items():
                saved[f"{variant}.{side}.{f}"] = o[i].cpu()
    # the tree's own variant tuple: the leading flags, and the later
    # options off
    width = len(solve_mega.resolve_knobs(cs.LONG, torch.float32).variant)
    saved["libs"] = {
        str(v): str(_build.lib_path("solve_mega",
                                    v + (False,) * (width - len(v))))
        for v in VARIANTS}
    torch.save(saved, out)


# --timing: launches per timed window, and the cases: (case, config name
# in chip_smoke, seed, batch, blobs per lane,
# setpoint profile, compact)
LAUNCHES = 5
CASES = [("n30", "PROD", 1, "B_MAIN", 0, False, False),
         ("setpoints", "PROD", 19, "B_MAIN", 0, True, False),
         ("blobs", "OBST", 16, "B_MAIN", 4, False, True),
         ("n48", "LONG", 7, "B_LONG", 0, False, True)]
# K5: the route's seed (phase 7), the iterations whose outputs are held
# against each other tree's, and the lane stride of that sample
K5_SEED = 4
K5_HELD = (1, 4, 8, 12)
K5_STRIDE = 16


def k5_case(cs, window) -> dict:
    """In a tree's process: its K5 timed on the inputs of each iteration of
    the route at B=524,288, the route run with the plain stages (the same
    inputs for every tree), and its outputs on K5_HELD (every K5_STRIDE-th
    lane, with the cost before the step and act)."""
    import torch

    from mpc_ros_tpu_torch.kernels import backward_fused, forward
    from mpc_ros_tpu_torch.solver.batch_lane import (LaneSQP,
                                                     two_kernel_stages)

    dev = torch.device("cuda", 0)
    z0s, coeffs = cs.scenarios(K5_SEED, cs.B_MAIN, dev)
    sqp = LaneSQP(z0s, coeffs, cs.params(cs.B_MAIN, dev, False), cs.ROUTE,
                  two_kernel=two_kernel_stages(plain=True))
    ms, outs, act = {}, {}, {}
    for it in range(1, cs.ROUTE.max_sqp_iters + 1):
        bp = backward_fused.backward_fused_plain(*sqp.backward_inputs())
        fi = sqp.forward_inputs(bp[0], bp[1])
        ms[f"it{it}"] = window(
            lambda: forward.forward_cuda(*fi, n_alpha=cs.N_ALPHA))
        act[it] = float(fi[10].mean())
        if it in K5_HELD:
            fk = forward.forward_cuda(*fi, n_alpha=cs.N_ALPHA)
            outs[it] = [o[..., ::K5_STRIDE].cpu()
                        for o in list(fk) + [fi[9], fi[10]]]
        del bp, fi
        sqp.step()
    return {"ms": ms, "act_frac": act, "outs": outs}


def k5_gates(this: dict, other: dict) -> dict:
    """This tree's K5 outputs against another's on K5_HELD, at phase 6's
    rule: acceptance on all lanes at iteration 1 and on active lanes (or
    a tie) later, trajectories and costs within LANE_TOL on >= LANE_FRAC of
    the lanes whose acceptance agrees."""
    import chip_smoke as cs

    rec = {"ok": True}
    for it in K5_HELD:
        a, b = this["outs"][it], other["outs"][it]
        acc = cs.acceptance(a, b, a[4], a[5])
        agree = acc.pop("agree")
        within = float(cs.lanes_within(
            [(x[..., agree], y[..., agree]) for x, y in zip(a[:3], b[:3])],
            cs.LANE_TOL).float().mean())
        gate = acc["all_lanes"] if it == 1 else acc["active_agree_or_tie"]
        ok = min(gate, within) >= cs.LANE_FRAC
        rec[f"it{it}"] = {"acceptance": acc, "lanes_within": within,
                          "ok": ok}
        rec["ok"] &= ok
    return rec


def make_inputs(path: str, only: list) -> None:
    """The --timing K1 cases' inputs, made once by this tree's chip_smoke
    helpers and saved for both trees."""
    import torch

    import chip_smoke as cs
    from mpc_ros_tpu_torch.solver.batch_lane import lane_inputs

    dev = torch.device("cuda", 0)
    saved = {}
    for name, cfg_name, seed, b_name, K, refs, _ in CASES:
        if name not in only:
            continue
        cfg, B = getattr(cs, cfg_name), getattr(cs, b_name)
        z0s, coeffs = cs.scenarios(seed, B, dev)
        ins = lane_inputs(z0s, coeffs, cs.params(B, dev, False), cfg)
        saved[name] = {
            "cfg": cfg, "ins": [a.cpu() for a in ins],
            "blobs": (None if not K else [
                b.cpu() for b in cs.blob_field(seed, B, K, dev).lane()]),
            "refs": (None if not refs else cs.lane_major(
                cs.ramp_refs(seed, B, cfg.n_steps, dev)).cpu())}
    torch.save(saved, path)


def time_tree(root: str, inputs: str, out: str, only: list) -> None:
    """In a child process: `root`'s K1 on the saved inputs, each case's
    launches timed (per pass for the compact cases) by this tree's
    `chip_smoke.device_window` and its outputs saved. Uses only the
    package API both trees share."""
    sys.path.insert(0, root)
    import importlib.util

    import torch

    from mpc_ros_tpu_torch.kernels import _build, solve_mega

    assert Path(solve_mega.__file__).resolve().is_relative_to(
        Path(root).resolve())
    # this tree's timing window, over `root`'s package
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_here", Path(__file__).resolve().parents[1]
        / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    dev = torch.device("cuda", 0)
    data = torch.load(inputs, weights_only=False)
    cases = []
    for name, _, _, _, K, refs, compact in CASES:
        if name not in only:
            continue
        cfg = data[name]["cfg"]
        cfgs = ([solve_mega.compact_pass1_cfg(cfg), cfg] if compact
                else [cfg])
        # the tail resolves the pass-2 knobs (the long-horizon pair)
        cases.append((name, cfg, cfgs, K, refs, compact))
    pairs = {("forward", (cs.N_ALPHA,))} if "k5" in only else set()
    for _, cfg, cfgs, K, refs, compact in cases:
        for c in cfgs:
            pairs.add(("solve_mega", solve_mega.resolve_knobs(
                c, torch.float32, n_blobs=K, has_setp=refs).variant))
    _build.build_many(sorted(pairs))

    def window(fn) -> dict:
        return cs.device_window(fn, LAUNCHES)

    res = {}
    for name, cfg, cfgs, K, refs, compact in cases:
        d = data[name]
        ins = [a.to(dev) for a in d["ins"]]
        blobs = None if d["blobs"] is None else [b.to(dev)
                                                 for b in d["blobs"]]
        rf = None if d["refs"] is None else d["refs"].to(dev)
        ms = {}
        if compact:
            p1 = cfgs[0]
            ms["pass1"] = window(lambda: solve_mega.solve_mega_cuda(
                *ins, p1, blobs=blobs, refs=rf))
            out1 = solve_mega.solve_mega_cuda(*ins, p1, blobs=blobs, refs=rf)
            tail = solve_mega.compact_tail(ins, out1, cfg, blobs, rf)
            ms["tail"] = window(lambda: solve_mega.solve_mega_cuda(
                *tail.ins, tail.cfg, resume=tail.resume, blobs=tail.blobs,
                refs=tail.refs))
            outs = solve_mega.solve_mega_scheduled(*ins, cfg, blobs=blobs,
                                                   refs=rf)
        else:
            ms["kernel"] = window(lambda: solve_mega.solve_mega_cuda(
                *ins, cfg, blobs=blobs, refs=rf))
            outs = solve_mega.solve_mega_cuda(*ins, cfg, blobs=blobs,
                                              refs=rf)
        torch.cuda.synchronize()
        print(f"{root}: {name} median ms "
              f"{ {k: w['median_ms'] for k, w in ms.items()} }", flush=True)
        res[name] = {"ms": ms, "n_steps": cfg.n_steps,
                     "outs": [None] + [o.cpu() for o in outs[1:]]}
    if "k5" in only:
        res["k5"] = k5_case(cs, window)
        print(f"{root}: k5 median ms per route solve "
              f"{sum(w['median_ms'] for w in res['k5']['ms'].values())}",
              flush=True)
    torch.save(res, out)


def timing(others: list, only: list) -> int:
    """--timing: this tree and the others in turns on the same inputs
    (the others, this, this, the others in reverse), then this tree's
    outputs held against each other tree's at chip_smoke's gates."""
    import torch

    here = str(Path(__file__).resolve().parents[1])
    sys.path.insert(0, here)
    import chip_smoke as cs

    cs.CARD = cs.card_line()
    print(cs.CARD, flush=True)
    tmp = tempfile.mkdtemp()
    inputs = os.path.join(tmp, "inputs.pt")
    subprocess.run([sys.executable, __file__, "--make-inputs", inputs,
                    ",".join(only)], check=True)
    trees = [(f"other{i}", o) for i, o in enumerate(others)]
    order = trees + [("this", here)] * 2 + trees[::-1]
    runs = []
    for n, (name, root) in enumerate(order):
        out = os.path.join(tmp, f"{n}.pt")
        subprocess.run([sys.executable, __file__, "--time-tree",
                        os.path.abspath(root), inputs, out, ",".join(only)],
                       check=True)
        runs.append((name, torch.load(out, weights_only=False)))
    broke = False
    for case, _, _, _, K, _, compact in CASES:
        if case not in only:
            continue
        times, clocks = {}, {}
        for name, r in runs:
            for part, w in r[case]["ms"].items():
                times.setdefault(f"{name}.{part}", []).append(w["median_ms"])
                clocks.setdefault(f"{name}.{part}", []).append(
                    {k: w[k] for k in ("min_ms", "max_ms", "sm_mhz",
                                       "power_w")})
        this = dict(runs)["this"][case]
        gates = {}
        for name, root in trees:
            g = cs.outputs_gates(this["outs"], dict(runs)[name][case]["outs"],
                                 this["n_steps"], compact, ties=K > 0)
            broke |= not g["ok"]
            gates[root] = g
        cs.emit("k1_timing", case=case, trees=dict(trees),
                median_ms=times, windows=clocks, gates_this_vs_other=gates)
    if "k5" in only:
        per_solve, times, clocks = {}, {}, {}
        for name, r in runs:
            k5 = r["k5"]
            per_solve.setdefault(name, []).append(
                sum(w["median_ms"] for w in k5["ms"].values()))
            for it, w in k5["ms"].items():
                times.setdefault(f"{name}.{it}", []).append(w["median_ms"])
                clocks.setdefault(f"{name}.{it}", []).append(
                    {k: w[k] for k in ("min_ms", "max_ms", "sm_mhz",
                                       "power_w")})
        this = dict(runs)["this"]["k5"]
        gates = {}
        for name, root in trees:
            g = k5_gates(this, dict(runs)[name]["k5"])
            broke |= not g["ok"]
            gates[root] = g
        cs.emit("k5_timing", trees=dict(trees), act_frac=this["act_frac"],
                ms_per_route_solve=per_solve, median_ms=times,
                windows=clocks, gates_this_vs_other=gates)
    return 1 if broke else 0


def sass(lib: str) -> list:
    cuobjdump = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                     "bin", "cuobjdump")
    text = subprocess.run([str(cuobjdump), "-sass", lib], check=True,
                          capture_output=True, text=True).stdout
    # instruction lines: "/*0040*/  FFMA R3, R2, R5, R4 ;  /* 0x... */"
    return [ln.split("*/", 1)[1].split(";")[0].strip()
            for ln in text.splitlines() if ln.strip().startswith("/*")]


def main(argv) -> int:
    if len(argv) == 3 and argv[0] == "--tree":
        run_tree(argv[1], argv[2])
        return 0
    if len(argv) == 3 and argv[0] == "--make-inputs":
        sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
        make_inputs(argv[1], argv[2].split(","))
        return 0
    if len(argv) == 5 and argv[0] == "--time-tree":
        time_tree(*argv[1:4], argv[4].split(","))
        return 0
    if len(argv) >= 2 and argv[0] == "--timing":
        only = [c[0] for c in CASES] + ["k5"]
        if argv[1] == "--only":
            only, argv = argv[2].split(","), argv[2:]
        return timing(argv[1:], only)
    if len(argv) != 1:
        raise SystemExit("usage: compare_k1_builds.py OTHER_TREE | "
                         "--timing [--only CASE,...] OTHER_TREE "
                         "[OTHER_TREE ...]")
    import torch

    here = str(Path(__file__).resolve().parents[1])
    tmp = tempfile.mkdtemp()
    outs = {}
    for name, root in (("other", argv[0]), ("this", here)):
        outs[name] = os.path.join(tmp, f"{name}.pt")
        subprocess.run([sys.executable, __file__, "--tree",
                        os.path.abspath(root), outs[name]], check=True)
    a, b = (torch.load(outs[n], weights_only=False)
            for n in ("other", "this"))
    differ = False
    for key in a:
        if key == "libs":
            continue
        same = torch.equal(a[key], b[key])
        differ |= not same
        off = (a[key] != b[key]).reshape(-1, a[key].shape[-1]).any(0)
        print(f"{key}: " + ("equal" if same else
                            f"differs on {int(off.sum())} lanes"))
    for v in a["libs"]:
        same = sass(a["libs"][v]) == sass(b["libs"][v])
        differ |= not same
        print(f"SASS of solve_mega{v}: {'identical' if same else 'differs'}")
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
