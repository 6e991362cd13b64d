"""What the compact cells' metric readers share: K1's launches split by
the pass they ran (the TILE_EXIT template flag in the profiler's name of
the kernel), the device time of K3 (the ops the program launched inside
its `k1.schedule` spans), and the program's schedule counters. Each
returns None where the record holds nothing to read: untraced, in a trace
of a program without the span, or where no such launch ran."""

from __future__ import annotations

import re
import sys

from frozen import k3_bytes, roofline

from .readers import K1

SCHEDULE = "k1.schedule"
TAIL = "k1.tail"
DISPATCH = "k1.dispatch"
PROGRAM = "mpc_ros_tpu_torch.kernels.solve_mega"
_ARGS = re.compile(re.escape(K1) + r"<([^<>]*)>")


def tile_exit(name: str):
    """K1's TILE_EXIT flag, the fifth template argument of the kernel's
    name as the profiler gives it (`solve_mega_kernel<4, true, true, true,
    true, ...>`: the lockstep pass of `done_frac < 1`); None where the name
    is no K1 launch or carries no arguments."""
    m = _ARGS.search(name)
    if m is None:
        return None
    args = [a.strip() for a in m.group(1).split(",")]
    if len(args) < 5:
        return None
    return args[4] in ("true", "1")


def per_call_ms(rec, match, launched_in=None):
    """The device time of the ops `match` accepts (launched inside a
    program span `launched_in`, if given) per call of the window, ms."""
    if rec.trace is None or not rec.counts.get("calls"):
        return None
    s, n = rec.trace.time_by(match, launched_in=launched_in)
    return s / rec.counts["calls"] * 1e3 if n else None


def pass1_ms(rec):
    """K1's lockstep pass 1 (TILE_EXIT set) per call, ms."""
    return per_call_ms(rec, lambda n: tile_exit(n) is True)


def tail_ms(rec):
    """K1's tail (TILE_EXIT clear, launched inside `k1.tail`) per call,
    ms."""
    return per_call_ms(rec, lambda n: tile_exit(n) is False,
                       launched_in=TAIL)


def k3_ms(rec):
    """Every device op launched inside the program's `k1.schedule` spans
    (K3's argsort, gathers and scatters) per call, ms."""
    return per_call_ms(rec, lambda n: True, launched_in=SCHEDULE)


def k3_roofline_pct(rec):
    """The least time K3's bytes (`frozen.k3_bytes`) take at the HBM's
    peak over K3's measured time per call, percent."""
    ms = k3_ms(rec)
    if ms is None:
        return None
    s, tr = rec.cfg["solver"], rec.traffic
    need = k3_bytes.k3_bytes(int(s["n_steps"]), int(tr["batch"]),
                             float(s["compact_tail"]),
                             int(s.get("poly_order", 3)) + 1)["total"]
    return 100.0 * need / roofline.PEAK_BYTES_PER_S / (ms * 1e-3)


def k1_host_ms_per_call(rec):
    """The host time of K1's host path summed over a call's launches (pass
    1's and the tail's `k1.dispatch` spans, clipped to the window) per
    call, ms."""
    tr = rec.trace
    if tr is None or not rec.counts.get("calls"):
        return None
    d = [min(b, tr.t1) - max(a, tr.t0) for n, a, b in tr.spans
         if n == DISPATCH and b > tr.t0 and a < tr.t1]
    return sum(d) / rec.counts["calls"] * 1e3 if d else None


def tail_need_frac(rec):
    """The program's counters after the window: the tail's lanes that
    needed pass 2 (`need_total()`, at most the tail in each call, so the
    share cannot pass 1) over the lanes handed to pass 2, both summed over
    every compact call of the process (the warm-up's too; a ratio, so the
    calls weigh alike)."""
    if rec.trace is None:
        return None
    mod = sys.modules.get(PROGRAM)
    need = getattr(mod, "need_total", None)
    lanes = getattr(mod, "tail_lanes", 0)
    if need is None or not lanes:
        return None
    return need() / lanes
