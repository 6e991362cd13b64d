"""Arithmetic the metric readers share: K1's time and roofline share in
a traced window, the device's idle share, host spans. Each returns None
where the record holds nothing to read."""

from __future__ import annotations

from frozen import roofline

K1 = "solve_mega_kernel"


def _is_k1(name: str) -> bool:
    return K1 in name


def k1_time(rec):
    """(seconds, launches) of K1 in the traced window."""
    if rec.trace is None:
        return None
    s, n = rec.trace.time_by(_is_k1)
    return (s, n) if n else None


def k1_ms_per_launch(rec):
    t = k1_time(rec)
    return None if t is None else t[0] / t[1] * 1e3


def k1_roofline_pct(rec):
    """The least time the card could take for the window's K1 launches
    (the algorithm's operations for the iterations the outputs report, or
    each input and output moved once; `frozen.roofline`) over K1's
    measured time, in percent."""
    t = k1_time(rec)
    it = rec.counts.get("lane_iterations")
    lanes = rec.counts.get("solves")
    if t is None or it is None or not lanes:
        return None
    s = rec.cfg["solver"]
    bound, _ = roofline.roofline_s(it, lanes, int(s["n_steps"]) - 1,
                                   int(s["ls_iters"]), bool(s["ddp"]))
    return 100.0 * bound / t[0]


def idle_frac(rec):
    if rec.trace is None or rec.trace.window_s <= 0:
        return None
    return 1.0 - rec.trace.busy_s / rec.trace.window_s


def span_ms(rec, name):
    """The mean of a host span, ms (a traced run's spans)."""
    if rec.trace is None:
        return None
    d = rec.spans.durations(name)
    return sum(d) / len(d) * 1e3 if d else None
