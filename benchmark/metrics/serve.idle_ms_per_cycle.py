"""The device's idle time per control cycle of the serving loop, ms: the
gaps between the device's busy intervals in the traced window whose
middle lies inside a `serve.cycle` span of the program (the rule by
which the breakdown names a gap), over the number of those spans in the
window (the program's spans as the profiler recorded them; None untraced
or where the program opens no such span)."""

import bisect

SPAN = "serve.cycle"


def read(rec):
    tr = rec.trace
    if tr is None:
        return None
    cycles = sorted((max(a, tr.t0), min(b, tr.t1)) for n, a, b in tr.spans
                    if n == SPAN and b > tr.t0 and a < tr.t1)
    if not cycles:
        return None
    starts = [a for a, _ in cycles]
    idle, edge = 0.0, tr.t0
    for a, b in list(tr.busy_intervals) + [(tr.t1, tr.t1)]:
        if a > edge:
            mid = 0.5 * (edge + a)
            i = bisect.bisect_right(starts, mid) - 1
            if i >= 0 and mid <= cycles[i][1]:
                idle += a - edge
        edge = max(edge, b)
    return idle / len(cycles) * 1e3
