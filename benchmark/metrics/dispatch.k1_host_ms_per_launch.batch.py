"""Host time of K1's host path per launch (checks, knobs, contiguous
inputs, the build's lookup, the allocations and the launcher's call): the
mean duration of the program's `k1.dispatch` span in the traced window,
ms (the program's spans as the profiler recorded them, clipped to the
window; None untraced or where no K1 launched, as on a CPU rehearsal)."""

SPAN = "k1.dispatch"


def read(rec):
    tr = rec.trace
    if tr is None:
        return None
    d = [min(b, tr.t1) - max(a, tr.t0) for n, a, b in tr.spans
         if n == SPAN and b > tr.t0 and a < tr.t1]
    return sum(d) / len(d) * 1e3 if d else None
