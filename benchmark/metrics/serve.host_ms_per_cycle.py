"""Host time to enqueue one control cycle of the serving loop: the mean
duration of the program's `serve.cycle` span in the traced window, ms
(the program's spans as the profiler recorded them, clipped to the
window; None untraced or where the program opens no such span)."""

SPAN = "serve.cycle"


def read(rec):
    tr = rec.trace
    if tr is None:
        return None
    d = [min(b, tr.t1) - max(a, tr.t0) for n, a, b in tr.spans
         if n == SPAN and b > tr.t0 and a < tr.t1]
    return sum(d) / len(d) * 1e3 if d else None
