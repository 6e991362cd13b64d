"""Host time of K1's host path per call of the compact cell, ms: the
program's `k1.dispatch` spans of both passes (checks, knobs, contiguous
inputs, the build's lookup, the allocations and the launcher's call)
summed over the traced window and divided by its calls, so that the
second launch's host cost shows (None untraced, or where no K1 launched,
as on a CPU rehearsal)."""

from harness import compact


def read(rec):
    return compact.k1_host_ms_per_call(rec)
