"""Host time of one un-synced batch_solve_lane call (enqueue only), mean
over the traced window's calls, ms (harness span)."""

from harness import readers


def read(rec):
    return readers.span_ms(rec, "dispatch.batch_solve_lane")
