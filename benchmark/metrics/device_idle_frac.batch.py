"""1 - the union of the device's op intervals over the traced window
(profiler)."""

from harness import readers


def read(rec):
    return readers.idle_frac(rec)
