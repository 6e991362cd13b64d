"""K1's device time per launch in the traced window (profiler, by
kernel name)."""

from harness import readers


def read(rec):
    return readers.k1_ms_per_launch(rec)
