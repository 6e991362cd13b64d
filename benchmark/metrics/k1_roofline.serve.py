"""K1's share of its roofline in the traced window, percent: the
algorithm's operations for the iterations the outputs report over 67
TFLOP/s, or the bytes of each input and output once over 3.35 TB/s,
whichever is larger, divided by K1's profiled time."""

from harness import readers


def read(rec):
    return readers.k1_roofline_pct(rec)
