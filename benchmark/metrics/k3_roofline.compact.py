"""K3's share of its roofline in the traced window, percent: the bytes
the compact schedule's work must move per call (`frozen/k3_bytes.py`:
the done flags read and the tail's indices written, the tail's inputs and
resume state gathered, its outputs scattered into their rows) over 3.35
TB/s, divided by K3's profiled time per call."""

from harness import compact


def read(rec):
    return compact.k3_roofline_pct(rec)
