"""K3's device time per call in the traced window, ms: every device op
launched inside the program's `k1.schedule` spans (the compact
schedule's argsort, gathers and scatters between and after K1's passes)
over the window's calls."""

from harness import compact


def read(rec):
    return compact.k3_ms(rec)
