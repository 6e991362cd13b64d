"""K1's compact pass 1 per call in the traced window, ms: the device time
of the K1 launches whose TILE_EXIT template flag is set (the lockstep
128-lane tiles of `done_frac < 1`, by the kernel's name in the profiler)
over the window's calls."""

from harness import compact


def read(rec):
    return compact.pass1_ms(rec)
