"""K1's compact tail per call in the traced window, ms: the device time of
the K1 launches whose TILE_EXIT template flag is clear and whose launch
lies inside the program's `k1.tail` span, over the window's calls (None
in a trace of a program without the span)."""

from harness import compact


def read(rec):
    return compact.tail_ms(rec)
