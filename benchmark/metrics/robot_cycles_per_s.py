"""Robots times control cycles completed in the window over the window
(host clock)."""


def read(rec):
    if rec.trace is not None or "robot_cycles" not in rec.counts:
        return None
    return rec.counts["robot_cycles"] / rec.window_s
