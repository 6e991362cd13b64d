"""Device time of every op other than K1 that the serving loop launched
(lane packing, plant step, warm shift), per control cycle of the traced
window, ms (profiler; ops are counted by the harness span their launch
fell in, so the client's fetch is left out)."""

from harness import readers


def read(rec):
    if rec.trace is None:
        return None
    s, n = rec.trace.time_by(lambda name: readers.K1 not in name,
                             launched_in="serve.receding_horizon_rollout")
    if not n:
        return None
    cycles = rec.counts["calls"] * int(rec.traffic["n_cycles"])
    return s / cycles * 1e3
