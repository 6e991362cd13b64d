"""All the solves completed in the window over the window (host clock)."""


def read(rec):
    if rec.trace is not None or "solves" not in rec.counts:
        return None
    return rec.counts["solves"] / rec.window_s
