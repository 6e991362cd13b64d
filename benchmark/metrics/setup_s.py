"""Process start to the first timed call: imports, inputs, the build of
K1 in a run that builds it, the warm-up (host clock)."""


def read(rec):
    return rec.setup_s
