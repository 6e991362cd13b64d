"""SQP iterations per warm-started solve (cycles 2 onwards of each call)
in the traced window, as the outputs report them."""


def read(rec):
    it = rec.counts.get("warm_iterations")
    n = rec.counts.get("warm_solves")
    return None if it is None or not n else it / n
