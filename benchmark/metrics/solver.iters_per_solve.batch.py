"""SQP iterations per solve in the traced window, as the outputs report
them."""


def read(rec):
    it = rec.counts.get("lane_iterations")
    return None if it is None else it / rec.counts["solves"]
