"""The share of the compact tail that did work: the program's count of
the tail's lanes that needed pass 2 (`solve_mega.need_total()`, at most
the tail's size in each call) over the lanes handed to pass 2
(`solve_mega.tail_lanes`), both summed over every compact call of the
process. `drivers/batch_solve.py` does not collect them: this
reads the program module's globals after the window, traced runs only
(None untraced, or where the program has no such counter)."""

from harness import compact


def read(rec):
    return compact.tail_need_frac(rec)
