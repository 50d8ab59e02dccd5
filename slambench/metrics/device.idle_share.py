"""Percent of the profiled slice in which no operation ran on the card:
100 (1 - union of the card's operation intervals / the slice's length)."""


def read(run):
    tr = run.trace
    if tr is None or not tr.window_s or not tr.summary:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
