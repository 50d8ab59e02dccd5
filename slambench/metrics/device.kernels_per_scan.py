"""Kernels the card ran in the profiled slice (graph replays' kernels
included), per scan handed in during it."""


def read(run):
    tr = run.trace
    if tr is None or not tr.summary or not tr.summary["scans"]:
        return None
    return tr.summary["kernels"] / tr.summary["scans"]
