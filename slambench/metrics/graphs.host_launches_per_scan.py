"""The host's calls into the CUDA runtime that start work on the card
(kernel and graph launches, copies, fills) in the profiled slice, per
scan handed in during it."""


def read(run):
    tr = run.trace
    if tr is None or not tr.summary or not tr.summary["scans"]:
        return None
    return tr.summary["launches"] / tr.summary["scans"]
