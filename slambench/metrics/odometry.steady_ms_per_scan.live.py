"""ms of the steady dispatches (one "steady_k" replay a K-scan batch),
synchronised, over the scans they ran, in the open-loop cells."""


def read(run):
    tr = run.trace
    if tr is None or run.mode != "open" or not tr.steady_scans:
        return None
    return 1e3 * sum(tr.spans["steady"]) / tr.steady_scans
