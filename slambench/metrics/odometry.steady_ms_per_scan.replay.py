"""ms of the steady dispatches (one "steady" replay a scan), synchronised,
over the scans they ran, in the closed-loop cells."""


def read(run):
    tr = run.trace
    if tr is None or run.mode != "closed" or not tr.steady_scans:
        return None
    return 1e3 * sum(tr.spans["steady"]) / tr.steady_scans
