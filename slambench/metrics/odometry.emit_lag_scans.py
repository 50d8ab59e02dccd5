"""The mean number of scans handed in after a scan before its pose was
emitted, over the window's scans (the deferred emission: the window's
oldest frame leaves when a scan arrives, and batches and the stats ring
hold it back further)."""


def read(run):
    lags = [run.emit_call[k] - k for k in run.due if k in run.emit_call]
    return sum(lags) / len(lags) if lags else None
