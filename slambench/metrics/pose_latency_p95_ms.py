"""95th percentile, over every scan due in the window, of the time from
when the scan was due (the end of its sweep) to when `process_scan`
returned with its pose emitted (open loop: the live sensor). A scan whose
pose never came makes the run incorrect instead."""

import numpy as np


def read(run):
    if run.mode != "open":
        return None
    lat = [run.emit_at[k] - run.due[k] for k in run.due if k in run.emit_at]
    if not lat:
        return None
    return 1e3 * float(np.percentile(np.asarray(lat), 95.0))
