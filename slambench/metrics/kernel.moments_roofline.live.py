"""Percent of its bytes roofline that the moment accumulation reaches in
the profiled slice of a open-loop cell: the bytes its valid rows need
(`peaks.moments_bytes`) over the HBM peak, divided by the profiler's
device time of csrc/moments.cu's kernel."""

from slambench import peaks


def read(run):
    tr = run.trace
    if tr is None or run.mode != "open" or not tr.summary:
        return None
    s = tr.summary
    if not s["moments_s"] or not s["moments_bytes"]:
        return None
    return 100.0 * s["moments_bytes"] / peaks.HBM_BYTES_PER_S / s["moments_s"]
