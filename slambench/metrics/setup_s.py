"""Seconds from the start of the process to the window: imports, the
kernels' load (or build, in a checkout's first run), the stream made on
the card, the system built, the warm-up scans and their graph captures."""


def read(run):
    return run.setup_s
