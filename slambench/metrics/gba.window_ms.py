"""ms a GBA window step (`HbaRunner._window_step`, all its rounds) takes,
synchronised, the mean over the window's steps."""


def read(run):
    tr = run.trace
    w = [] if tr is None else tr.spans.get("gba_window", [])
    return 1e3 * sum(w) / len(w) if w else None
