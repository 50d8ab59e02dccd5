"""Host ms in `DescriptorDB.verify` (the RANSAC agreement test, numpy)
over the window, per keyframe made in the window (stage clock)."""


def read(run):
    tr = run.trace
    if tr is None or not tr.keyframes or "verify" not in tr.spans:
        return None
    return 1e3 * sum(tr.spans["verify"]) / tr.keyframes
