"""Scans whose pose was emitted in the window, over the window's seconds
(closed loop: the offline replay). Every kind of scan counts: steady,
keyframe, correction and GBA-window scans. Per layer: the host's speed at
`verify` and the seed's matches move it run to run by more than an
end-to-end bound may hold."""


def read(run):
    if run.mode != "closed" or run.window_s <= 0:
        return None
    return run.emitted_in_window / run.window_s
