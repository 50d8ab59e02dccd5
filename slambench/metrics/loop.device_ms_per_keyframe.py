"""ms of the loop closure's device programs and hooks over the window per
keyframe made in it (stage clocks, synchronised): the "keyframe" graph,
the ICP chunks, the pose-graph solves, `apply_correction` and the
keyframe reloads."""

STAGES = ("keyframe", "icp", "pose_graph", "apply_correction",
          "keyframe_reload")


def read(run):
    tr = run.trace
    if tr is None or not tr.keyframes:
        return None
    return 1e3 * sum(sum(tr.spans.get(s, [])) for s in STAGES) / tr.keyframes
