"""The loop closure's programs and the odometry's loop hooks as step graphs
on the card (`LoopPipeline(step_graphs=True)`: the keyframe merge and its
descriptors, ICP of one candidate and of a padded chunk of four, the pose
graph's solve; `SlamPipeline(step_graphs=True)`: a correction's map
rebuild, its gravity-joint window solve, a keyframe reload and an
eviction, one CUDA graph replay each) against the eager path
(`step_graphs=False`) on the same card, bitwise, with deterministic
algorithms off as a user runs them. This file imports no JAX, so it runs
where JAX is absent:

    python -m pytest -m cuda --noconftest -p no:cacheprovider tests/test_torch_loop_graph_cuda.py

Its scenarios are shared with the CPU tests of
tests/test_torch_loop_graph.py: `hook_run` drives the odometry over the
box room with two corrections (a cross-session one with three keyframes,
then one with two), a keyframe reload and an eviction every four scans;
`loop_calls` runs each loop program on keyframes merged from that run's
scans and on a drifted pose chain.
"""

import types

import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from voxelslam_tpu_torch.ops import moments as mo, segment_add as sa
from voxelslam_tpu_torch.pipeline import LoopPipeline, SlamPipeline
from voxelslam_tpu_torch.pipeline.graphs import leaves

from test_torch_init_graph_cuda import init_cfg, init_packets

torch.set_num_threads(1)

HOOK_SCANS = 24
CORRECT_AT = (12, 20)        # scans before which a correction is applied
RELOAD_AT = 16
# a correction small enough for the odometry to go on matching
DX_R = Rotation.from_rotvec([0.001, -0.001, 0.004]).as_matrix()
DX_P = np.array([0.02, -0.01, 0.005])
W_KF = 6                     # scans a keyframe (the window)


def hook_cfg():
    """init_cfg's widths; the map's load checked every 4 scans at a load
    that always evicts, voxels 3 m of travel behind dropped."""
    return init_cfg(evict_check_every=4, evict_load=0.01, evict_dist=3.0)


def stand_ins(poses, picks):
    """Keyframe stand-ins (the hooks read cloud, mask, R0, p0) from
    emitted ScanPoses."""
    return [types.SimpleNamespace(cloud=poses[i].cloud,
                                  mask=poses[i].cloud_mask, R0=poses[i].R,
                                  p0=poses[i].p) for i in picks]


def hook_run(pipe, packets):
    """process_scan over the packets; before scan CORRECT_AT[0] a
    g_update correction from three keyframes, before RELOAD_AT a reload,
    before CORRECT_AT[1] a correction from two keyframes. Returns (events,
    each scan's pose, every ScanPose's fields and cloud as bytes, the
    map's bytes after the last scan)."""
    events, xs = [], []
    for k, pkt in enumerate(packets):
        if k == CORRECT_AT[0]:
            pipe.apply_correction(DX_R, DX_P, True,
                                  stand_ins(pipe.scan_poses, (0, 2, -1)))
        elif k == RELOAD_AT:
            pipe.insert_keyframe_fixed(stand_ins(pipe.scan_poses, (1,))[0])
        elif k == CORRECT_AT[1]:
            pipe.apply_correction(DX_R.T, -DX_P, False,
                                  stand_ins(pipe.scan_poses, (3, -2)))
        events.append(pipe.process_scan(*pkt))
        xs.append(np.concatenate([pipe.x.R.cpu().numpy().ravel(),
                                  pipe.x.p.cpu().numpy()]))
    levels = b"".join(a.cpu().numpy().tobytes() for a in leaves(pipe.levels))
    pipe.flush()
    poses = [(sp.t, sp.session) + tuple(
        np.asarray(getattr(sp, f)).tobytes()
        for f in ("R", "p", "v", "v6", "cloud", "cloud_mask"))
        for sp in pipe.scan_poses]
    return events, np.stack(xs), poses, levels


def hook_graphs(pipe):
    """The hook graphs `hook_run` makes: {name: calls}."""
    return {k: g.calls for k, g in pipe._graphs.items()
            if not k.startswith(("init_", "steady", "accum"))}


def pose_chain(seed, K=64, E=128):
    """A drifted K-pose chain with six loop edges of true relative poses,
    full 6x6 information, padded to E edges with dead rows (the loop
    pipeline's padded anchor graph): (R, p, ii, jj, rel_R, rel_p, W6)."""
    rng = np.random.default_rng(seed)
    th = np.linspace(0, 2 * np.pi, K)
    gt_R = Rotation.from_rotvec(np.stack([0.05 * np.sin(3 * th),
                                          0.03 * np.cos(2 * th), th],
                                         1)).as_matrix()
    gt_p = np.stack([8 * np.sin(th), 8 * (1 - np.cos(th)),
                     0.3 * np.sin(2 * th)], 1)
    bias = Rotation.from_rotvec([0.0, 0.001, 0.003]).as_matrix()
    est_R, est_p = [gt_R[0]], [gt_p[0]]
    ii, jj, rel_R, rel_p, W6 = [], [], [], [], []
    for i in range(1, K):
        rR = gt_R[i - 1].T @ gt_R[i] @ bias
        rp = gt_R[i - 1].T @ (gt_p[i] - gt_p[i - 1]) + rng.normal(0, 0.01, 3)
        est_p.append(est_p[-1] + est_R[-1] @ rp)
        est_R.append(est_R[-1] @ rR)
        A = rng.normal(0, 1, (6, 6))
        ii.append(i - 1), jj.append(i), rel_R.append(rR), rel_p.append(rp)
        W6.append(1e2 * (A @ A.T / 6 + np.eye(6)))
    for _ in range(6):
        a, b = sorted(rng.choice(K, 2, replace=False))
        ii.append(a), jj.append(b)
        rel_R.append(gt_R[a].T @ gt_R[b])
        rel_p.append(gt_R[a].T @ (gt_p[b] - gt_p[a]))
        W6.append(np.eye(6) * 1e4)
    pad = E - len(ii)
    return (np.stack(est_R), np.stack(est_p),
            np.array(ii + [0] * pad, np.int32),
            np.array(jj + [0] * pad, np.int32),
            np.concatenate([rel_R, np.tile(np.eye(3), (pad, 1, 1))]),
            np.concatenate([rel_p, np.zeros((pad, 3))]),
            np.concatenate([W6, np.zeros((pad, 6, 6))]))


def icp_chunk(kfs, rng):
    """Four RANSAC-like starts of keyframe 1 onto keyframe 0 (the true
    relative pose perturbed; the last too far off to pass) as `_icp_chunk`
    takes them: (chunk, candidate keyframes)."""
    a, b = kfs
    R_t, t_t = a.R0.T @ b.R0, a.R0.T @ (b.p0 - a.p0)
    chunk = []
    for ang, off in ((0.03, 0.15), (0.05, 0.2), (0.02, 0.1), (0.8, 3.0)):
        dR = Rotation.from_rotvec(rng.normal(0, ang, 3)).as_matrix()
        chunk.append((0, dict(R=R_t @ dR, t=t_t + rng.normal(0, off, 3))))
    return chunk, [a] * 4


def loop_calls(lp, poses):
    """Each loop program once through `lp` (its kf_point_max cut to 1024):
    two keyframes merged from W_KF ScanPoses each, ICP chunks of one and
    of three candidates (padded to four), and the solve of a 64-pose
    chain. Returns {call: numpy outputs}."""
    lp.kf_point_max = 1024
    out, kfs = {}, []
    for j in range(2):
        group = poses[j * W_KF:(j + 1) * W_KF]
        down, dmask, desc = lp._keyframe(group, group[-1].R, group[-1].p)
        out[f"keyframe{j}"] = [down, dmask] + [desc[k] for k in sorted(desc)]
        kfs.append(types.SimpleNamespace(cloud=down, mask=dmask,
                                         R0=np.asarray(group[-1].R),
                                         p0=np.asarray(group[-1].p)))
    chunk, cands = icp_chunk(kfs, np.random.default_rng(0))
    for n in (1, 3):
        out[f"icp{n}"] = list(lp._icp_chunk(kfs[1], chunk[:n], cands[:n]))
    out["pose_graph"] = list(lp._solve_pose_graph(*pose_chain(0)))
    return out


def same(a, b):
    """Bitwise equality of two {call: [arrays]} dicts."""
    return a.keys() == b.keys() and all(
        len(a[k]) == len(b[k]) and all(
            x.dtype == y.dtype and x.shape == y.shape
            and x.tobytes() == y.tobytes() for x, y in zip(a[k], b[k]))
        for k in a)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    mo._library()                 # built before the first capture
    sa._library()


@pytest.mark.cuda
def test_hook_graphs_equal_eager_on_card():
    """Two corrections (the second with fewer keyframes replays the first's
    graph), a gravity-joint solve, a reload and evictions: graphed bitwise
    the eager path (events, poses, clouds, the final map), each hook one
    graph replayed."""
    _card()
    packets = init_packets()[8:8 + HOOK_SCANS]      # no sparse scans
    torch.use_deterministic_algorithms(False)
    runs = {}
    for graphed in (True, False):
        pipe = SlamPipeline(hook_cfg(), collect_clouds=True, device="cuda",
                            step_graphs=graphed)
        runs[graphed] = hook_run(pipe, packets) + (pipe,)
    (ev_g, xs_g, p_g, lv_g, pipe), (ev_e, xs_e, p_e, lv_e, _) = (
        runs[True], runs[False])
    assert ev_g == ev_e
    assert np.array_equal(xs_g, xs_e) and p_g == p_e and lv_g == lv_e
    calls = hook_graphs(pipe)
    assert calls["correction_5x1024"] == 2 and calls["g_reloc"] == 1
    assert calls["keyframe_reload_1024"] == 1 and calls["evict"] >= 2
    for k in calls:
        assert pipe._graphs[k].graph is not None


@pytest.mark.cuda
def test_loop_graphs_equal_eager_on_card():
    """The keyframe, both ICP shapes and the pose graph replayed bitwise
    the eager calls; one graph a shape, replayed."""
    _card()
    packets = init_packets()[8:8 + HOOK_SCANS]
    torch.use_deterministic_algorithms(False)
    pipe = SlamPipeline(hook_cfg(), collect_clouds=True, device="cuda")
    hook_run(pipe, packets)
    got = {}
    for graphed in (True, False):
        lp = LoopPipeline(hook_cfg(), device="cuda", step_graphs=graphed)
        got[graphed] = (loop_calls(lp, pipe.scan_poses), lp)
    (g, lp), (e, _) = got[True], got[False]
    assert same(g, e)
    assert {k: v.calls for k, v in lp._graphs.items()} == {
        "keyframe": 2, ("icp", 1): 1, ("icp", 4): 1,
        ("pose_graph", 64, 128): 1}
    assert all(v.graph is not None for v in lp._graphs.values())
    assert lp.pool_bytes() > 0
