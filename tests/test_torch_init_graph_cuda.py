"""The init path's step graphs on the card (`SlamPipeline(step_graphs=True)`:
an init-window scan, a dynamic-init round of each phase and a successful
init's map build one CUDA graph replay each, in one memory pool; a partial
queue drain through the K = 1 steady graph) against the eager path
(`step_graphs=False`) on the same card, bitwise, with deterministic
algorithms off as a user runs them. This file imports no JAX, so it runs
where JAX is absent:

    python -m pytest -m cuda --noconftest -p no:cacheprovider tests/test_torch_init_graph_cuda.py

Its scenario (`init_packets`, `init_cfg`, `drive`) is shared with the CPU
tests of tests/test_torch_init_graph.py: the first init window's scans
keep 30 points each, so the first dynamic init fails its degeneracy gate
and resets into session 1; the next window initializes; a reset at scan
`RESET_AT` starts session 2, whose init reuses the captured graphs.
"""

import dataclasses

import numpy as np
import pytest
import torch

from voxelslam_tpu_torch import config as C
from voxelslam_tpu_torch.io import simulator as sim
from voxelslam_tpu_torch.ops import moments as mo, segment_add as sa
from voxelslam_tpu_torch.pipeline import SlamPipeline

torch.set_num_threads(1)

N_SCANS = 34
SPARSE = range(2, 8)         # the first init window: 30 points a scan
RESET_AT = 24
INIT_GRAPHS = ("init_accum", "init_round", "init_round_aligned", "init_map")


def init_cfg(**kw):
    """tests/test_determinism.py's widths with a window of 6 scans (init
    in 8 scans); `kw` replaces MapConfig, OdometryConfig or LocalBAConfig
    fields."""
    parts = dict(map=C.MapConfig(capacities=(1 << 11, 1 << 12, 1 << 12),
                                 unique_max=(1024, 1024, 2048), win_size=6),
                 odom=C.OdometryConfig(point_max=1024, imu_max=64),
                 lba=C.LocalBAConfig(factor_max=256, win_size=6))
    for k, v in kw.items():
        sect = next(s for s in parts if hasattr(parts[s], k))
        parts[sect] = dataclasses.replace(parts[sect], **{k: v})
    return C.SlamConfig(**parts)


def init_packets(n_scans=N_SCANS):
    """The box room at 96 x 16 beams, 200 Hz IMU, seed = scan index; the
    scans of SPARSE cut to 30 points."""
    traj = sim.make_trajectory(duration=0.2 + 0.1 * (n_scans + 2),
                               speed=1.2, wobble=0.25, yaw_rate=0.3,
                               ramp=1.2)
    normals, dsp = sim.box_room(half_extent=(14.0, 12.0, 3.5),
                                center=(4.0, 0.0, 1.0))
    out, t = [], 0.1
    for k in range(n_scans):
        scan = sim.lidar_scan(traj, t, t + 0.1, normals, dsp, n_az=96,
                              n_el=16, noise=0.01, seed=k)
        hit = scan["hit"]
        pts, off = scan["points"][hit], scan["offsets"][hit]
        if k in SPARSE:
            pts, off = pts[:30], off[:30]
        ts = np.arange(t - 0.01, t + 0.1 + 1e-6, 1.0 / 200.0)
        imu = np.array([np.concatenate(traj.imu_at(ti)) for ti in ts])
        out.append((pts, off, ts, imu[:, 0:3], imu[:, 3:6], t, t + 0.1))
        t += 0.1
    return out


def drive(pipe, packets, hook=None):
    """process_scan over packets (a reset into a new session at RESET_AT,
    `hook(k, pipe)` before scan k), then flush(): the events, each scan's
    pose (R, p) and every emitted ScanPose's fields and cloud as bytes."""
    events, xs = [], []
    for k, pkt in enumerate(packets):
        if hook is not None:
            hook(k, pipe)
        if k == RESET_AT:
            pipe.reset(session=pipe.session + 1)
        events.append(pipe.process_scan(*pkt))
        xs.append(np.concatenate([pipe.x.R.cpu().numpy().ravel(),
                                  pipe.x.p.cpu().numpy()]))
    pipe.flush()
    poses = [(sp.t, sp.session) + tuple(
        np.asarray(getattr(sp, f)).tobytes()
        for f in ("R", "p", "v", "v6", "bg", "ba", "g", "cloud",
                  "cloud_mask")) for sp in pipe.scan_poses]
    return events, np.stack(xs), poses


def phases(events):
    return [e.get("phase") for e in events]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    mo._library()                 # built before the first capture
    sa._library()


@pytest.mark.cuda
def test_init_graphs_equal_eager_on_card():
    """A failed init, a reset, an init, steady scans, a reset and a second
    init: graphed bitwise the eager path (events, poses, clouds); each
    init graph captured once and replayed by the second init; segment_add
    counted once a replay, as often as the eager path launches it."""
    _card()
    packets = init_packets()
    torch.use_deterministic_algorithms(False)
    runs, graphs = {}, {}
    for graphed in (True, False):
        pipe = SlamPipeline(init_cfg(), collect_clouds=True, device="cuda",
                            step_graphs=graphed)

        def hook(k, p):
            if k == RESET_AT and graphed:      # after the first success
                graphs.update({n: p._graphs[n] for n in INIT_GRAPHS})
        sa.counter.reset()
        out = drive(pipe, packets, hook)
        torch.cuda.synchronize()
        runs[graphed] = out + (sa.counter.launches, pipe)
    (ev_g, xs_g, p_g, seg_g, pipe), (ev_e, xs_e, p_e, seg_e, _) = (
        runs[True], runs[False])
    assert phases(ev_g).count("init_done") == 2
    assert phases(ev_g).count("init_failed") == 1
    assert ev_g == ev_e
    assert np.array_equal(xs_g, xs_e) and p_g == p_e
    assert seg_g == seg_e > 0
    for n in INIT_GRAPHS:
        g = pipe._graphs[n]
        assert g is graphs[n] and g.graph is not None and g.capture_s > 0
        assert g.pool is pipe._pool is not None
    assert pipe._graphs["init_map"].calls == 2
    assert pipe._graphs["init_accum"].calls == phases(ev_g).count(
        "init_accum") + 3


def drain_run(pipe, packets):
    """batch_scans = 4 after the init at scan 7: a loop correction before
    scan 18 drains the two queued scans, the run ends with two more queued
    (flush() drains them). Returns drive()'s result."""
    c, s = np.cos(0.02), np.sin(0.02)
    dx_R = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])

    def hook(k, p):
        if k == 18:
            assert len(p._scan_queue) == 2
            p.apply_correction(dx_R, np.array([0.05, -0.02, 0.0]), False,
                               [])
    return drive(pipe, packets, hook)


@pytest.mark.cuda
def test_partial_drain_through_steady_graph_on_card():
    """Partial queues drained at a correction and at the end of the run
    replay the K = 1 steady graph, bitwise the eager drain."""
    _card()
    packets = init_packets()[8:32]          # no sparse scans
    torch.use_deterministic_algorithms(False)
    runs = {}
    for graphed in (True, False):
        pipe = SlamPipeline(init_cfg(batch_scans=4), device="cuda",
                            step_graphs=graphed)
        runs[graphed] = drain_run(pipe, packets) + (pipe,)
    (ev_g, xs_g, p_g, pipe), (ev_e, xs_e, p_e, _) = runs[True], runs[False]
    assert ev_g == ev_e
    assert np.array_equal(xs_g, xs_e) and p_g == p_e
    assert pipe._graphs["steady"].graph is not None
    assert pipe._graphs["steady"].calls == 4
