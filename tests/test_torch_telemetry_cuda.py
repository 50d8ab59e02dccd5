"""The port's telemetry (`voxelslam_tpu_torch/utils/telemetry.py`) on the
card: the steady graph's stage marks (external events captured into the
graph) sum to the replay's event-timed device time, a graph captured with
telemetry off has no marks, outputs are bitwise equal with telemetry on
and off, a span's interval agrees with its profiler range, and
segment_add's bytes count once a replay. This file imports no JAX, so it
runs where JAX is absent:

    python -m pytest -m cuda --noconftest -p no:cacheprovider tests/test_torch_telemetry_cuda.py

Its scenario (`packets`, `cfg`) is shared with the CPU tests of
tests/test_torch_telemetry.py: the box room of tests/test_determinism.py
at 96 x 16 beams, a window of 6 scans (init in 8 scans), then steady
scans.
"""

import dataclasses

import numpy as np
import pytest
import torch

from voxelslam_tpu_torch import config as C
from voxelslam_tpu_torch.io import simulator as sim
from voxelslam_tpu_torch.ops import moments as mo, segment_add as sa
from voxelslam_tpu_torch.pipeline import SlamPipeline
from voxelslam_tpu_torch.utils import telemetry

STAGES = ("prop_deskew", "downsample", "preint", "iekf", "insert",
          "refresh", "harvest", "window_ba", "marginalize")


def cfg(**kw):
    """tests/test_determinism.py's widths with a window of 6 scans; `kw`
    replaces MapConfig, OdometryConfig or LocalBAConfig fields."""
    parts = dict(map=C.MapConfig(capacities=(1 << 11, 1 << 12, 1 << 12),
                                 unique_max=(1024, 1024, 2048), win_size=6),
                 odom=C.OdometryConfig(point_max=1024, imu_max=64),
                 lba=C.LocalBAConfig(factor_max=256, win_size=6))
    for k, v in kw.items():
        sect = next(s for s in parts if hasattr(parts[s], k))
        parts[sect] = dataclasses.replace(parts[sect], **{k: v})
    return C.SlamConfig(**parts)


def packets(n_scans):
    """The box room at 96 x 16 beams, 200 Hz IMU, seed = scan index."""
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
        ts = np.arange(t - 0.01, t + 0.1 + 1e-6, 1.0 / 200.0)
        imu = np.array([np.concatenate(traj.imu_at(ti)) for ti in ts])
        out.append((scan["points"][hit], scan["offsets"][hit], ts,
                    imu[:, 0:3], imu[:, 3:6], t, t + 0.1))
        t += 0.1
    return out


def outputs(pipe):
    """Every emitted pose's fields as bytes and each map level's tensors
    as numpy arrays."""
    poses = [(sp.t, sp.session) + tuple(
        np.asarray(getattr(sp, f)).tobytes()
        for f in ("R", "p", "v", "v6", "bg", "ba", "g", "cloud",
                  "cloud_mask")) for sp in pipe.scan_poses]
    levels = [{f.name: getattr(lv, f.name).cpu().numpy()
               for f in dataclasses.fields(lv)
               if torch.is_tensor(getattr(lv, f.name))}
              for lv in pipe.levels]
    return poses, levels


def same_levels(a, b) -> bool:
    return all(x.keys() == y.keys() and all(
        np.array_equal(x[k], y[k]) for k in x) for x, y in zip(a, b))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    mo._library()                 # built before the first capture
    sa._library()
    torch.use_deterministic_algorithms(False)
    telemetry.disable()
    telemetry.reset()
    yield
    telemetry.disable()
    telemetry.reset()


@pytest.mark.cuda
def test_stage_marks_sum_to_the_replay(card):
    """Captured with telemetry on, the K = 4 steady graph holds a mark a
    stage of each unrolled step; on replays the card has finished before
    the next, every replay is sampled and the nine stages sum to within
    2% of the replays' event-timed device ms."""
    pk = packets(30)
    telemetry.enable()
    pipe = SlamPipeline(cfg(batch_scans=4), device="cuda")
    for p in pk[:18]:
        pipe.process_scan(*p)
    graph = pipe._graphs["steady_k"]
    assert [n for n, _ in graph.marks] == list(STAGES) * 4
    telemetry.reset()
    for p in pk[18:]:
        pipe.process_scan(*p)
        torch.cuda.synchronize()
    g = telemetry.snapshot()["graphs"]["steady_k"]
    assert g["replays"] == g["sampled"] == 3 and g["unsampled"] == 0
    assert list(g["stages"]) == list(STAGES)
    assert all(v > 0 for v in g["stages"].values())
    total = sum(g["stages"].values())
    assert abs(total - g["device_ms"]) <= 0.02 * g["device_ms"], (total, g)


@pytest.mark.cuda
def test_graph_captured_off_has_no_marks(card):
    """A graph captured with telemetry off has no mark nodes: with
    telemetry on later its replays are timed, with no stages."""
    pk = packets(26)
    pipe = SlamPipeline(cfg(batch_scans=4), device="cuda")
    for p in pk[:18]:
        pipe.process_scan(*p)
    assert pipe._graphs["steady_k"].marks is None
    telemetry.enable()
    for p in pk[18:]:
        pipe.process_scan(*p)
    g = telemetry.snapshot()["graphs"]["steady_k"]
    assert g["replays"] == 2 and g["device_ms"] > 0 and g["stages"] == {}


@pytest.mark.cuda
@pytest.mark.parametrize("K", [1, 4])
def test_outputs_bitwise_with_telemetry_on_and_off(card, K):
    """Poses, clouds and the map are bitwise the same with telemetry on
    (graphs captured with marks) and off."""
    pk = packets(30)
    runs = {}
    for on in (True, False):
        (telemetry.enable if on else telemetry.disable)()
        pipe = SlamPipeline(cfg(batch_scans=K), collect_clouds=K == 1,
                            device="cuda")
        for p in pk:
            pipe.process_scan(*p)
        pipe.flush()
        torch.cuda.synchronize()
        runs[on] = outputs(pipe)
    assert runs[True][0] == runs[False][0] and len(runs[True][0]) > 15
    assert same_levels(runs[True][1], runs[False][1])


def _reads():
    return telemetry.snapshot()["spans"].get("odom.readback",
                                             {}).get("count", 0)


def dispatch_calls(device, graphed, n_scans=30, K=4):
    """Run the scenario with K-step calls and telemetry on: per call, its
    phase, whether it dispatched, its host reads (`odom.readback` spans)
    and the scan index, session and bytes of each pose it handed out."""
    pk = packets(n_scans)
    telemetry.reset()
    telemetry.enable()
    pipe = SlamPipeline(cfg(batch_scans=K), device=device,
                        step_graphs=graphed)
    calls = []
    for p in pk:
        seen, reads = len(pipe.scan_poses), _reads()
        out = pipe.process_scan(*p)
        calls.append((out.get("phase"), not out.get("pending", False),
                      _reads() - reads,
                      [(int(round((sp.t - pk[0][6]) / 0.1)), sp.session,
                        sp.R.tobytes(), sp.p.tobytes(), sp.v6.tobytes())
                       for sp in pipe.scan_poses[seen:]]))
    telemetry.disable()
    return calls


@pytest.mark.cuda
def test_batched_call_hands_out_its_own_replay(card):
    """K = 4: each dispatch call reads its own replay's K stats rows in
    one device->host copy and hands out the poses that replay let go
    (the batch's scans less W - 1); a queued scan's call reads nothing.
    The poses are bitwise those of the eager steps (`step_graphs=False`)."""
    W, K = 6, 4
    graphed = dispatch_calls("cuda", True)
    assert graphed == dispatch_calls("cuda", False)
    steady = [(k, c) for k, c in enumerate(graphed) if c[0] == "odom"]
    assert len(steady) >= 20
    for k, (_, dispatched, reads, poses) in steady:
        if dispatched:
            assert reads == 1
            assert [j for j, *_ in poses] == list(
                range(k - K + 1 - (W - 1), k - (W - 1) + 1)), (k, poses)
        else:
            assert reads == 0 and poses == []


@pytest.mark.cuda
def test_span_interval_on_the_profiler_clock(card):
    """A span's start and end as telemetry keeps them agree with its
    `span:` range in a profile of the card within 50 us (after a first
    span, whose range the profiler takes longer to open)."""
    from torch.profiler import ProfilerActivity, profile
    x = torch.ones(1 << 20, device="cuda")
    telemetry.enable()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with telemetry.span("first"):
            torch.cuda.synchronize()
        with telemetry.span("probe"):
            for _ in range(20):
                x = x * 1.0001
            torch.cuda.synchronize()
    ev = [e for e in prof.profiler.kineto_results.events()
          if e.name() == "span:probe"
          and not str(e.device_type()).endswith("CUDA")]
    assert len(ev) == 1
    name, parent, t0, t1 = telemetry.recent()[-1]
    assert name == "probe" and parent is None
    s, e = ev[0].start_ns(), ev[0].start_ns() + ev[0].duration_ns()
    assert abs(t0 - s) < 50_000 and abs(t1 - e) < 50_000, (t0 - s, t1 - e)


@pytest.mark.cuda
def test_segment_add_bytes_count_once_a_replay(card):
    """Each replay adds the bytes its capture recorded for segment_add's
    calls, as it adds their launches."""
    pk = packets(26)
    telemetry.enable()
    pipe = SlamPipeline(cfg(batch_scans=4), device="cuda")
    for p in pk[:18]:
        pipe.process_scan(*p)
    graph = pipe._graphs["steady_k"]
    n, b = graph.captured_launches[1], graph.captured_bytes[1]
    assert n > 0 and b > 0
    telemetry.reset()
    for p in pk[18:]:
        pipe.process_scan(*p)
    c = telemetry.snapshot()["counters"]
    assert c["kernel.segment_add.launches"] == 2 * n
    assert c["kernel.segment_add.bytes"] == 2 * b
    assert c["kernel.moments.launches"] == 2 * graph.captured_launches[0]
