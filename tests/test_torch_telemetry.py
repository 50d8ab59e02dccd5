"""The port's telemetry (`voxelslam_tpu_torch/utils/telemetry.py`) on the
CPU: off, it makes no profiler range, no CUDA event and no record; on,
spans nest with their parents and self times and counters sum; outputs
are bitwise the same on and off (the steady, batched and loop paths);
`verify`'s counts are its H and M; the emission's window and hold add up
to the lag a caller sees; the dropped-point counts; the kernel counters'
bytes. The card's side (stage marks, event pairs) is in
tests/test_torch_telemetry_cuda.py, whose scenario this file shares.
"""

import dataclasses
import time

import numpy as np
import pytest
import torch

from voxelslam_tpu_torch.loop import btc
from voxelslam_tpu_torch.map import voxel_map as vm
from voxelslam_tpu_torch.ops import moments as mo, segment_add as sa
from voxelslam_tpu_torch.ops import voxel_hash as vh
from voxelslam_tpu_torch.pipeline import SlamPipeline, SlamSystem
from voxelslam_tpu_torch.pipeline.graphs import StepGraph, graph_name
from voxelslam_tpu_torch.utils import telemetry

from test_torch_telemetry_cuda import cfg, outputs, packets, same_levels

torch.set_num_threads(1)

N_SCANS = 26


@pytest.fixture(autouse=True)
def fresh():
    telemetry.disable()
    telemetry.reset()
    yield
    telemetry.disable()
    telemetry.reset()


@pytest.fixture(scope="module")
def pk():
    return packets(N_SCANS)


def _drive(make, pk, on):
    """Build with `make()` and run the packets with telemetry on or off:
    (outputs, each call's returned dict, the scan index of each emitted
    pose -> the call that emitted it, the snapshot)."""
    telemetry.reset()
    (telemetry.enable if on else telemetry.disable)()
    s = make()
    pipe = s.odom if isinstance(s, SlamSystem) else s
    events, emit_call, seen = [], {}, 0
    for k, p in enumerate(pk):
        events.append(s.process_scan(*p))
        for sp in pipe.scan_poses[seen:]:
            emit_call.setdefault(int(round((sp.t - pk[0][6]) / 0.1)), k)
        seen = len(pipe.scan_poses)
    snap = telemetry.snapshot()
    telemetry.disable()
    return outputs(pipe), events, emit_call, snap


class _Counting:
    """Counts the calls of a constructor it stands in for."""

    def __init__(self, real):
        self.real, self.n = real, 0

    def __call__(self, *a, **kw):
        self.n += 1
        return self.real(*a, **kw)


def _system_with_loop():
    s = SlamSystem(cfg(), enable_loop=True, device="cpu")
    s.loop.kf_point_max = 2048       # the keyframe merge's width, for time
    return s


@pytest.fixture(scope="module")
def runs(pk):
    """Each path with telemetry on and off: "steady" (K = 1, clouds
    collected), "batched" (K = 4, stats ring 4) and "loop" (SlamSystem
    with loop closure). The batched run with telemetry off counts the
    profiler ranges and CUDA events made ("made")."""
    makers = {
        "steady": lambda: SlamPipeline(cfg(), collect_clouds=True,
                                       device="cpu"),
        "batched": lambda: SlamPipeline(cfg(batch_scans=4, stats_ring=4),
                                        device="cpu"),
        "loop": _system_with_loop,
    }
    out = {}
    mp = pytest.MonkeyPatch()
    try:
        for name, make in makers.items():
            out[name, True] = _drive(make, pk, True)
            if name == "batched":
                made = {}
                for mod, attr in ((torch.profiler, "record_function"),
                                  (torch.autograd.profiler, "record_function"),
                                  (torch.cuda, "Event")):
                    made[mod.__name__ + "." + attr] = c = _Counting(
                        getattr(mod, attr))
                    mp.setattr(mod, attr, c)
                out[name, False] = _drive(make, pk, False)
                mp.undo()
                out["made"] = {k: c.n for k, c in made.items()}
            else:
                out[name, False] = _drive(make, pk, False)
    finally:
        mp.undo()
    return out


def test_off_makes_no_range_event_or_record(runs):
    assert runs["made"] == {"torch.profiler.record_function": 0,
                            "torch.autograd.profiler.record_function": 0,
                            "torch.cuda.Event": 0}
    snap = runs["batched", False][3]
    assert snap == {"spans": {}, "counters": {}, "graphs": {}}
    assert telemetry.span("x") is telemetry.NULL


@pytest.mark.parametrize("path", ["steady", "batched", "loop"])
def test_outputs_bitwise_on_and_off(runs, path):
    (p_on, l_on), ev_on, _, snap = runs[path, True]
    (p_off, l_off), ev_off, _, _ = runs[path, False]
    assert ev_on == ev_off
    assert p_on == p_off and len(p_on) > 8
    assert same_levels(l_on, l_off)
    assert snap["spans"]["odom"]["count"] == N_SCANS


def test_paths_record_their_spans(runs):
    steady = runs["steady", True][3]["spans"]
    assert steady["graph:steady"]["parents"] == {"odom": steady[
        "graph:steady"]["count"]}
    assert steady["odom.readback"]["parents"].keys() <= {"odom", "odom.emit"}
    batched = runs["batched", True][3]["spans"]
    assert "graph:steady_k" in batched and "odom.pack" in batched
    loop = runs["loop", True][3]
    assert loop["spans"]["scan"]["count"] == N_SCANS
    assert loop["spans"]["odom"]["parents"] == {"scan": N_SCANS}
    assert loop["spans"]["loop.keyframe"]["parents"] == {
        "loop.push": loop["spans"]["loop.keyframe"]["count"]}
    assert "graph:keyframe" in loop["spans"]
    # the pose reads go through the stats ring, which emission reads
    assert runs["batched", True][3]["counters"]["map.unique_dropped"] == 0


def test_window_and_hold_make_the_lag(runs):
    """Batch 4, stats ring 4: for the poses the program counted, the
    window's scans plus the hold equal the scans a caller counts from a
    pose's scan to the call that returned it."""
    _, _, emit_call, snap = runs["batched", True]
    c = snap["counters"]
    lags = [k - j for j, k in emit_call.items()]
    assert c["odom.poses_emitted"] == len(lags) > 8
    assert c["odom.emit_window_scans"] + c["odom.emit_hold_scans"] == sum(lags)
    assert c["odom.emit_window_scans"] == 5 * len(lags)   # W - 1
    assert c["odom.emit_hold_scans"] > 0


def test_nested_spans_parents_self_times_and_counters():
    telemetry.enable()
    with telemetry.span("outer"):
        time.sleep(0.002)
        for _ in range(2):
            with telemetry.span("inner"):
                time.sleep(0.001)
    with telemetry.span("inner"):
        pass
    telemetry.count("c")
    telemetry.count("c", 4)
    snap = telemetry.snapshot()
    outer, inner = snap["spans"]["outer"], snap["spans"]["inner"]
    assert outer["count"] == 1 and inner["count"] == 3
    assert outer["parents"] == {None: 1}
    assert inner["parents"] == {"outer": 2, None: 1}
    assert inner["self_ms"] == inner["total_ms"]
    last = telemetry.recent()[-1]
    nested = inner["total_ms"] - 1e-6 * (last[3] - last[2])
    assert outer["self_ms"] == pytest.approx(outer["total_ms"] - nested,
                                             abs=1e-9)
    assert outer["self_ms"] >= 1.9 and nested >= 1.9
    assert inner["max_ms"] >= 1.0
    assert snap["counters"] == {"c": 5}
    telemetry.reset()
    assert telemetry.snapshot()["spans"] == {}


@pytest.mark.parametrize("on", [False, True])
def test_spans_under_the_profiler(on):
    """A recording profiler does not turn telemetry on: off, a span is the
    shared no-op and the profile holds no span range; on, a span's
    interval agrees with its profiler range within 50 us."""
    from torch.profiler import ProfilerActivity, profile
    if on:
        telemetry.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert telemetry.on() is on
        with telemetry.span("first"):
            pass
        with telemetry.span("probe"):
            torch.ones(1000).sum()
    ev = [e for e in prof.profiler.kineto_results.events()
          if e.name().startswith("span:")]
    if not on:
        assert ev == [] and telemetry.span("probe") is telemetry.NULL
        assert telemetry.snapshot()["spans"] == {}
        return
    ev = [e for e in ev if e.name() == "span:probe"]
    assert len(ev) == 1
    name, _, t0, t1 = telemetry.recent()[-1]
    s, e = ev[0].start_ns(), ev[0].start_ns() + ev[0].duration_ns()
    assert name == "probe"
    assert abs(t0 - s) < 50_000 and abs(t1 - e) < 50_000, (t0 - s, t1 - e)


def test_step_graph_call_is_a_span_and_stages_its_inputs():
    telemetry.enable()

    def toy(carry, inputs):
        return (carry[0] + inputs[0],), (carry[0] * 2,)
    g = StepGraph(toy, "cpu", name=graph_name(("icp", 4)))
    for _ in range(3):
        g((torch.zeros(3),), (np.ones(3, np.float32),))
    snap = telemetry.snapshot()
    assert snap["spans"]["graph:icp_4"]["count"] == 3
    assert snap["graphs"]["icp_4"]["host_ms"] > 0
    assert telemetry.mark("x") is None      # no capture: nothing


def _verify_frames(M, seed=0):
    """A target frame of M triangles and a query that is the same scene
    moved by a rigid motion, its triangle i matched to target i."""
    rng = np.random.default_rng(seed)
    cfg = btc.BtcConfig()
    verts = rng.uniform(-20, 20, (M, 3, 3))
    ang = 0.3
    R = np.array([[np.cos(ang), -np.sin(ang), 0], [np.sin(ang), np.cos(ang),
                                                    0], [0, 0, 1.0]])
    t = np.array([1.0, -2.0, 0.5])
    centers = rng.uniform(-20, 20, (40, 3))
    normals = rng.normal(size=(40, 3))
    normals /= np.linalg.norm(normals, axis=1, keepdims=True)
    binary = (rng.random((M, 3, cfg.code_bits)) > 0.5).astype(np.float32)
    target = dict(verts=verts, binary=binary, plane_centers=centers,
                  plane_normals=normals, plane_valid=np.ones(40, bool))
    # query in its own frame: target = R query + t
    query = dict(verts=(verts - t) @ R, binary=binary,
                 plane_centers=(centers - t) @ R, plane_normals=normals @ R,
                 plane_valid=np.ones(40, bool))
    db = btc.DescriptorDB(cfg, use_native=False)
    db.frames[7] = target
    return db, query, [(i, i) for i in range(M)], cfg


@pytest.mark.parametrize("M", [40, 700])
def test_verify_counts_its_hypotheses_and_pairs(M):
    db, query, matches, cfg = _verify_frames(M)
    telemetry.enable()
    best = db.verify(query, 7, matches)
    db.verify(query, 7, [])
    c = telemetry.snapshot()["counters"]
    H = min(cfg.ransac_hyps, M)
    assert best is not None and best["votes"] == M
    assert c["verify.calls"] == 2 and c["verify.passed"] == 1
    assert c["verify.pairs"] == M and c["verify.hypotheses"] == H
    assert c["verify.tests"] == H * M
    assert telemetry.snapshot()["spans"]["loop.verify"]["count"] == 2


def test_points_truncated_past_point_max(pk):
    telemetry.enable()
    pipe = SlamPipeline(cfg(point_max=512), device="cpu")
    phases = [pipe.process_scan(*p)["phase"] for p in pk[:4]]
    # the IMU's static init takes its scans without their points
    n = sum(len(p[0]) - 512 for p, ph in zip(pk, phases)
            if ph != "imu_init")
    assert n > 0
    assert telemetry.snapshot()["counters"]["odom.points_truncated"] == n


def test_fused_insert_counts_points_past_unique_max():
    """The fourth entry of a level's touched tuple is the valid points the
    dedup dropped past the level's unique_max."""
    mcfg = dataclasses.replace(cfg().map, unique_max=(16, 16, 16))
    rng = np.random.default_rng(3)
    pts = torch.as_tensor(rng.uniform(-6, 6, (400, 3)), dtype=torch.float32)
    mask = torch.as_tensor(rng.random(400) > 0.2, dtype=torch.float32)
    tr = vm.point_noise_record(pts, 0.02, 0.05)
    _, touched = vm.insert_scan_fused(
        vm.empty_map(mcfg, "cpu"), mcfg, pts, pts, tr, mask, 0, 0.0,
        torch.eye(3), torch.zeros(3))
    for l, t in enumerate(touched):
        keys = vh.voxel_key(pts, mcfg.level_size(l))
        _, _, inv = vh.dedup_keys(keys, mask > 0, 16)
        want = int(((mask > 0) & (inv < 0)).sum())
        assert int(t[3]) == want
    assert int(touched[2][3]) > 0


def test_kernel_counters_take_bytes_and_replays():
    assert sa.call_bytes(100, 40, 4, 4, 8) == (40 * 4 + 2 * 100 * 4) * 4 \
        + 40 * 8
    assert sa.call_bytes(100, 40, 4, 4, 8, zero=True) == \
        (40 * 4 + 100 * 4) * 4 + 40 * 8
    c = mo._Counter("kernel.x")
    c.replayed(1, 10)                       # off: the counter alone
    telemetry.enable()
    c.replayed(3, 30)
    c.replayed(1)
    assert (c.launches, c.captured) == (5, 0)
    assert telemetry.snapshot()["counters"] == {"kernel.x.launches": 4,
                                                "kernel.x.bytes": 30}
