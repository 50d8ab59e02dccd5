"""The global BA's rounds, batched rounds and condenses as step graphs
(`HbaRunner(step_graphs=True)`, the default), on the CPU.

A StepGraph on the CPU runs the card's buffer logic (static carry and
inputs, extras in buffers that the next call overwrites) with the step
eager, so a result the runner keeps without copying shows here as a
difference from the eager runner (`step_graphs=False`). Held: the streamed
bottom-up windows (dispatch ahead), the total BA and the top-down solve,
and the fleet at fleet_batch 2, each bitwise the eager runner's; the graph
cache's keys and their reuse; a checkpoint taken with a window in flight;
no host read inside a graphed function; and the graphed stream against the
JAX runner's at tests/test_torch_gba.py's tolerances.
`tests/test_torch_gba_graph_cuda.py` holds the captured graphs to the
eager rounds on the card.
"""

import copy
import dataclasses

import numpy as np
import pytest
import torch

from voxelslam_tpu.config import SlamConfig as JSlamConfig, GBAConfig as JGBA
from voxelslam_tpu.gba import HbaRunner as JRunner
from voxelslam_tpu_torch import config as tconfig
from voxelslam_tpu_torch.gba import HbaRunner
from voxelslam_tpu_torch.parallel.multihost import global_win_mesh
from voxelslam_tpu_torch.pipeline.loop import LoopPipeline
from voxelslam_tpu_torch.pipeline.odometry import ScanPose
from voxelslam_tpu_torch.pipeline.system import SlamSystem
from voxelslam_tpu_torch.utils import telemetry

from test_torch_gba import (GBA, N_KF, _runner_kw, assert_edges_close,
                            fill_loop, jax_stream, make_keyframes, port_cfg,
                            port_kfs, window_inputs)
from test_torch_helpers import t
from test_torch_steady_graph import _HostReads

torch.set_num_threads(1)

W = GBA["win_size"]


def runner(graphed, fleet_batch=None):
    mesh = global_win_mesh(min_devices=1) if fleet_batch else None
    return HbaRunner(port_cfg(), device="cpu", mesh=mesh,
                     fleet_batch=fleet_batch, step_graphs=graphed,
                     **_runner_kw())


def stream(r, kfs):
    """Every keyframe added, then flushed: the dicts returned."""
    return [r.add_keyframe(k) for k in kfs] + [r.flush()]


def edge_bytes(edges):
    return [(e.id_a, e.id_b, e.ord_a, e.ord_b, e.R.tobytes(), e.t.tobytes(),
             e.v6.tobytes()) for e in edges]


def submap_bytes(submaps):
    return [(s.kf_index, s.scan_id, s.R0.tobytes(), s.p0.tobytes(),
             s.cloud.tobytes(), s.mask.tobytes()) for s in submaps]


def state(r):
    """What the bitwise comparisons read: edges, submaps, window log and
    host reads."""
    return (edge_bytes(r.edges1), edge_bytes(r.edges2),
            submap_bytes(r.submaps), copy.deepcopy(r.window_log),
            r.host_syncs)


@pytest.fixture(scope="module")
def kfs():
    return make_keyframes(N_KF)


@pytest.fixture(scope="module")
def runs(kfs):
    """The single-window stream, total BA and top-down, graphed and eager.
    The graphed runner's graph objects are noted after the stream."""
    out = {}
    for graphed in (True, False):
        r = runner(graphed)
        dicts = stream(r, port_kfs(kfs))
        after_stream = dict(r._graphs)
        streamed = dict(state=state(r), edges1=list(r.edges1),
                        submaps=list(r.submaps))
        total = r.total_ba()
        lp = LoopPipeline(port_cfg(), device="cpu")
        fill_loop(lp, port_kfs(kfs), ScanPose)
        corr = r.top_down(lp)
        out[graphed] = dict(runner=r, dicts=dicts, total=total, corr=corr,
                            lp=lp, after_stream=after_stream,
                            streamed=streamed, state=state(r))
    return out


def test_stream_graphed_equals_eager(runs):
    """Three windows dispatched ahead: the dicts add_keyframe and flush
    return (r0/r1 included), every edge and submap, the rounds and phases
    of each window, bitwise."""
    g, e = runs[True], runs[False]
    assert g["dicts"] == e["dicts"]
    assert sum(d is not None and d.get("r0") is not None
               for d in g["dicts"]) == 3
    edges1, edges2, submaps, log, _ = e["streamed"]["state"]
    assert len(submaps) == 3 and len(log) == 3 and edges1 and not edges2
    assert all(1 in w["phases"] for w in log)         # both phases ran
    assert g["streamed"]["state"] == e["streamed"]["state"]


def test_total_ba_and_top_down_graphed_equal_eager(runs):
    g, e = runs[True], runs[False]
    assert g["total"] == e["total"] and g["total"]["n_edges"] > 0
    assert g["state"] == e["state"]
    assert np.array_equal(g["corr"].dx_R, e["corr"].dx_R)
    assert np.array_equal(g["corr"].dx_p, e["corr"].dx_p)
    for a, b in zip(g["lp"].scan_poses[0], e["lp"].scan_poses[0]):
        assert np.array_equal(a.R, b.R) and np.array_equal(a.p, b.p)


def test_graph_cache_keys_and_reuse(runs, kfs):
    """The stream makes the window's two round graphs and the condense's,
    the total BA (3 submaps padded to 4, factor_max 2048) a round graph of
    its own width a phase it ran. A second stream through the same runner
    makes no graph and reuses every graph's buffers, one call a round."""
    r = runs[True]["runner"]
    stream_keys = {("step", W, 1024, False), ("step", W, 1024, True),
                   ("condense", W)}
    assert set(runs[True]["after_stream"]) == stream_keys
    assert not runs[False]["runner"]._graphs
    total = r.window_log[-1]
    assert total["W"] == 4
    assert set(r._graphs) == stream_keys | {
        ("step", 4, 2048, bool(p)) for p in [0] + total["phases"][:-1]}

    def calls():
        return sum(g.calls for k, g in r._graphs.items() if k[0] == "step")
    assert calls() == sum(w["rounds"] for w in r.window_log)
    graphs = dict(r._graphs)
    buffers = {k: [id(x) for x in g.static + list(g.inputs)]
               for k, g in graphs.items()}
    n_log, n_calls = len(r.window_log), calls()
    stream(r, port_kfs(kfs))
    assert len(r.window_log) > n_log + 2
    assert r._graphs == graphs
    assert {k: [id(x) for x in g.static + list(g.inputs)]
            for k, g in r._graphs.items()} == buffers
    assert calls() - n_calls == sum(w["rounds"] for w in r.window_log[n_log:])


def test_stream_graphed_matches_jax(runs, kfs):
    """The graphed stream against the JAX runner's, at
    tests/test_torch_gba.py's tolerances (r0/r1 rtol 1e-4, edges, submap
    poses within 1e-4, equal mask counts)."""
    jr = JRunner(JSlamConfig(gba=JGBA(**GBA)), **_runner_kw())
    jdicts, jflush, ref = jax_stream(jr, kfs)
    for a, b in zip(runs[True]["dicts"], jdicts + [jflush]):
        assert (a is None) == (b is None)
        if a is None:
            continue
        assert a.keys() == b.keys()
        for k in a:
            if isinstance(b[k], float):
                np.testing.assert_allclose(a[k], b[k], rtol=1e-4, err_msg=k)
            else:
                assert a[k] == b[k], (k, a, b)
    got = runs[True]["streamed"]
    assert_edges_close(got["edges1"], ref["edges1"])
    assert len(got["submaps"]) == len(ref["submaps"])
    for a, b in zip(got["submaps"], ref["submaps"]):
        np.testing.assert_allclose(a.R0, b["R0"], atol=1e-4)
        np.testing.assert_allclose(a.p0, b["p0"], atol=1e-4)
        assert a.mask.sum() == b["mask"].sum()


def test_fleet_graphed_equals_eager(kfs):
    """fleet_batch 2 (a full batch, then a padded one): every edge and
    submap and each batch's rounds and phases, bitwise; one batched round
    graph and one outputs graph a batch width."""
    got = {}
    for graphed in (True, False):
        r = runner(graphed, fleet_batch=2)
        got[graphed] = (stream(r, port_kfs(kfs)), r)
    (da, a), (db, b) = got[True], got[False]
    assert da == db and len(b.submaps) == 3
    assert state(a) == state(b)
    assert set(a._graphs) == {("batch", 2, W, 1024), ("outputs", 2, W)}
    assert a._graphs[("batch", 2, W, 1024)].calls == \
        sum(w["rounds"] for w in a.window_log)


def test_telemetry_counts_windows_and_rounds(kfs):
    """With telemetry on, each window step is a `gba.window` span and
    counts in `gba.windows`, its rounds in `gba.rounds`, as the window
    log has them."""
    telemetry.reset()
    telemetry.enable()
    try:
        r = runner(True)
        stream(r, kfs)
        snap = telemetry.snapshot()
    finally:
        telemetry.disable()
        telemetry.reset()
    log = r.window_log
    assert snap["counters"]["gba.windows"] == len(log) > 0
    assert snap["counters"]["gba.rounds"] == sum(w["rounds"] for w in log)
    assert snap["spans"]["gba.window"]["count"] == len(log)


def test_graphed_functions_read_nothing_back(kfs):
    """No op inside a round (both phases), a batched round, a condense or
    a batch's outputs reads a device value back to the host (a CUDA graph
    cannot capture one): the watch of tests/test_torch_steady_graph.py."""
    r = runner(False)
    inp = tuple(t(a) for a in window_inputs(port_kfs(kfs[:W]), W))
    found = {}
    for fine in (False, True):
        with _HostReads() as mode:
            r._round_fn(W, 1024, fine)((inp[2], inp[3]),
                                       (inp[0], inp[1], inp[4]))
        found[f"round_{int(fine)}"] = mode.found
    with _HostReads() as mode:
        r._get_condense(W)((), inp[:4])
    found["condense"] = mode.found
    f = runner(False, fleet_batch=2)
    with _HostReads() as mode:      # batched rounds, outputs, host copies
        stream(f, port_kfs(kfs))
    found["fleet"] = mode.found
    assert found == {k: set() for k in found}


def _system(graphed):
    cfg = dataclasses.replace(tconfig.small_test_config(),
                              gba=tconfig.GBAConfig(**GBA))
    s = SlamSystem(cfg, enable_gba=True, device="cpu", step_graphs=graphed)
    s.gba = HbaRunner(cfg, device="cpu", step_graphs=graphed,
                      **_runner_kw())
    return s


def test_system_passes_step_graphs_to_both(kfs):
    for graphed in (True, False):
        s = SlamSystem(tconfig.small_test_config(), enable_gba=True,
                       device="cpu", step_graphs=graphed)
        assert s.odom.step_graphs is graphed and s.gba.step_graphs is graphed


def test_checkpoint_with_a_window_in_flight(kfs, tmp_path):
    """Saved with graphs on and a window and its condense in flight: the
    file holds host copies of the in-flight outputs, none of them a
    graph's buffer, and no graph; resumed, the stream ends with the edges
    and submaps of the run that went on, bitwise."""
    pk = port_kfs(kfs)
    a = _system(True)
    for k in pk[:7]:
        a.gba.add_keyframe(k)
    assert a.gba._inflight_step is not None
    assert a.gba._inflight_cond is not None
    held = {x.untyped_storage().data_ptr() for g in a.gba._graphs.values()
            for x in g.static + list(g.inputs) + list(g.extras)}
    flight = list(a.gba._inflight_step[1]) + list(a.gba._inflight_cond[1:])
    assert not {x.untyped_storage().data_ptr() for x in flight} & held
    path = str(tmp_path / "ckpt")
    a.save_checkpoint(path)
    with open(path, "rb") as f:
        assert b"_graphs" not in f.read()
    b = _system(True)
    b.load_checkpoint(path)
    assert not b.gba._graphs
    for s in (a, b):
        for k in pk[7:]:
            s.gba.add_keyframe(k)
        s.gba.flush()
    assert len(a.gba.submaps) == 3
    assert state(a.gba) == state(b.gba)
