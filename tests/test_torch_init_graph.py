"""The init path as step graphs (`SlamPipeline(step_graphs=True)`, the
default), on the CPU: an init-window scan ("init_accum"), a dynamic-init
round of each phase ("init_round", "init_round_aligned") and a successful
init's map build, refresh, re-integration and first window BA
("init_map"), and the partial queue drain through the K = 1 steady graph
("steady").

A StepGraph on the CPU runs the card's buffer logic with the step eager
(tests/test_torch_steady_graph.py), so a result the pipeline keeps without
copying shows here as a difference from the eager path
(`step_graphs=False`). Held bitwise: a failed dynamic init and its reset,
an init, a reset and a second init that replays the same round graphs
(tests/test_torch_init_graph_cuda.py's scenario); the window's clouds
flushed mid-init; a checkpoint taken mid-window; partial drains at a
correction and at the end of a run. Held within the parity tests'
tolerances: the graphed dynamic init against the JAX package's
`_jit_init_round`/`_jit_align` loop on the same numpy window (the port's
alignment runs eagerly between the phases).
`tests/test_torch_init_graph_cuda.py` holds the captured graphs to the
eager path on the card.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voxelslam_tpu import config as jconfig
from voxelslam_tpu.core.state import NavState as JNavState
from voxelslam_tpu.pipeline import SlamPipeline as JPipeline
from voxelslam_tpu_torch.pipeline import SlamPipeline, SlamSystem

from test_torch_init_graph_cuda import (INIT_GRAPHS, RESET_AT, drain_run,
                                        drive, init_cfg, init_packets, phases)
from test_torch_steady_graph import _watch

torch.set_num_threads(1)


def _np_tree(obj):
    return {f.name: getattr(obj, f.name).numpy().copy()
            for f in dataclasses.fields(obj)}


def _record(pipe, snaps):
    """Per dynamic init: the window and states it starts from, each
    round's (aligned, [r0, r1, ev0]) and the states a success builds the
    map from."""
    real_init, real_fn, real_map = (pipe._dynamic_init, pipe._init_round_fn,
                                    pipe._init_map)

    def dynamic_init():
        snaps.append(dict(win=_np_tree(pipe.win),
                          window=_np_tree(pipe.init_win), rounds=[]))
        return real_init()

    def round_fn(aligned):
        fn = real_fn(aligned)

        def rnd(states, inputs):
            out = fn(states, inputs)
            snaps[-1]["rounds"].append((aligned, out[1][0].numpy().copy()))
            return out
        return rnd

    def init_map(states):
        snaps[-1]["final"] = _np_tree(states)
        return real_map(states)
    pipe._dynamic_init, pipe._init_round_fn = dynamic_init, round_fn
    pipe._init_map = init_map


@pytest.fixture(scope="module")
def packets():
    return init_packets()


@pytest.fixture(scope="module")
def runs(packets):
    """The shared scenario both ways; the graphed run also keeps its graph
    objects as they were before the reset into session 2."""
    res = {}
    for graphed in (True, False):
        pipe = SlamPipeline(init_cfg(), collect_clouds=True, device="cpu",
                            step_graphs=graphed)
        log, snaps, before = {}, [], {}
        _watch(pipe, log)
        _record(pipe, snaps)

        def hook(k, p):
            if k == RESET_AT:
                before.update(p._graphs)
        events, xs, poses = drive(pipe, packets, hook)
        res[graphed] = dict(events=events, xs=xs, poses=poses, log=log,
                            snaps=snaps, before=before, pipe=pipe)
    return res


def test_init_graphs_equal_eager(runs):
    g, e = runs[True], runs[False]
    assert phases(g["events"]).count("init_failed") == 1
    assert phases(g["events"]).count("init_done") == 2
    assert g["events"] == e["events"]
    assert np.array_equal(g["xs"], e["xs"])
    assert g["poses"] == e["poses"]
    assert [[(a, r.tobytes()) for a, r in s["rounds"]] for s in g["snaps"]] \
        == [[(a, r.tobytes()) for a, r in s["rounds"]] for s in e["snaps"]]
    assert not e["pipe"]._graphs


def test_round_graphs_persist_across_resets(runs):
    """One graph a name for the whole run: the second init after a reset
    replays the graphs of the first; a round graph is called once a round
    of its phase, the map graph once a successful init."""
    g = runs[True]
    graphs, snaps = g["pipe"]._graphs, g["snaps"]
    assert set(graphs) == set(INIT_GRAPHS) | {"steady"}
    assert all(graphs[n] is g["before"][n] for n in INIT_GRAPHS)
    rounds = [a for s in snaps for a, _ in s["rounds"]]
    assert graphs["init_round"].calls == rounds.count(False) >= 9
    assert graphs["init_round_aligned"].calls == rounds.count(True) >= 2
    assert graphs["init_map"].calls == 2
    assert graphs["init_accum"].calls == phases(g["events"]).count(
        "init_accum") + 3


def test_init_graphs_read_nothing_back(runs):
    """No op inside an init graph (or the steady step) reads a device
    value back to the host (tests/test_torch_steady_graph.py's watch)."""
    log = runs[True]["log"]
    assert set(log) == set(INIT_GRAPHS) | {"steady"}
    assert all(v == [] for v in log.values()), log


def test_flush_mid_init_emits_the_window_clouds(packets):
    """flush() while the init window fills: the clouds come from the
    device window, the same both ways, and are the scans' own."""
    clouds = {}
    for graphed in (True, False):
        pipe = SlamPipeline(init_cfg(), collect_clouds=True, device="cpu",
                            step_graphs=graphed)
        for pkt in packets[8:13]:
            pipe.process_scan(*pkt)
        assert pipe.win_count == 3 and not pipe.init_done
        want = pipe.init_win.scans[:3].numpy().copy()
        sps = pipe.flush()
        clouds[graphed] = [(sp.cloud.tobytes(), sp.p.tobytes()) for sp in sps]
        assert np.array_equal(np.stack([sp.cloud for sp in sps]), want)
        assert all(sp.cloud_mask.sum() > 100 for sp in sps)
    assert clouds[True] == clouds[False]


def test_checkpoint_mid_init_window(packets, tmp_path):
    """A checkpoint with the init window half filled on the device: the
    resumed system initializes and runs on bitwise as the one that went
    on."""
    path = str(tmp_path / "mid_init.ckpt")
    cfg = init_cfg()

    def make():
        return SlamSystem(cfg, enable_loop=False, device="cpu")
    a = make()
    for pkt in packets[8:13]:
        a.process_scan(*pkt)
    assert a.odom.win_count == 3 and not a.odom.init_done
    a.save_checkpoint(path)
    b = make()
    b.load_checkpoint(path)
    outs = [[s.process_scan(*pkt) for pkt in packets[13:20]] for s in (a, b)]
    assert outs[0] == outs[1] and "init_done" in phases(outs[0])
    sp = [[(p.R.tobytes(), p.p.tobytes(), p.cloud.tobytes())
           for p in s.odom.flush()] for s in (a, b)]
    assert sp[0] == sp[1] and len(sp[0]) >= 6


def test_partial_drain_equals_eager(packets):
    """batch_scans = 4: partial queues drained at a correction and at the
    end of the run go through the K = 1 steady graph, bitwise the eager
    drain, with no host read inside the step."""
    res = {}
    for graphed in (True, False):
        pipe = SlamPipeline(init_cfg(batch_scans=4), device="cpu",
                            step_graphs=graphed)
        log = {}
        _watch(pipe, log)
        res[graphed] = drain_run(pipe, packets[8:32]) + (pipe, log)
    (ev_g, xs_g, p_g, pipe, log), (ev_e, xs_e, p_e, _, _) = (res[True],
                                                             res[False])
    assert ev_g == ev_e
    assert np.array_equal(xs_g, xs_e) and p_g == p_e
    assert pipe._graphs["steady"].calls == 4 and log["steady"] == []


# --------------------------------------------------------------------------
# against the JAX package
# --------------------------------------------------------------------------

def _jax_cfg():
    return jconfig.SlamConfig(
        map=jconfig.MapConfig(capacities=(1 << 11, 1 << 12, 1 << 12),
                              unique_max=(1024, 1024, 2048), win_size=6),
        odom=jconfig.OdometryConfig(point_max=1024, imu_max=64),
        lba=jconfig.LocalBAConfig(factor_max=256, win_size=6))


@pytest.fixture(scope="module")
def jax_init(runs):
    """The JAX package's dynamic-init loop (`_jit_init_round` at the
    phase's gates, `_jit_align` between the phases) from the window and
    states the graphed port's successful first init started from."""
    snap = runs[True]["snaps"][1]
    jp = JPipeline(_jax_cfg(), collect_clouds=False)
    cfg = jp.cfg
    w = snap["window"]
    inputs = [jnp.asarray(w[k]) for k in ("scans", "masks", "trs")]
    imu = [jnp.asarray(w[k]) for k in ("imu_g", "imu_a", "imu_dt", "imu_m")]
    states = JNavState(**{k: jnp.asarray(v) for k, v in snap["win"].items()})
    rounds, aligned, conv_thr = [], False, cfg.init.converge_thre
    for rnd in range(cfg.init.max_rounds):
        if aligned:
            gates = cfg.map.min_eigen_value, cfg.map.plane_thr[0]
        else:
            gates = cfg.init.min_eigen_value, cfg.init.plane_thr
        states, r0, r1, ev = jp._jit_init_round(
            *inputs, states, *imu, jnp.float32(gates[0]),
            jnp.float32(gates[1]))
        rounds.append((aligned, np.array([r0, r1, ev], np.float32)))
        r0, r1 = float(r0), float(r1)
        if abs(r0 - r1) / max(r0, 1e-9) < conv_thr and rnd >= 2:
            if not aligned:
                states = jp._jit_align(states)
                aligned = True
                conv_thr = 0.01
                continue
            break
    return dict(rounds=rounds,
                final={k: np.asarray(getattr(states, k))
                       for k in ("R", "p", "v", "bg", "ba", "g")})


def test_dynamic_init_matches_jax(runs, jax_init):
    """The same rounds at the same phases; each round's residuals and
    degeneracy eigenvalue within 1e-3 relative and the states the map is
    built from within 1e-4 (tests/test_torch_pipeline.py's tolerances for
    the BA residuals, the eigenvalue and the emitted frame)."""
    snap = runs[True]["snaps"][1]
    port, ref = snap["rounds"], jax_init["rounds"]
    assert [a for a, _ in port] == [a for a, _ in ref]
    for (_, a), (_, b) in zip(port, ref):
        np.testing.assert_allclose(a, b, rtol=1e-3)
    for k, v in jax_init["final"].items():
        np.testing.assert_allclose(snap["final"][k], v, atol=1e-4,
                                   err_msg=k)
