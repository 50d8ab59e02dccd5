"""The loop closure's programs and the odometry's loop hooks as step graphs
(`LoopPipeline(step_graphs=True)` and `SlamPipeline(step_graphs=True)`,
the defaults) against `step_graphs=False`, bitwise, and against the JAX
package. On the CPU a StepGraph runs its function eagerly over its static
buffers, so these tests hold the staging of the inputs, the padding of a
short ICP chunk, the one host copy of a call's results, the masked map
rebuild and the checkpoint; tests/test_torch_loop_graph_cuda.py (whose
scenarios these tests share) and chip_smoke.py hold capture and replay on
the card.

The JAX package runs in module fixtures: its ICP over a padded chunk
(`_jit_icp_b`) and over one candidate (`_jit_icp`) on
tests/test_torch_loop.py's two visits, and tests/test_torch_correction.py's
pipeline run (`jax_run`) for the correction and the keyframe reload.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voxelslam_tpu import config as jconfig
from voxelslam_tpu.io import simulator as jsim
from voxelslam_tpu.pipeline.loop import LoopPipeline as JLoop
from voxelslam_tpu_torch import config as tconfig
from voxelslam_tpu_torch.map import voxel_map as tvm
from voxelslam_tpu_torch.pipeline import LoopPipeline, SlamPipeline
from voxelslam_tpu_torch.pipeline.graphs import leaves
from voxelslam_tpu_torch.pipeline.system import SlamSystem

from test_torch_correction import (DX_P, DX_R, _assert_state_close,
                                   _port_from_carry, jax_run)  # noqa: F401
from test_torch_init_graph_cuda import init_cfg, init_packets
from test_torch_loop import (_icp_clouds, _icp_inits, _pose_graph,
                             keyframe_cloud)
from test_torch_loop_graph_cuda import (HOOK_SCANS, hook_cfg, hook_graphs,
                                        hook_run, loop_calls, same)
from test_torch_steady_graph import _HostReads

torch.set_num_threads(1)


def _state_bytes(pipe):
    """Every bit of the odometry's window, pose, slot map and map."""
    return [a.numpy().tobytes() for a in leaves(
        (pipe.win, pipe.x, pipe.mp, pipe.levels))]


def _watched(obj, log):
    """Record the host-reading ops of each step `obj._run` dispatches."""
    real = obj._run

    def run(name, fn, *rest):
        mode = _HostReads()
        with mode:
            out = real(name, fn, *rest)
        log.setdefault(name, set()).update(mode.found)
        return out
    obj._run = run


@pytest.fixture(scope="module")
def hooks():
    """tests/test_torch_loop_graph_cuda.py's hook scenario both ways."""
    packets = init_packets()[8:8 + HOOK_SCANS]
    res = {}
    for graphed in (True, False):
        pipe = SlamPipeline(hook_cfg(), collect_clouds=True, device="cpu",
                            step_graphs=graphed)
        log = {}
        _watched(pipe, log)
        res[graphed] = hook_run(pipe, packets) + (pipe, log)
    return res


def test_hook_graphs_equal_eager(hooks):
    """Two corrections (the second, with two keyframes, through the
    first's graph), a gravity-joint solve, a reload and evictions: the
    graphed run's events, poses, clouds and final map bitwise the eager
    run's; one graph a hook, nothing read back inside one."""
    (ev_g, xs_g, p_g, lv_g, pipe, log), (ev_e, xs_e, p_e, lv_e, _, _) = (
        hooks[True], hooks[False])
    assert ev_g == ev_e
    assert np.array_equal(xs_g, xs_e) and p_g == p_e and lv_g == lv_e
    assert sum(bool(e.get("evicted")) for e in ev_g) >= 2
    assert all(e.get("phase") in ("imu_init", "init_accum", "init_done",
                                  "odom")
               for e in ev_g)
    assert hook_graphs(pipe) == {"correction_5x1024": 2, "g_reloc": 1,
                                 "keyframe_reload_1024": 1,
                                 "evict": hook_graphs(pipe)["evict"]}
    for name in hook_graphs(pipe):
        assert log[name] == set(), (name, log[name])


def test_loop_graphs_equal_eager(hooks):
    """The keyframe (merge + extract), ICP chunks of one and of three
    candidates (padded to four) and a pose-graph solve: graphed bitwise
    eager; one graph a shape; nothing read back inside one."""
    poses = hooks[True][4].scan_poses
    got = {}
    for graphed in (True, False):
        lp = LoopPipeline(hook_cfg(), device="cpu", step_graphs=graphed)
        log = {}
        _watched(lp, log)
        got[graphed] = (loop_calls(lp, poses), lp, log)
    (g, lp, log), (e, lp_e, _) = got[True], got[False]
    assert same(g, e)
    assert not lp_e._graphs
    assert {k: v.calls for k, v in lp._graphs.items()} == {
        "keyframe": 2, ("icp", 1): 1, ("icp", 4): 1,
        ("pose_graph", 64, 128): 1}
    assert all(v == set() for v in log.values()), log
    assert len(g["icp1"][0]) == 1 and len(g["icp3"][0]) == 3


# --------------------------------------------------------------------------
# against the JAX package
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def icp_case():
    """tests/test_torch_loop.py's two visits of one place, visit B's cloud
    against visit A's from its four starts (three converge, the last does
    not): the chunk [fail, pass, pass] and the single [pass] as the JAX
    package's `_search_session` verifies them, `_jit_icp_b` over the chunk
    padded with copies of its first candidate and `_jit_icp` over the
    single."""
    scene = jsim.make_scene()
    kfs = [keyframe_cloud(scene, (0.0, 0.0, 1.0), 0.0, 1),
           keyframe_cloud(scene, (1.0, -1.5, 1.0), 0.7, 9)]
    (cA, mA), (cB, mB) = _icp_clouds(kfs)
    inits, _, _ = _icp_inits(kfs, np.random.default_rng(1))
    chunk = [(0, dict(R=R, t=t)) for R, t in (inits[3], inits[0], inits[1])]
    jlp = JLoop(jconfig.SlamConfig())
    pad = chunk + [chunk[0]]
    oj = jlp._jit_icp_b(
        jnp.asarray(cB), jnp.asarray(mB), jnp.asarray(np.stack([cA] * 4)),
        jnp.asarray(np.stack([mA] * 4)),
        jnp.asarray(np.stack([v["R"] for _, v in pad]), jnp.float32),
        jnp.asarray(np.stack([v["t"] for _, v in pad]), jnp.float32))
    one = jlp._jit_icp(jnp.asarray(cB), jnp.asarray(mB), jnp.asarray(cA),
                       jnp.asarray(mA), jnp.asarray(inits[0][0]),
                       jnp.asarray(inits[0][1]))
    src = dataclasses.make_dataclass("Kf", ["cloud", "mask"])
    return dict(src=src(cB, mB), tgt=src(cA, mA), chunk=chunk,
                jax_chunk={k: np.asarray(v) for k, v in oj.items()},
                jax_one={k: np.asarray(v) for k, v in one.items()})


def test_padded_chunk_selects_jax_candidate(icp_case):
    """A chunk of three through the four-candidate program, padded as the
    JAX package pads it: the same verdicts as `_jit_icp_b`, R and t of the
    passing candidates within 1e-4, so the same candidate is the match;
    a chunk of one through the one-candidate program as `_jit_icp`."""
    c = icp_case
    lp = LoopPipeline(tconfig.SlamConfig(), device="cpu")
    ok, R, t = lp._icp_chunk(c["src"], c["chunk"], [c["tgt"]] * 3)
    oj = c["jax_chunk"]
    assert ok.tolist() == oj["ok"][:3].tolist() == [False, True, True]
    assert int(np.argmax(ok)) == int(np.argmax(oj["ok"][:3])) == 1
    np.testing.assert_allclose(R[1:], oj["R"][1:3], atol=1e-4)
    np.testing.assert_allclose(t[1:], oj["t"][1:3], atol=1e-4)
    ok1, R1, t1 = lp._icp_chunk(c["src"], c["chunk"][1:2], [c["tgt"]])
    assert ok1.tolist() == [bool(c["jax_one"]["ok"])] == [True]
    np.testing.assert_allclose(R1[0], c["jax_one"]["R"], atol=1e-4)
    np.testing.assert_allclose(t1[0], c["jax_one"]["t"], atol=1e-4)
    assert set(lp._graphs) == {("icp", 4), ("icp", 1)}


def test_pose_graph_graph_matches_jax():
    """The ("pose_graph", 64, 128) program against the JAX package's
    solve_pose_graph_full with the loop pipeline's six iterations: poses
    within 1e-4 (tests/test_torch_loop.py's tolerance)."""
    from voxelslam_tpu.loop import posegraph as jpg
    R, p, ii, jj, rR, rp, W6 = _pose_graph(0)
    Rj, pj, _ = jpg.solve_pose_graph_full(
        *(jnp.asarray(a) for a in (R, p, ii, jj, rR, rp, W6)), iters=6)
    lp = LoopPipeline(tconfig.SlamConfig(), device="cpu")
    Rt, pt = lp._solve_pose_graph(R, p, ii, jj, rR, rp, W6)
    np.testing.assert_allclose(Rt, np.asarray(Rj), atol=1e-4)
    np.testing.assert_allclose(pt, np.asarray(pj), atol=1e-4)
    assert set(lp._graphs) == {("pose_graph", 64, 128)}


@pytest.mark.parametrize("g_update", [False, True])
def test_correction_graph_matches_jax_and_eager(jax_run, g_update):  # noqa: F811,E501
    """The graphed rebuild (three keyframes in five slots, the window's
    valid frames of W) and, with g_update, the gravity-joint solve: state
    and map as the JAX package's `apply_correction` (tests/test_torch_
    correction.py's tolerances) and bitwise the eager path's."""
    out = {}
    for graphed in (True, False):
        pipe = _port_from_carry(jax_run)
        pipe.step_graphs = graphed
        pipe.apply_correction(DX_R, DX_P, g_update, jax_run["kfs"])
        out[graphed] = (_state_bytes(pipe), pipe)
    pipe = out[True][1]
    _assert_state_close(pipe, jax_run["after"][g_update])
    assert out[True][0] == out[False][0]
    names = {k for k in pipe._graphs if not k.startswith("init_")}
    N = len(jax_run["kfs"][0].cloud)
    assert names == {f"correction_5x{N}"} | ({"g_reloc"} if g_update
                                             else set())


def test_keyframe_reload_graph_matches_jax_and_eager(jax_run):  # noqa: F811
    """The graphed reload: map as the JAX package's insert_keyframe_fixed
    and bitwise the eager path's."""
    out = {}
    for graphed in (True, False):
        pipe = _port_from_carry(jax_run)
        pipe.step_graphs = graphed
        pipe.insert_keyframe_fixed(jax_run["kfs"][0])
        out[graphed] = (_state_bytes(pipe), pipe)
    _assert_state_close(out[True][1], jax_run["after"]["keyframe"])
    assert out[True][0] == out[False][0]


@pytest.mark.parametrize("track", [False, True])
def test_masked_insert_changes_no_bit(track):
    """The rebuild's padding: an all-masked fixed insert leaves a populated
    map bit-identical, and so does an all-masked scan insert into an empty
    window slot of it (the slots from nvalid on in the new map); touched-
    slot tracking on and off."""
    cfg = tconfig.MapConfig(capacities=(1 << 10, 1 << 11, 1 << 11),
                            unique_max=(512, 512, 1024), win_size=4,
                            track_touched=track)
    rng = np.random.default_rng(0)

    def cloud(n=600):
        return (torch.as_tensor(rng.uniform(-4, 4, (n, 3)),
                                dtype=torch.float32),
                torch.as_tensor(rng.random(n) > 0.1, dtype=torch.float32))
    levels = tvm.empty_map(cfg)
    pts, mask = cloud()
    levels = tvm.insert_fixed(levels, cfg, pts, torch.zeros(600), mask, 2.0)
    for slot in (0, 1):
        pts, mask = cloud()
        levels = tvm.insert_scan(levels, cfg, pts + 0.1, pts,
                                 torch.full((600,), 1e-4), mask, slot, 3.0)
    before = [a.numpy().tobytes() for a in leaves(levels)]
    pts, _ = cloud()
    none = torch.zeros(600)
    fixed = tvm.insert_fixed(levels, cfg, pts, none, none, 5.0)
    scan = tvm.insert_scan(levels, cfg, pts, pts, none, none, 3, 5.0)
    for got in (fixed, scan):
        assert [a.numpy().tobytes() for a in leaves(got)] == before


# --------------------------------------------------------------------------
# the system: flags and a checkpoint with the loop's graphs alive
# --------------------------------------------------------------------------

def test_system_passes_step_graphs_to_loop():
    for graphed in (True, False):
        s = SlamSystem(tconfig.small_test_config(), device="cpu",
                       step_graphs=graphed)
        assert s.loop.step_graphs is graphed and s.odom.step_graphs is graphed


def test_checkpoint_with_loop_graphs_alive(tmp_path):
    """Saved after the first keyframes, with the loop's and the odometry's
    graphs alive: the file holds no graph (nor anything naming one), the
    restored system's loop starts without graphs, and it goes on bitwise
    as the saved one does."""
    packets = init_packets()[8:]
    cfg = init_cfg()
    a = SlamSystem(cfg, device="cpu")
    k = 0
    while not a.loop._graphs:
        a.process_scan(*packets[k])
        k += 1
    path = str(tmp_path / "loop.ckpt")
    a.save_checkpoint(path)
    with open(path, "rb") as f:
        raw = f.read()
    assert b"StepGraph" not in raw and b"CUDAGraph" not in raw
    b = SlamSystem(cfg, device="cpu")
    b.load_checkpoint(path)
    assert not b.loop._graphs and b.loop.step_graphs
    assert "keyframe" in a.loop._graphs
    for pkt in packets[k:k + 8]:
        a.process_scan(*pkt)
        b.process_scan(*pkt)
        assert np.array_equal(np.array(a.odom.x.p), np.array(b.odom.x.p))
    assert [(kf.scan_id, kf.cloud.tobytes()) for s in a.loop.keyframes
            for kf in s] == [(kf.scan_id, kf.cloud.tobytes())
                             for s in b.loop.keyframes for kf in s]
