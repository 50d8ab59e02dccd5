"""The port's global BA against the JAX package's, stage by stage and as a
chain: `lm_lidar`, `all_pairs_edges`, `condense_window`, one round of the
window step, one whole window (rounds, phase path, poses, residuals,
Hessian), the streamed `add_keyframe` + `flush`, and `total_ba` and
`top_down` started from the JAX runner's own state through `convert`.

Keyframes are built as in tests/test_gba.py (clouds sampled at true poses
along a line, stored poses perturbed) at 2,048 points. The JAX side runs
once, in a module fixture. Its window step is one `while_loop`, so the
fixture also drives a host loop of the same rounds through a jitted JAX
round (insert, refit, harvest, 3-iteration LM) to read the JAX phase path;
that loop is held against `HbaRunner._run_window` itself.
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voxelslam_tpu.ba import optimizers as jopt
from voxelslam_tpu.config import SlamConfig as JSlamConfig, GBAConfig as JGBA
from voxelslam_tpu.core import so3 as jso3
from voxelslam_tpu.gba import HbaRunner as JRunner
from voxelslam_tpu.io import simulator as sim
from voxelslam_tpu.map import voxel_map as jvm
from voxelslam_tpu.parallel import dist_gba as jdist
from voxelslam_tpu.pipeline.loop import Keyframe as JKeyframe, \
    LoopPipeline as JLoop
from voxelslam_tpu.pipeline.odometry import ScanPose as JScanPose
from voxelslam_tpu_torch import config as tconfig, convert
from voxelslam_tpu_torch.ba import optimizers as topt
from voxelslam_tpu_torch.gba import HbaRunner
from voxelslam_tpu_torch.parallel import dist_gba as tdist
from voxelslam_tpu_torch.pipeline.loop import LoopPipeline
from voxelslam_tpu_torch.pipeline.odometry import ScanPose

from test_torch_helpers import n, t

torch.set_num_threads(1)

P = 2048
CAP, UNIQ = 1 << 12, 1024
N_KF = 9
GBA = dict(voxel_size=3.0, win_size=5, stride=2, total_max_iter=4)


def _runner_kw():
    return dict(kf_point_max=P, capacity=CAP, unique_max=UNIQ)


def make_keyframes(n_kf, seed=3, perturb=0.02):
    """tests/test_gba.py's keyframes: a line of poses, clouds sampled at
    the true poses, the stored poses (after the first) perturbed."""
    rng = np.random.default_rng(seed)
    world = sim.sample_scene(sim.make_scene(), per_m2=10.0, seed=seed,
                             noise=0.01)
    kfs = []
    for i in range(n_kf):
        yaw = 0.08 * i
        R0 = np.array([[np.cos(yaw), -np.sin(yaw), 0],
                       [np.sin(yaw), np.cos(yaw), 0], [0, 0, 1.0]])
        p0 = np.array([0.6 * i, 0.25 * i, 1.0])
        near = world[np.linalg.norm(world - p0, axis=1) < 18.0]
        sub = near[rng.permutation(len(near))[:P]]
        cloud = np.zeros((P, 3), np.float32)
        mask = np.zeros((P,), np.float32)
        cloud[:len(sub)] = (sub - p0) @ R0
        mask[:len(sub)] = 1.0
        Rk, pk = R0, p0
        if perturb > 0 and i > 0:
            Rk = R0 @ np.asarray(jso3.exp(jnp.array(rng.normal(0, perturb,
                                                               3))))
            pk = p0 + rng.normal(0, perturb * 4, 3)
        kfs.append(JKeyframe(kf_index=i, scan_id=i, session=0, R0=Rk, p0=pk,
                             cloud=cloud, mask=mask, jour=float(i)))
    return kfs


def port_kfs(kfs):
    return convert.keyframes_from_numpy([dataclasses.asdict(k) for k in kfs])


def records(objs):
    return [dataclasses.asdict(o) for o in objs]


def window_inputs(kfs, W):
    clouds = np.zeros((W, P, 3), np.float32)
    masks = np.zeros((W, P), np.float32)
    Rs = np.tile(np.eye(3, dtype=np.float32), (W, 1, 1))
    ps = np.zeros((W, 3), np.float32)
    wmask = np.zeros((W,), np.float32)
    for i, kf in enumerate(kfs):
        clouds[i], masks[i] = kf.cloud, kf.mask
        Rs[i], ps[i], wmask[i] = kf.R0, kf.p0, 1.0
    return clouds, masks, Rs, ps, wmask


def jax_round_fn(runner, W):
    """One round of the JAX window step (hba.py:113-126) as its own jitted
    function of (vox, min_eig, thr, clouds, masks, Rs, ps, wmask), also
    returning the harvested factors."""
    coarse, _ = runner._map_cfgs(W)

    def rnd(vox, min_eig, thr, clouds, masks, Rs, ps, wmask):
        lv = jvm.empty_level(CAP, W)
        mp = jnp.arange(W, dtype=jnp.int32)
        tr = jnp.zeros((P,))
        for i in range(W):
            lv, _, _, _ = jvm.insert_scan_level(
                lv, vox, UNIQ, clouds[i] @ Rs[i].T + ps[i], clouds[i], tr,
                masks[i] * wmask[i], i, 0.0)
        levels = jvm.refresh_planes((lv,), coarse, Rs, ps, mp, W,
                                    min_eigen_value=min_eig, plane_thr=thr)
        factors = jvm.harvest_t(levels, coarse, mp, 1024)
        return factors, jopt.lm_lidar(Rs, ps, factors, wmask, max_iter=3)
    return jax.jit(rnd)


def round_params(cfg, phase):
    g = cfg.gba
    if phase > 0:
        return cfg.map.voxel_size, cfg.map.min_eigen_value, cfg.map.plane_thr[0]
    return g.voxel_size, g.min_eigen_value, g.eigen_value_thr


def jax_host_loop(rnd, cfg, inputs):
    """The JAX window step's rounds driven from the host: returns the
    outputs, the phase after each round and each round's relative
    decrease."""
    clouds, masks, Rs, ps, wmask = (jnp.asarray(a) for a in inputs)
    phase, phases, rels, r0_first = 0, [], [], None
    while len(phases) < max(cfg.gba.total_max_iter, 2) and phase < 2:
        _, (Rs, ps, H, r0, r1, _) = rnd(*round_params(cfg, phase), clouds,
                                        masks, Rs, ps, wmask)
        rel = float(jnp.abs(r0 - r1) / jnp.maximum(r0, 1e-12))
        phase += int(rel < 0.05)
        phases.append(phase)
        rels.append(rel)
        r0_first = r0 if r0_first is None else r0_first
    return dict(Rs=np.asarray(Rs), ps=np.asarray(ps), H=np.asarray(H),
                r0=float(r0_first), r1=float(r1), phases=phases, rels=rels)


def jax_stream(jr, kfs):
    """The JAX runner `jr`'s stream over `kfs`: every keyframe added, then
    flushed. Returns the dicts add_keyframe returned, flush's, and the
    runner's state after the flush (records of its submaps, edges and
    pending keyframes). tests/test_torch_fleet.py holds the fleet to it."""
    dicts = [jr.add_keyframe(k) for k in kfs]
    flush = jr.flush()
    return dicts, flush, dict(
        submaps=records(jr.submaps), edges1=records(jr.edges1),
        edges2=records(jr.edges2), _pending=records(jr._pending))


@pytest.fixture(scope="module")
def jax_side():
    cfg = JSlamConfig(gba=JGBA(**GBA))
    kfs = make_keyframes(N_KF)
    W = GBA["win_size"]
    jr = JRunner(cfg, **_runner_kw())
    rnd = jax_round_fn(jr, W)
    out = dict(cfg=cfg, kfs=kfs, rnd=rnd)

    # the factors of one round with frames 3 and 4 dead, and the JAX LM
    # on them
    inp = window_inputs(kfs[:W], W)
    wdead = np.array([1, 1, 1, 0, 0], np.float32)
    factors, _ = rnd(*round_params(cfg, 0),
                     *(jnp.asarray(a) for a in inp[:4]), jnp.asarray(wdead))
    lm = jopt.lm_lidar(jnp.asarray(inp[2]), jnp.asarray(inp[3]), factors,
                       jnp.asarray(wdead), max_iter=3)
    out["round_dead"] = (inp[:4] + (wdead,), jax.tree.map(np.asarray, factors),
                         jax.tree.map(np.asarray, lm))
    out["round"] = tuple(jax.tree.map(np.asarray, rnd(
        *round_params(cfg, 0), *(jnp.asarray(a) for a in inp))))[1]
    out["host_loop"] = jax_host_loop(rnd, cfg, inp)
    out["window"] = jr._run_window(kfs[:W], W)

    # the stream, flushed; then total BA and top-down on its state
    out["dicts"], out["flush"], out["after_flush"] = jax_stream(jr, kfs)
    out["total"] = jr.total_ba()
    out["edges2"] = records(jr.edges2)
    out["after_total"] = dict(out["after_flush"], edges2=out["edges2"])
    jlp = JLoop(cfg)
    fill_loop(jlp, copy.deepcopy(kfs), JScanPose)     # top_down moves them
    corr = jr.top_down(jlp)
    out["top_down"] = dict(
        R=np.stack([sp.R for sp in jlp.scan_poses[0]]),
        p=np.stack([sp.p for sp in jlp.scan_poses[0]]),
        dx_R=corr.dx_R, dx_p=corr.dx_p, n_edges=len(jlp.lp_edges))
    return out


def fill_loop(lp, kfs, scan_pose_cls):
    """One session whose scan poses are the keyframe poses (one scan per
    keyframe), as tests/test_gba.py's top-down test builds it."""
    lp.new_session()
    for kf in kfs:
        lp.scan_poses[0].append(scan_pose_cls(
            t=float(kf.kf_index), R=kf.R0.copy(), p=kf.p0.copy(),
            v=np.zeros(3), v6=np.full(6, 1e-4), cloud=kf.cloud,
            cloud_mask=kf.mask, session=0))
        lp.keyframes[0].append(kf)


def port_cfg():
    return tconfig.SlamConfig(gba=tconfig.GBAConfig(**GBA))


def port_runner():
    return HbaRunner(port_cfg(), device="cpu", **_runner_kw())


def assert_edges_close(te, je, pose_tol=1e-4, v6_rtol=1e-3):
    assert len(te) == len(je) > 0
    for a, b in zip(te, je):
        assert (a.id_a, a.id_b, a.ord_a, a.ord_b) == \
            (b["id_a"], b["id_b"], b["ord_a"], b["ord_b"])
        np.testing.assert_allclose(a.R, b["R"], atol=pose_tol)
        np.testing.assert_allclose(a.t, b["t"], atol=pose_tol)
        np.testing.assert_allclose(a.v6, b["v6"], rtol=v6_rtol)


def test_lm_lidar_matches_jax_live_and_dead_frames(jax_side):
    """The JAX round's harvested factors (frames 3 and 4 dead) through
    both LMs, each called on its own: poses within 1e-5 (3 f32 LU solves),
    residuals within rtol
    1e-5, H within 1e-5 of its largest entry; dead frames stay exactly at
    their input pose."""
    (clouds, masks, Rs, ps, wmask), factors, jout = jax_side["round_dead"]
    tout = topt.lm_lidar(t(Rs), t(ps), tuple(t(f) for f in factors),
                         t(wmask), max_iter=3)
    jR, jp, jH, jr0, jr1, jconv = jout
    tR, tp, tH, tr0, tr1, tconv = (n(x) for x in tout)
    np.testing.assert_allclose(tR, jR, atol=1e-5)
    np.testing.assert_allclose(tp, jp, atol=1e-5)
    np.testing.assert_allclose(tH, jH, atol=1e-5 * np.abs(jH).max())
    np.testing.assert_allclose([tr0, tr1], [jr0, jr1], rtol=1e-5)
    assert bool(tconv) == bool(jconv)
    assert float(tr1) < float(tr0)
    np.testing.assert_array_equal(tR[3:], Rs[3:])
    np.testing.assert_array_equal(tp[3:], ps[3:])


def test_all_pairs_edges_matches_jax():
    """Random window poses and a Hessian with a few entries under 1e-6:
    the same pairs, validity mask and (f32) edges."""
    rng = np.random.default_rng(0)
    W = 6
    from scipy.spatial.transform import Rotation
    Rs = Rotation.from_rotvec(rng.normal(0, 0.5, (W, 3))).as_matrix()
    Rs = Rs.astype(np.float32)
    ps = rng.normal(0, 3, (W, 3)).astype(np.float32)
    H = rng.normal(0, 10, (6 * W, 6 * W)).astype(np.float32)
    H[6 * 0 + 2, 6 * 3 + 2] = 5e-7        # pair (0, 3) invalid
    H[6 * 2 + 5, 6 * 4 + 5] = -2e-7       # pair (2, 4) invalid
    jo = [np.asarray(a) for a in jdist.all_pairs_edges(
        jnp.asarray(Rs), jnp.asarray(ps), jnp.asarray(H), W)]
    to = [n(a) for a in tdist.all_pairs_edges(t(Rs), t(ps), t(H), W)]
    np.testing.assert_array_equal(to[3], jo[3])
    assert (~jo[3]).sum() == 2
    np.testing.assert_allclose(to[0], jo[0], atol=1e-6)
    np.testing.assert_allclose(to[1], jo[1], atol=1e-5)
    np.testing.assert_allclose(to[2], jo[2], rtol=1e-6)


def test_condense_window_matches_jax(jax_side):
    """The window merged into first-frame coordinates and downsampled at
    voxel_size/8 from identical numpy poses: the same occupied cells
    (equal masks) and centroids within 1e-5 m."""
    kfs = jax_side["kfs"][:5]
    clouds, masks, Rs, ps, _ = window_inputs(kfs, 5)
    jd, jm = jdist.condense_window(jnp.asarray(clouds), jnp.asarray(masks),
                                   jnp.asarray(Rs), jnp.asarray(ps),
                                   1.0 / 8.0, P)
    td, tm = tdist.condense_window(t(clouds), t(masks), t(Rs), t(ps),
                                   1.0 / 8.0, P)
    np.testing.assert_array_equal(n(tm), np.asarray(jm))
    assert np.asarray(jm).sum() > 1000
    np.testing.assert_allclose(n(td), np.asarray(jd), atol=1e-5)


def test_one_round_matches_jax(jax_side):
    """One coarse round (map build, plane refit, harvest, 3-iteration LM)
    from identical inputs: poses within 1e-5, residuals within rtol 1e-5,
    H within 1e-5 of its largest entry."""
    cfg = port_cfg()
    runner = port_runner()
    coarse, _ = runner._map_cfgs(5)
    inp = window_inputs(jax_side["kfs"][:5], 5)
    out = runner._build_and_lm(coarse, 1024, *round_params(cfg, 0),
                               *(t(a) for a in inp))
    jR, jp, jH, jr0, jr1, _ = jax_side["round"]
    tR, tp, tH, tr0, tr1, _ = (n(x) for x in out)
    np.testing.assert_allclose(tR, jR, atol=1e-5)
    np.testing.assert_allclose(tp, jp, atol=1e-5)
    np.testing.assert_allclose(tH, jH, atol=1e-5 * np.abs(jH).max())
    np.testing.assert_allclose([tr0, tr1], [jr0, jr1], rtol=1e-5)


def test_run_window_matches_jax(jax_side):
    """A whole window: the same rounds and phase path as the JAX loop
    (whose host-driven mirror agrees with `_run_window` within 1e-5),
    poses within 1e-4 (m and rotation entries), r0/r1 within rtol 1e-4,
    H within 1e-3 of its largest entry, the edges' v6 within rtol 1e-3;
    and the window pulls the perturbed poses together (r1 < r0)."""
    hl, (jR, jp, jH, jr0, jr1) = jax_side["host_loop"], jax_side["window"]
    np.testing.assert_allclose(hl["ps"], jp, atol=1e-5)
    np.testing.assert_allclose(hl["Rs"], jR, atol=1e-5)
    runner = port_runner()
    kfs = port_kfs(jax_side["kfs"][:5])
    tR, tp, tH, tr0, tr1 = runner._run_window(kfs, 5)
    log = runner.window_log[-1]
    assert log["phases"] == hl["phases"], (log, hl["rels"])
    assert log["rounds"] == len(hl["phases"]) == log["syncs"]
    np.testing.assert_allclose(tR, jR, atol=1e-4)
    np.testing.assert_allclose(tp, jp, atol=1e-4)
    np.testing.assert_allclose([tr0, tr1], [jr0, jr1], rtol=1e-4)
    np.testing.assert_allclose(tH, jH, atol=1e-3 * np.abs(jH).max())
    te, je = [], []
    runner._extract_edges(kfs, tR, tp, tH, te)
    JRunner._extract_edges(jax_side["kfs"][:5], jR, jp, jH, je)
    assert_edges_close(te, records(je))
    assert tr1 < tr0


def test_dead_frame_padding_keeps_the_window(jax_side):
    """The same window padded with three dead frames (W_pad 8, as the
    total BA pads to a power of two): the live poses within 1e-4 of the
    unpadded run."""
    kfs = port_kfs(jax_side["kfs"][:5])
    a = port_runner()._run_window(kfs, 5)
    b = port_runner()._run_window(kfs, 8)
    np.testing.assert_allclose(b[0], a[0], atol=1e-4)
    np.testing.assert_allclose(b[1], a[1], atol=1e-4)
    assert b[2].shape == (48, 48)


def test_stream_add_keyframe_and_flush_match_jax(jax_side):
    """The dispatch-ahead stream: each add_keyframe returns the JAX dict
    (edges and submaps lag one and two windows; r0/r1 within rtol 1e-4),
    flush returns the last window's, and the edges and submaps agree
    (edges as in test_run_window_matches_jax; submap poses within 1e-4,
    equal mask counts)."""
    runner = port_runner()
    dicts = [runner.add_keyframe(k) for k in port_kfs(jax_side["kfs"])]
    flush = runner.flush()
    for a, b in zip(dicts + [flush], jax_side["dicts"] + [jax_side["flush"]]):
        assert (a is None) == (b is None)
        if a is None:
            continue
        assert a.keys() == b.keys()
        for k in a:
            if isinstance(b[k], float):
                np.testing.assert_allclose(a[k], b[k], rtol=1e-4, err_msg=k)
            else:
                assert a[k] == b[k], (k, a, b)
    ref = jax_side["after_flush"]
    assert len(runner.submaps) == len(ref["submaps"]) == 3
    assert_edges_close(runner.edges1, ref["edges1"])
    for a, b in zip(runner.submaps, ref["submaps"]):
        assert (a.scan_id, a.session, a.kf_index) == \
            (b["scan_id"], b["session"], b["kf_index"])
        np.testing.assert_allclose(a.R0, b["R0"], atol=1e-4)
        np.testing.assert_allclose(a.p0, b["p0"], atol=1e-4)
        assert a.mask.sum() == b["mask"].sum() > 100
    assert len(runner._pending) == len(ref["_pending"])
    assert runner.host_syncs == sum(w["rounds"] for w in runner.window_log) \
        + 2 * len(runner.window_log)


def test_bottom_up_matches_jax_stream(jax_side):
    """`bottom_up` (every keyframe added, then flushed) leaves the JAX
    runner's state after its stream and flush: the same edges (as in
    test_run_window_matches_jax), submaps (poses within 1e-4, equal mask
    counts) and pending keyframes."""
    runner = port_runner()
    runner.bottom_up(port_kfs(jax_side["kfs"]))
    ref = jax_side["after_flush"]
    assert_edges_close(runner.edges1, ref["edges1"])
    assert len(runner.submaps) == len(ref["submaps"])
    for a, b in zip(runner.submaps, ref["submaps"]):
        assert a.scan_id == b["scan_id"]
        np.testing.assert_allclose(a.p0, b["p0"], atol=1e-4)
        assert a.mask.sum() == b["mask"].sum()
    assert [k.scan_id for k in runner._pending] == \
        [k["scan_id"] for k in ref["_pending"]]


def test_total_ba_from_jax_state(jax_side):
    """The port's total BA over the JAX runner's submaps (installed with
    `convert.load_hba_state`): the same return dict and edges2, at
    tolerances looser than one window's, because this window is weakly
    constrained. It holds 3 submaps and a dead frame, and its fine rounds
    harvest 14-26 planes for 18 free coordinates: one such round from
    identical inputs parts by 1.2e-3 m in position while its residual
    agrees within 1e-4 (the LM's weak directions). So: the same phase path
    as the JAX loop ([0, 1, 1, 1]), r0 within rtol 1e-5, r1 within 1e-4 of
    r0, edge poses within 2e-3 (m and rotation entries), v6 within rtol
    1e-2."""
    runner = port_runner()
    convert.load_hba_state(runner, copy.deepcopy(jax_side["after_flush"]))
    out = runner.total_ba()
    ref = jax_side["total"]
    assert out.keys() == ref.keys()
    assert out["n_edges"] == ref["n_edges"] > 0
    assert out["hierarchy_rounds"] == ref["hierarchy_rounds"] == 0
    assert runner.window_log[-1]["phases"] == [0, 1, 1, 1]
    np.testing.assert_allclose(out["r0"], ref["r0"], rtol=1e-5)
    np.testing.assert_allclose(out["r1"], ref["r1"], atol=1e-4 * ref["r0"])
    assert_edges_close(runner.edges2, jax_side["edges2"], pose_tol=2e-3,
                       v6_rtol=1e-2)
    assert runner.window_log[-1]["W"] == 4       # 3 submaps + 1 dead frame


def test_total_ba_hierarchy_condenses_every_submap(jax_side):
    """More submaps than `max_window`: the level is condensed window by
    window and every submap still gets an edge."""
    runner = port_runner()
    convert.load_hba_state(runner, copy.deepcopy(jax_side["after_flush"]))
    out = runner.total_ba(max_window=2)
    assert out["hierarchy_rounds"] >= 1
    touched = {e.ord_a for e in runner.edges2} | {e.ord_b
                                                 for e in runner.edges2}
    assert {sm.scan_id for sm in runner.submaps} <= touched


def test_top_down_from_jax_state(jax_side):
    """Top-down from the JAX runner's state after its total BA: both loop
    pipelines get the same edges, and the scan poses written back agree
    within 1e-4 (the pose-graph solve in f32), as does the correction."""
    runner = port_runner()
    convert.load_hba_state(runner, copy.deepcopy(jax_side["after_total"]))
    lp = LoopPipeline(port_cfg(), device="cpu")
    fill_loop(lp, port_kfs(jax_side["kfs"]), ScanPose)
    corr = runner.top_down(lp)
    ref = jax_side["top_down"]
    assert len(lp.lp_edges) == ref["n_edges"] > 0
    np.testing.assert_allclose(np.stack([sp.R for sp in lp.scan_poses[0]]),
                               ref["R"], atol=1e-4)
    np.testing.assert_allclose(np.stack([sp.p for sp in lp.scan_poses[0]]),
                               ref["p"], atol=1e-4)
    np.testing.assert_allclose(corr.dx_R, ref["dx_R"], atol=1e-4)
    np.testing.assert_allclose(corr.dx_p, ref["dx_p"], atol=1e-4)
    # the keyframes follow their scans
    for kf in lp.keyframes[0]:
        np.testing.assert_array_equal(kf.p0, lp.scan_poses[0][kf.scan_id].p)

