"""The port's session files against the JAX package's (`io/sessions.py`):
byte-identical writers, each reader on the other's files, the offline
multi-session reload (`load_previous_sessions`: keyframes and descriptor
database), and `SlamSystem`'s `save()` / `previous_maps` round trip.

The session is tests/test_sessions.py's: 3 * win_size simulated box-room
scans at their true poses. The JAX reload runs once, in a module fixture.
"""

import copy
import os

import numpy as np
import pytest
import torch

from voxelslam_tpu import config as jconfig
from voxelslam_tpu.io import sessions as jses
from voxelslam_tpu.io import simulator as sim
from voxelslam_tpu.pipeline.loop import LoopEdge as JEdge, \
    LoopPipeline as JLoop
from voxelslam_tpu.pipeline.odometry import ScanPose as JScanPose
from voxelslam_tpu.pipeline.system import SlamSystem as JSystem
from voxelslam_tpu_torch import config as tconfig
from voxelslam_tpu_torch.io import sessions as tses
from voxelslam_tpu_torch.loop import btc as tbtc
from voxelslam_tpu_torch.pipeline import LoopPipeline, SlamSystem
from voxelslam_tpu_torch.pipeline.loop import LoopEdge
from voxelslam_tpu_torch.pipeline.odometry import ScanPose

from test_torch_helpers import n, t

torch.set_num_threads(1)


def _rot(rng):
    a = rng.normal(size=3)
    return sim._exp(a / np.linalg.norm(a) * rng.uniform(0.1, 2.5))


def _scan_pose(cls, rng, i, n_pts=50):
    """tests/test_sessions.py's random scan pose, as `cls`."""
    pts = rng.uniform(-5, 5, (n_pts, 3)).astype(np.float32)
    mask = np.ones(n_pts, np.float32)
    mask[::7] = 0.0                      # masked rows are not written
    return cls(t=0.1 * i, R=_rot(rng), p=rng.normal(size=3),
               v=rng.normal(size=3), v6=rng.uniform(1e-6, 1e-3, 6),
               cloud=pts, cloud_mask=mask, session=0,
               bg=rng.normal(scale=1e-3, size=3),
               ba=rng.normal(scale=1e-2, size=3),
               g=np.array([0.0, 0.0, -9.81]) + rng.normal(scale=1e-3, size=3))


def _edges(cls, seed=3):
    rng = np.random.default_rng(seed)
    return [cls(id_a=a, id_b=b, ord_a=oa, ord_b=ob, R=_rot(rng),
                t=rng.normal(size=3), v6=np.full(6, 1e-6))
            for a, b, oa, ob in ((0, 1, 4, 9), (1, 0, 2, 7), (1, 1, 0, 5))]


def _write(mod, scan_pose_cls, edge_cls, kind, d):
    """Write one kind of file with package `mod` under directory d; returns
    the written paths."""
    rng = np.random.default_rng(0)
    os.makedirs(d, exist_ok=True)
    if kind == "pcd":
        pts = rng.normal(size=(123, 3)).astype(np.float32)
        inten = rng.uniform(0, 255, 123).astype(np.float32)
        mod.write_pcd(os.path.join(d, "a.pcd"), pts, inten)
        mod.write_pcd(os.path.join(d, "b.pcd"), pts[:5])
        return ["a.pcd", "b.pcd"]
    sps = [_scan_pose(scan_pose_cls, rng, i) for i in range(4)]
    if kind == "lidarstate":
        mod.write_lidarstate(os.path.join(d, "alidarState.txt"), sps)
        return ["alidarState.txt"]
    if kind == "session":
        mod.save_session(os.path.join(d, "s"), sps)
        return sorted(os.path.join("s", f)
                      for f in os.listdir(os.path.join(d, "s")))
    mod.write_edges(os.path.join(d, "edge.txt"), _edges(edge_cls),
                    ["sessA", "sessB"],
                    extra_lines=["gone sessA 1 2 0 0 0 0 0 0 1"])
    return ["edge.txt"]


@pytest.mark.parametrize("kind", ["pcd", "lidarstate", "session", "edges"])
def test_written_files_are_byte_identical(tmp_path, kind):
    jp = _write(jses, JScanPose, JEdge, kind, str(tmp_path / "jax"))
    tp = _write(tses, ScanPose, LoopEdge, kind, str(tmp_path / "port"))
    assert tp == jp and (kind != "session" or len(tp) == 5)
    for f in tp:
        with open(tmp_path / "jax" / f, "rb") as a, \
                open(tmp_path / "port" / f, "rb") as b:
            assert a.read() == b.read(), f


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_each_reader_reads_the_other(tmp_path, writer):
    """Files of one package through both readers: the same arrays (the
    readers are numpy on both sides, so exactly equal), edges turned so
    id_a <= id_b, the unknown session's line kept."""
    mod, spc, ec = ((jses, JScanPose, JEdge) if writer == "jax"
                    else (tses, ScanPose, LoopEdge))
    d = str(tmp_path)
    for kind in ("pcd", "session", "edges"):
        _write(mod, spc, ec, kind, d)
    pj, ij = jses.read_pcd(os.path.join(d, "a.pcd"))
    pt, it = tses.read_pcd(os.path.join(d, "a.pcd"))
    np.testing.assert_array_equal(pt, pj)
    np.testing.assert_array_equal(it, ij)
    assert pt.shape == (123, 3)
    sj, st = jses.load_session(os.path.join(d, "s")), \
        tses.load_session(os.path.join(d, "s"))
    assert len(st) == len(sj) == 4
    for a, b in zip(st, sj):
        assert a.t == b.t
        for f in ("R", "p", "v", "bg", "ba", "g", "v6", "cloud",
                  "cloud_mask"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                          err_msg=f)
        assert len(a.cloud) == 50 - 8          # rows 0, 7, ..., 49 masked
    names = ["sessA", "sessB"]
    ej, aj = jses.read_edges(os.path.join(d, "edge.txt"), names)
    et, at = tses.read_edges(os.path.join(d, "edge.txt"), names)
    assert at == aj and len(at) == 1
    assert len(et) == len(ej) == 3
    for a, b in zip(et, ej):
        assert (a.id_a, a.id_b, a.ord_a, a.ord_b) == \
            (b.id_a, b.id_b, b.ord_a, b.ord_b)
        assert a.id_a <= a.id_b
        np.testing.assert_array_equal(a.R, b.R)
        np.testing.assert_array_equal(a.t, b.t)


def _prior_session(cls, W, n_win=3):
    """tests/test_sessions.py's prior session: n_win * W box-room scans
    with their true poses, body-frame clouds."""
    normals, dsp = sim.box_room(half_extent=(9.0, 7.0, 3.0),
                                center=(2.0, 0.0, 1.0))
    traj = sim.make_trajectory(duration=4.0, speed=1.0, wobble=0.2,
                               yaw_rate=0.25, ramp=1.2)
    sps, t0 = [], 0.1
    for i in range(n_win * W):
        scan = sim.lidar_scan(traj, t0, t0 + 0.1, normals, dsp, n_az=100,
                              n_el=16, noise=0.01, seed=i)
        body = scan["points"][scan["hit"]].astype(np.float32)
        R, p, v = traj.state_at(t0 + 0.1)
        sps.append(cls(t=t0, R=R, p=p, v=v, v6=np.full(6, 1e-4), cloud=body,
                       cloud_mask=np.ones(len(body), np.float32), session=0))
        t0 += 0.1
    return sps


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """A prior session and an edge.txt (one edge to a session not loaded)
    written by the JAX package, and the JAX reload of them."""
    d = str(tmp_path_factory.mktemp("maps"))
    cfg = jconfig.small_test_config()
    W = cfg.lba.win_size
    jses.save_session(os.path.join(d, "prior"), _prior_session(JScanPose, W))
    e = _edges(JEdge)
    e[0].id_a, e[0].id_b, e[0].ord_a, e[0].ord_b = 0, 0, 9, 29
    jses.write_edges(os.path.join(d, "edge.txt"), e[:2], ["prior", "other"])
    jlp = JLoop(cfg)
    jses.load_previous_sessions(jlp, d, ["prior"])
    return d, W, jlp


def test_load_previous_sessions_matches_jax(saved):
    """The same keyframes (scan ids, poses within 1e-5, equal mask counts,
    clouds within 1e-5 m), the same descriptor-DB frames (planes and
    triangles: masks and codes equal, geometry within 1e-3, as
    tests/test_torch_loop.py holds `extract`), edges and kept lines."""
    d, W, jlp = saved
    lp = LoopPipeline(tconfig.small_test_config(), device="cpu")
    tses.load_previous_sessions(lp, d, ["prior"])
    assert len(lp.scan_poses) == len(jlp.scan_poses) == 1
    assert len(lp.scan_poses[0]) == 3 * W
    kt, kj = lp.keyframes[0], jlp.keyframes[0]
    assert len(kt) == len(kj) == 3
    for a, b in zip(kt, kj):
        assert (a.kf_index, a.scan_id, a.session) == \
            (b.kf_index, b.scan_id, b.session)
        np.testing.assert_allclose(a.R0, b.R0, atol=1e-5)
        np.testing.assert_allclose(a.p0, b.p0, atol=1e-5)
        assert a.mask.sum() == b.mask.sum() > 1000
        np.testing.assert_array_equal(a.mask, b.mask)
        np.testing.assert_allclose(a.cloud, b.cloud, atol=1e-5)
    ft, fj = lp.dbs[0].frames, jlp.dbs[0].frames
    assert sorted(ft) == sorted(fj) and len(ft) >= 1
    for f in ft:
        for k in ("plane_valid", "tri_valid", "binary"):
            np.testing.assert_array_equal(ft[f][k], fj[f][k], err_msg=k)
        for k in ("plane_centers", "plane_normals", "sides", "verts"):
            np.testing.assert_allclose(ft[f][k], fj[f][k], atol=1e-3,
                                       err_msg=k)
    assert len(lp.lp_edges) == len(jlp.lp_edges) == 1
    assert (lp.lp_edges[0].ord_a, lp.lp_edges[0].ord_b) == (9, 29)
    np.testing.assert_array_equal(lp.lp_edges[0].R, jlp.lp_edges[0].R)
    assert lp._edge_absent_lines == jlp._edge_absent_lines
    assert len(lp._edge_absent_lines) == 1


def test_reloaded_db_answers_a_query(saved):
    """As tests/test_sessions.py: a query from the first reloaded
    keyframe's cloud finds a candidate in the reloaded database."""
    d, _, _ = saved
    lp = LoopPipeline(tconfig.small_test_config(), device="cpu")
    tses.load_previous_sessions(lp, d, ["prior"])
    kf0 = lp.keyframes[0][0]
    desc = {k: n(v) for k, v in tbtc.extract(t(kf0.cloud), t(kf0.mask),
                                              lp.btc_cfg).items()}
    assert lp.dbs[0].search(desc, skip_near=-1, current_frame=1 << 30)


def _fill_and_save(sysm, sps, edge):
    """The live session's scan poses and one loop edge, then save()."""
    sysm.loop.scan_poses[sysm.loop.cur_session].extend(copy.deepcopy(sps))
    sysm.loop.lp_edges.append(edge)
    sysm.save("run1")


def test_system_save_and_previous_maps_round_trip(tmp_path):
    """`SlamSystem(savepath=...)`: save() writes the live session and
    edge.txt byte for byte as the JAX system does; a new system with
    `previous_maps=[name]` reloads them as searchable session 0 (the same
    keyframes and DB frames as the JAX system's reload), names the live
    session after it, and a second save keeps the edges of the reloaded
    sessions."""
    cfg_t, cfg_j = tconfig.small_test_config(), jconfig.small_test_config()
    W = cfg_t.lba.win_size
    sps_t = _prior_session(ScanPose, W, n_win=2)
    sps_j = _prior_session(JScanPose, W, n_win=2)
    rng = np.random.default_rng(5)
    R, tv = _rot(rng), rng.normal(size=3)
    dirs = {k: str(tmp_path / k) for k in ("jax", "port")}
    tsys = SlamSystem(cfg_t, device="cpu", savepath=dirs["port"])
    _fill_and_save(tsys, sps_t, LoopEdge(id_a=0, id_b=0, ord_a=9, ord_b=19,
                                         R=R, t=tv, v6=np.full(6, 1e-6)))
    jsys = JSystem(cfg_j, savepath=dirs["jax"])
    _fill_and_save(jsys, sps_j, JEdge(id_a=0, id_b=0, ord_a=9, ord_b=19,
                                      R=R, t=tv, v6=np.full(6, 1e-6)))
    files = sorted(os.listdir(os.path.join(dirs["port"], "run1")))
    assert len(files) == 2 * W + 1
    for f in [os.path.join("run1", f) for f in files] + ["edge.txt"]:
        with open(os.path.join(dirs["jax"], f), "rb") as a, \
                open(os.path.join(dirs["port"], f), "rb") as b:
            assert a.read() == b.read(), f

    t2 = SlamSystem(cfg_t, device="cpu", savepath=dirs["port"],
                    previous_maps=["run1"])
    j2 = JSystem(cfg_j, savepath=dirs["jax"], previous_maps=["run1"])
    assert t2.session_names == j2.session_names == ["run1", "live1"]
    assert t2.loop.cur_session == 1 and len(t2.loop.keyframes[0]) == 2
    assert [k.scan_id for k in t2.loop.keyframes[0]] == \
        [k.scan_id for k in j2.loop.keyframes[0]] == [W - 1, 2 * W - 1]
    assert sorted(t2.loop.dbs[0].frames) == sorted(j2.loop.dbs[0].frames)
    assert len(t2.loop.lp_edges) == 1
    t2.save()
    with open(os.path.join(dirs["port"], "edge.txt")) as f:
        assert f.read().split()[:4] == ["run1", "run1", "9", "19"]
    assert sorted(os.listdir(os.path.join(dirs["port"], "live1"))) == \
        ["alidarState.txt"]
