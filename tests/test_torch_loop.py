"""Loop-closure modules of the port against the JAX package: anchor
condensation, the pose-graph solve, ICP (single and batched), BTC
extraction and the descriptor DB (dict path and native store).

Inputs are made with numpy from seeds; keyframe clouds come from the
simulator's scene, merged over 10 scans like the pipeline's keyframes.
The JAX extraction of the two keyframes runs once, in a module fixture."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from voxelslam_tpu.io import simulator as sim
from voxelslam_tpu.loop import btc as jbtc
from voxelslam_tpu.loop import condense as jcd
from voxelslam_tpu.loop import icp as jicp
from voxelslam_tpu.loop import posegraph as jpg
from voxelslam_tpu.ops.downsample import voxel_downsample as jdownsample
from voxelslam_tpu_torch.loop import btc as tbtc
from voxelslam_tpu_torch.loop import condense as tcd
from voxelslam_tpu_torch.loop import icp as ticp
from voxelslam_tpu_torch.loop import posegraph as tpg

from test_torch_helpers import n, t

torch.set_num_threads(1)

KF_POINTS = 8192          # LoopPipeline.kf_point_max


def keyframe_cloud(scene, origin, yaw, seed, n_az=120, n_el=16):
    """10 scans around (origin, yaw) merged into its body frame and
    downsampled at 0.1 m to KF_POINTS rows (the pipeline's keyframe)."""
    rng = np.random.default_rng(seed)
    R0 = Rotation.from_rotvec([0.0, 0.0, yaw]).as_matrix()
    pts = []
    for _ in range(10):
        p = np.asarray(origin) + rng.normal(0, 0.3, 3) * [1, 1, 0.1]
        dirs, _ = sim.scan_directions(n_az, n_el)
        pc, hit = sim.raycast(p, R0, dirs, scene)
        w = pc[hit] @ R0.T + p
        pts.append(w + rng.normal(0, 0.01, w.shape))
    body = (np.concatenate(pts) - np.asarray(origin)) @ R0
    down, dmask, _ = jdownsample(jnp.asarray(body, jnp.float32),
                                 jnp.ones(len(body), jnp.float32), 0.1,
                                 KF_POINTS)
    return (np.array(down), np.array(dmask, np.float32), R0,
            np.asarray(origin, np.float64))


@pytest.fixture(scope="module")
def visits():
    """Two visits of one place and the JAX extraction of each."""
    scene = sim.make_scene()
    kfs = [keyframe_cloud(scene, (0.0, 0.0, 1.0), 0.0, 1),
           keyframe_cloud(scene, (1.0, -1.5, 1.0), 0.7, 9)]
    ext = jax.jit(jbtc.extract, static_argnums=2)
    descs = [{k: np.array(v) for k, v in
              ext(jnp.asarray(c), jnp.asarray(m), jbtc.BtcConfig()).items()}
             for c, m, _, _ in kfs]
    return kfs, descs


# --------------------------------------------------------------------------
# condense (host numpy copy)
# --------------------------------------------------------------------------

def _chain(seed, n_poses=40):
    rng = np.random.default_rng(seed)
    Rs = Rotation.from_rotvec(np.cumsum(rng.normal(0, 0.05, (n_poses, 3)),
                                        axis=0)).as_matrix()
    ps = np.cumsum(rng.normal(0, 0.3, (n_poses, 3)), axis=0)
    v6 = rng.uniform(1e-5, 1e-3, (n_poses, 6))
    return Rs, ps, v6


@pytest.mark.parametrize("seed", [0, 1])
def test_condensed_chain_matches_jax(seed):
    Rs, ps, v6 = _chain(seed)
    cj, ct = jcd.CondensedChain(Rs, ps, v6), tcd.CondensedChain(Rs, ps, v6)
    np.testing.assert_allclose(ct.G, cj.G, rtol=0, atol=1e-12)
    np.testing.assert_allclose(ct.cw, cj.cw, rtol=0, atol=1e-12)
    for a, b in ((0, 39), (3, 17), (17, 18)):
        for x, y in zip(ct.segment_edge(a, b), cj.segment_edge(a, b)):
            np.testing.assert_allclose(x, y, rtol=0, atol=1e-12)
        rR, _, cov = cj.segment_edge(a, b)
        np.testing.assert_allclose(tcd.residual_info(rR, cov),
                                   jcd.residual_info(rR, cov), rtol=1e-12)
        np.testing.assert_allclose(ct.interp_fraction(a, b),
                                   cj.interp_fraction(a, b), atol=1e-12)


@pytest.mark.parametrize("seed", [0, 1])
def test_segment_correction_and_se3_match_jax(seed):
    Rs, ps, v6 = _chain(seed)
    rng = np.random.default_rng(seed + 10)
    La_R, La_p = tcd.se3_exp(rng.normal(0, 0.05, 6))
    Lb_R, Lb_p = tcd.se3_exp(rng.normal(0, 0.05, 6))
    cj, ct = jcd.CondensedChain(Rs, ps, v6), tcd.CondensedChain(Rs, ps, v6)
    for x, y in zip(tcd.apply_segment_correction(ct, 2, 30, La_R, La_p,
                                                 Lb_R, Lb_p),
                    jcd.apply_segment_correction(cj, 2, 30, La_R, La_p,
                                                 Lb_R, Lb_p)):
        np.testing.assert_allclose(x, y, rtol=0, atol=1e-12)
    xi = rng.normal(0, 0.3, (5, 6))
    for x, y in zip(tcd.se3_exp(xi), jcd.se3_exp(xi)):
        np.testing.assert_allclose(x, y, rtol=0, atol=1e-12)
    np.testing.assert_allclose(tcd.se3_log(Rs[3], ps[3]),
                               jcd.se3_log(Rs[3], ps[3]), atol=1e-12)


# --------------------------------------------------------------------------
# pose graph
# --------------------------------------------------------------------------

def _pose_graph(seed, K=64, n_loop=6, E=128):
    """A drifted 64-pose chain (odometry edges with full 6x6 information)
    plus loop edges carrying the true relative poses; padded to E edges
    with dead (W6 = 0) rows."""
    rng = np.random.default_rng(seed)
    th = np.linspace(0, 2 * np.pi, K)
    gt_R = Rotation.from_rotvec(np.stack([0.05 * np.sin(3 * th),
                                          0.03 * np.cos(2 * th), th], 1))
    gt_R = gt_R.as_matrix()
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
    for _ in range(n_loop):
        a, b = sorted(rng.choice(K, 2, replace=False))
        ii.append(a), jj.append(b)
        rel_R.append(gt_R[a].T @ gt_R[b])
        rel_p.append(gt_R[a].T @ (gt_p[b] - gt_p[a]))
        W6.append(np.eye(6) * 1e4)
    pad = E - len(ii)
    f = np.float32
    return (np.stack(est_R).astype(f), np.stack(est_p).astype(f),
            np.array(ii + [0] * pad, np.int32),
            np.array(jj + [0] * pad, np.int32),
            np.concatenate([rel_R, np.tile(np.eye(3), (pad, 1, 1))]).astype(f),
            np.concatenate([rel_p, np.zeros((pad, 3))]).astype(f),
            np.concatenate([W6, np.zeros((pad, 6, 6))]).astype(f))


def test_edge_blocks_match_jax_jacfwd():
    """Closed-form residual Jacobians against the JAX package's jacfwd."""
    R, p, ii, jj, rR, rp, W6 = _pose_graph(0)
    rj, Jij, Jjj = jpg._edge_blocks(jnp.asarray(R), jnp.asarray(p),
                                    jnp.asarray(ii), jnp.asarray(jj),
                                    jnp.asarray(rR), jnp.asarray(rp),
                                    jnp.asarray(W6[:, :, 0]))
    rt, Jit, Jjt = tpg._edge_blocks(t(R), t(p), t(ii, torch.int32),
                                    t(jj, torch.int32), t(rR), t(rp))
    np.testing.assert_allclose(n(rt), np.asarray(rj), atol=1e-5)
    np.testing.assert_allclose(n(Jit), np.asarray(Jij), atol=1e-4)
    np.testing.assert_allclose(n(Jjt), np.asarray(Jjj), atol=1e-4)


def test_assemble_pose_system_full_matches_jax():
    R, p, ii, jj, rR, rp, W6 = _pose_graph(1)
    K = R.shape[0]
    rj, Jij, Jjj = jpg._edge_blocks(jnp.asarray(R), jnp.asarray(p),
                                    jnp.asarray(ii), jnp.asarray(jj),
                                    jnp.asarray(rR), jnp.asarray(rp),
                                    jnp.asarray(W6[:, :, 0]))
    Hj, gj, cj = jpg.assemble_pose_system_full(
        jnp.asarray(ii), jnp.asarray(jj), rj, Jij, Jjj, jnp.asarray(W6), K)
    Ht, gt, ct = tpg.assemble_pose_system_full(
        t(ii, torch.int32), t(jj, torch.int32), t(np.array(rj)),
        t(np.array(Jij)), t(np.array(Jjj)), t(W6), K)
    scale = float(np.abs(np.asarray(Hj)).max())
    np.testing.assert_allclose(n(Ht), np.asarray(Hj), atol=1e-5 * scale)
    np.testing.assert_allclose(n(gt), np.asarray(gj),
                               atol=1e-5 * float(np.abs(gj).max()))
    np.testing.assert_allclose(float(ct), float(cj), rtol=1e-4)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_solve_pose_graph_full_matches_jax(seed):
    """Six damped GN steps with the gauge on the first pose: the same
    poses (within 1e-4) and a solve that actually closes the loops."""
    R, p, ii, jj, rR, rp, W6 = _pose_graph(seed)
    Rj, pj, chij = jax.jit(jpg.solve_pose_graph_full, static_argnums=7)(
        *(jnp.asarray(a) for a in (R, p, ii, jj, rR, rp, W6)), 6)
    Rt, pt, chit = tpg.solve_pose_graph_full(
        t(R), t(p), t(ii, torch.int32), t(jj, torch.int32), t(rR), t(rp),
        t(W6), iters=6)
    np.testing.assert_allclose(n(Rt), np.asarray(Rj), atol=1e-4)
    np.testing.assert_allclose(n(pt), np.asarray(pj), atol=1e-4)
    np.testing.assert_allclose(float(chit), float(chij), rtol=1e-3)
    assert float(np.abs(n(pt) - p).max()) > 0.1     # the graph moved


# --------------------------------------------------------------------------
# ICP
# --------------------------------------------------------------------------

def _icp_clouds(kfs):
    """The two visits' keyframe clouds thinned to 2048 points (0.25 m
    voxels), so 20 ICP steps of brute-force 5-NN stay quick on the CPU."""
    out = []
    for c, m, _, _ in kfs:
        d, dm, _ = jdownsample(jnp.asarray(c), jnp.asarray(m), 0.25, 2048)
        out.append((np.array(d), np.array(dm, np.float32)))
    return out


def _icp_inits(kfs, rng):
    """Perturbations of the true current -> matched transform of the two
    visits: three that converge and one too far off to pass."""
    (_, _, RA, pA), (_, _, RB, pB) = kfs
    R_t, t_t = RA.T @ RB, RA.T @ (pB - pA)
    inits = []
    for k, (ang, off) in enumerate(((0.03, 0.15), (0.05, 0.2), (0.02, 0.1),
                                    (0.8, 3.0))):
        dR = Rotation.from_rotvec(rng.normal(0, ang, 3)).as_matrix()
        inits.append(((R_t @ dR).astype(np.float32),
                      (t_t + rng.normal(0, off, 3)).astype(np.float32)))
    return inits, R_t, t_t


def test_icp_single_matches_jax(visits):
    kfs, _ = visits
    (cA, mA), (cB, mB) = _icp_clouds(kfs)
    inits, R_t, t_t = _icp_inits(kfs, np.random.default_rng(0))
    R0, t0 = inits[0]
    oj = jax.jit(jicp.icp_point_to_plane)(
        jnp.asarray(cB), jnp.asarray(mB), jnp.asarray(cA), jnp.asarray(mA),
        jnp.asarray(R0), jnp.asarray(t0))
    ot = ticp.icp_point_to_plane(t(cB), t(mB), t(cA), t(mA), t(R0), t(t0))
    assert bool(ot["ok"]) == bool(oj["ok"]) is True
    np.testing.assert_allclose(n(ot["R"]), np.asarray(oj["R"]), atol=1e-4)
    np.testing.assert_allclose(n(ot["t"]), np.asarray(oj["t"]), atol=1e-4)
    np.testing.assert_allclose(n(ot["eig0"]), np.asarray(oj["eig0"]),
                               rtol=1e-3)
    assert np.abs(n(ot["R"]) - R_t).max() < 0.02
    assert np.linalg.norm(n(ot["t"]) - t_t) < 0.1


def test_icp_batch_matches_jax_vmap(visits):
    """The ICP with a leading batch axis (the JAX package's vmap over
    candidates) on four candidates, one of which fails: `ok` equal, R and t within 1e-4."""
    kfs, _ = visits
    (cA, mA), (cB, mB) = _icp_clouds(kfs)
    inits, _, _ = _icp_inits(kfs, np.random.default_rng(1))
    R0 = np.stack([a for a, _ in inits])
    t0 = np.stack([b for _, b in inits])
    tgt = np.stack([cA] * 4)
    tmask = np.stack([mA] * 4)
    oj = jax.jit(jax.vmap(jicp.icp_point_to_plane,
                          in_axes=(None, None, 0, 0, 0, 0)))(
        jnp.asarray(cB), jnp.asarray(mB), jnp.asarray(tgt),
        jnp.asarray(tmask), jnp.asarray(R0), jnp.asarray(t0))
    ot = ticp.icp_point_to_plane(t(cB), t(mB), t(tgt), t(tmask), t(R0),
                                 t(t0))
    ok_j = np.asarray(oj["ok"])
    np.testing.assert_array_equal(n(ot["ok"]), ok_j)
    assert ok_j.tolist() == [True, True, True, False]
    np.testing.assert_allclose(n(ot["R"])[:3], np.asarray(oj["R"])[:3],
                               atol=1e-4)
    np.testing.assert_allclose(n(ot["t"])[:3], np.asarray(oj["t"])[:3],
                               atol=1e-4)


# --------------------------------------------------------------------------
# BTC extraction
# --------------------------------------------------------------------------

@pytest.mark.parametrize("visit", [0, 1])
def test_extract_matches_jax(visits, visit):
    """Default ground profile on a keyframe cloud: masks and codes equal,
    geometry within 1e-3."""
    kfs, descs = visits
    c, m, _, _ = kfs[visit]
    dj = descs[visit]
    dt = {k: n(v) for k, v in tbtc.extract(t(c), t(m),
                                           tbtc.BtcConfig()).items()}
    for k in ("plane_valid", "tri_valid", "binary"):
        np.testing.assert_array_equal(dt[k], dj[k], err_msg=k)
    for k in ("plane_centers", "plane_normals", "sides", "verts"):
        np.testing.assert_allclose(dt[k], dj[k], atol=1e-3, err_msg=k)
    assert dj["tri_valid"].sum() > 100 and dj["plane_valid"].sum() >= 6


def test_extract_planes_and_corners_match_jax(visits):
    """The two stages on their own; corners from the same planes."""
    kfs, _ = visits
    c, m, _, _ = kfs[0]
    cfg_j, cfg_t = jbtc.BtcConfig(), tbtc.BtcConfig()
    pj = [np.array(x) for x in jax.jit(jbtc._extract_planes,
                                       static_argnums=2)(
        jnp.asarray(c), jnp.asarray(m), cfg_j)]
    pt = [n(x) for x in tbtc._extract_planes(t(c), t(m), cfg_t)]
    np.testing.assert_array_equal(pt[2], pj[2])                 # valid
    for a, b in zip(pt[:2] + pt[3:], pj[:2] + pj[3:]):
        np.testing.assert_allclose(a, b, atol=1e-3)
    cj = [np.array(x) for x in jax.jit(jbtc._projection_corners,
                                       static_argnums=5)(
        jnp.asarray(c), jnp.asarray(m), *(jnp.asarray(x) for x in pj[:3]),
        cfg_j)]
    ct = [n(x) for x in tbtc._projection_corners(
        t(c), t(m), *(torch.as_tensor(x) for x in pj[:3]), cfg_t)]
    np.testing.assert_array_equal(ct[3], cj[3])                 # valid
    np.testing.assert_array_equal(ct[2], cj[2])                 # codes
    np.testing.assert_array_equal(ct[1], cj[1])                 # summary
    np.testing.assert_allclose(ct[0], cj[0], atol=1e-3)         # corners
    assert cj[3].sum() >= 20


def test_profiles_match_jax():
    for fly in (False, True):
        for ex in ("projection", "structural"):
            dj = dataclasses.asdict(jbtc.BtcConfig.profile(fly, extractor=ex))
            dt = dataclasses.asdict(tbtc.BtcConfig.profile(fly, extractor=ex))
            assert dt == dj and dt["extractor"] == ex
            assert tbtc.BtcConfig.profile(fly, extractor=ex).code_bits == \
                jbtc.BtcConfig.profile(fly, extractor=ex).code_bits


# --------------------------------------------------------------------------
# descriptor DB
# --------------------------------------------------------------------------

@pytest.mark.parametrize("use_native", [False, True])
def test_db_search_verify_match_jax(visits, use_native):
    """The revisit is retrieved and verified with the same candidates,
    votes, pairs and transform as the JAX package's DB."""
    _, (dA, dB) = visits
    jdb = jbtc.DescriptorDB(jbtc.BtcConfig(), use_native=use_native)
    tdb = tbtc.DescriptorDB(tbtc.BtcConfig(), use_native=use_native)
    assert (tdb._nat is not None) == use_native
    for db in (jdb, tdb):
        db.add(0, dA)
    cj = jdb.search(dB, skip_near=-1, current_frame=1 << 30)
    ct = tdb.search(dB, skip_near=-1, current_frame=1 << 30)
    assert cj and ct == cj
    vj = jdb.verify(dB, cj[0][0], cj[0][2])
    vt = tdb.verify(dB, ct[0][0], ct[0][2])
    assert vj is not None and vt["votes"] == vj["votes"]
    assert vt["overlap"] == vj["overlap"] > 0.4
    np.testing.assert_allclose(vt["R"], vj["R"], atol=1e-12)
    np.testing.assert_allclose(vt["t"], vj["t"], atol=1e-12)


def _random_desc(cfg, seed, n_tri=120):
    r = np.random.default_rng(seed)
    sides = np.sort(r.uniform(2.0, 30.0, (n_tri, 3)), axis=-1).astype(
        np.float32)
    binary = (r.random((n_tri, 3, cfg.code_bits)) > 0.5).astype(np.float32)
    return dict(sides=sides, binary=binary, tri_valid=r.random(n_tri) > 0.2)


@pytest.mark.parametrize("skip,cur", [(1, 5), (-1, 1 << 30), (1, 3)])
def test_native_store_matches_dict_path(skip, cur):
    """The native store (csrc/btcdb.cpp) against the dict path: same
    candidates, votes and kept pairs, including the near-frame skip and
    the max_matches cap."""
    cfg = dataclasses.replace(tbtc.BtcConfig(), max_matches=40)
    rng = np.random.default_rng(0)
    py = tbtc.DescriptorDB(cfg, use_native=False)
    nat = tbtc.DescriptorDB(cfg, use_native=True)
    query = _random_desc(cfg, 99)
    for f in range(6):
        d = _random_desc(cfg, f)
        if f in (2, 4):          # frames sharing many triangles
            take = slice(0, 60)
            d["sides"][take] = query["sides"][take] + rng.normal(
                0, 0.02, (60, 3)).astype(np.float32)
            d["binary"][take] = query["binary"][take]
            d["tri_valid"][take] = True
        py.add(f, d)
        nat.add(f, d)
    out_py = py.search(query, skip_near=skip, current_frame=cur)
    out_nat = nat.search(query, skip_near=skip, current_frame=cur)
    assert out_py and out_nat == out_py
    assert any(len(m) == cfg.max_matches for _, _, m in out_py)


def test_native_store_rejects_bad_shapes():
    from voxelslam_tpu_torch import native
    db = native.BtcDb(0.2, 150)
    with pytest.raises(ValueError):
        db.add(0, np.zeros((4, 3)), np.zeros((4, 3, 49)), np.ones(4))
    db.close()


def test_failed_store_build_raises(monkeypatch, tmp_path):
    """The loop pipeline's descriptor DB never falls back to the dict path:
    a store that does not compile raises with the compiler's message."""
    from voxelslam_tpu_torch import native
    (tmp_path / "btcdb.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(native, "_CSRC", tmp_path)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_libs", {})
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        tbtc.DescriptorDB(tbtc.BtcConfig())
