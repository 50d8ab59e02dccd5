"""The port's remaining counterparts of JAX functions that no entry point
reaches, each against the JAX package: sequential preintegration and the
autodiff IMU factor, the diagonal-information pose graph, the two
downsample variants, and the structural BTC extractor.

Inputs are made with numpy from seeds; tolerances are the JAX tests' own
(named at each comparison) or stated there."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voxelslam_tpu.imu import preintegration as jpre
from voxelslam_tpu.io import simulator as sim
from voxelslam_tpu.loop import btc as jbtc
from voxelslam_tpu.loop import posegraph as jpg
from voxelslam_tpu.ops import downsample as jds
from voxelslam_tpu_torch.imu import preintegration as pre
from voxelslam_tpu_torch.loop import btc as tbtc
from voxelslam_tpu_torch.loop import posegraph as tpg
from voxelslam_tpu_torch.ops import downsample as tds

from test_torch_helpers import n, t, to_port, random_states, states_both
from test_torch_imu import _preint_inputs
from test_torch_loop import keyframe_cloud

torch.set_num_threads(1)


# --------------------------------------------------------------------------
# preintegration
# --------------------------------------------------------------------------

def _sequential_inputs():
    """tests/test_imu.py:108-129's samples: 23, the last 5 masked."""
    rng = np.random.default_rng(2)
    N = 23
    gyr = rng.normal(0, 0.4, (N, 3)).astype(np.float32)
    acc = (rng.normal(0, 1.0, (N, 3)) + np.array([0, 0, 9.8])).astype(
        np.float32)
    dt = (np.full(N, 0.005) + rng.random(N) * 0.002).astype(np.float32)
    mask = np.concatenate([np.ones(18), np.zeros(5)]).astype(np.float32)
    bg = np.array([0.01, -0.02, 0.005], np.float32)
    ba = np.array([0.1, -0.05, 0.02], np.float32)
    return (gyr, acc, dt, mask, bg, ba, np.eye(6, dtype=np.float32) * 0.01,
            np.eye(6, dtype=np.float32) * 1e-4)


def test_integrate_sequential_matches_jax_and_integrate():
    """Every field within tests/test_imu.py:126-129's 1e-5 of max(1, |x|),
    against the JAX sequential scan and the port's log-depth integrate."""
    args = _sequential_inputs()
    a = jpre.integrate_sequential(*[jnp.asarray(x) for x in args])
    b = pre.integrate_sequential(*[t(x) for x in args])
    c = pre.integrate(*[t(x) for x in args])
    for f in pre._FIELDS:
        va = np.asarray(getattr(a, f))
        scale = max(1.0, np.abs(va).max())
        np.testing.assert_allclose(n(getattr(b, f)), va, atol=1e-5 * scale,
                                   err_msg=f)
        np.testing.assert_allclose(n(getattr(c, f)), n(getattr(b, f)),
                                   atol=1e-5 * scale, err_msg=f)


@pytest.mark.parametrize("with_gravity", [False, True])
def test_evaluate_matches_jax_and_closed(with_gravity):
    """The jacfwd factor against the JAX package's evaluate and the port's
    evaluate_closed, with one W on every side; each output within 2e-4 of
    its largest entry (tests/test_torch_imu.py's factor tolerance)."""
    ja = jpre.integrate(*[jnp.asarray(x) for x in _preint_inputs(6)])
    tp = to_port(ja, pre.Preint)
    d = random_states(np.random.default_rng(5), 2)
    js, ts = states_both(d)
    W = np.asarray(jpre.cov_inv(ja))
    ref = jax.jit(jpre.evaluate, static_argnums=3)(ja, js[0], js[1],
                                                   with_gravity,
                                                   jnp.asarray(W))
    got = pre.evaluate(tp, ts[0], ts[1], with_gravity, t(W))
    closed = pre.evaluate_closed(tp, ts[0], ts[1], with_gravity, t(W))
    dim = 33 if with_gravity else 30
    assert got[1].shape == (dim, dim) and got[2].shape == (dim,)
    for x, y, z in zip(ref, got, closed):
        x = np.asarray(x)
        s = np.abs(x).max()
        np.testing.assert_allclose(n(y) / s, x / s, atol=2e-4)
        np.testing.assert_allclose(n(z) / s, n(y) / s, atol=2e-4)


# --------------------------------------------------------------------------
# pose graph with diagonal information
# --------------------------------------------------------------------------

def _drifted_circle(K=60):
    """tests/test_loop.py:124-148: a circle whose odometry carries a yaw
    bias, and the true first-to-last relative pose."""
    th = np.linspace(0, 2 * np.pi, K)
    gt_p = np.stack([5 * np.sin(th), 5 * (1 - np.cos(th)), np.zeros(K)], -1)
    gt_R = np.stack([np.array([[np.cos(a), -np.sin(a), 0],
                               [np.sin(a), np.cos(a), 0], [0, 0, 1]])
                     for a in th])
    est_R, est_p = [gt_R[0]], [gt_p[0]]
    bias = np.array(sim._exp(np.array([0, 0, 0.004])))
    for i in range(1, K):
        rel_R = gt_R[i - 1].T @ gt_R[i] @ bias
        rel_p = gt_R[i - 1].T @ (gt_p[i] - gt_p[i - 1])
        est_R.append(est_R[-1] @ rel_R)
        est_p.append(est_p[-1] + est_R[-2] @ rel_p)
    lR = gt_R[0].T @ gt_R[-1]
    lp = gt_R[0].T @ (gt_p[-1] - gt_p[0])
    return (np.stack(est_R).astype(np.float32),
            np.stack(est_p).astype(np.float32), gt_p,
            lR.astype(np.float32), lp.astype(np.float32))


def test_solve_pose_graph_with_chain_edges_matches_jax():
    """odometry_chain_edges plus one loop edge, solved in 8 iterations:
    edges equal to f32 rounding, poses within 1e-3 of the JAX solve, and
    the drift cut below a fifth (tests/test_loop.py:165)."""
    K = 60
    est_R, est_p, gt_p, lR, lp = _drifted_circle(K)
    v6 = np.ones((K, 6), np.float32) * 1e-4
    ej = jpg.odometry_chain_edges(jnp.asarray(est_R), jnp.asarray(est_p),
                                  jnp.asarray(v6))
    et = tpg.odometry_chain_edges(t(est_R), t(est_p), t(v6))
    for a, b in zip(et, ej):
        np.testing.assert_allclose(n(a), np.asarray(b), atol=1e-5)
    assert et[0].dtype == torch.int32

    def with_loop(e, cat, arr):
        ii, jj, rR, rp, info = e
        return (cat([ii, arr(np.array([0], np.int32))]),
                cat([jj, arr(np.array([K - 1], np.int32))]),
                cat([rR, arr(lR[None])]), cat([rp, arr(lp[None])]),
                cat([info, arr(np.full((1, 6), 1e6, np.float32))]))

    ej = with_loop(ej, jnp.concatenate, jnp.asarray)
    et = with_loop(et, torch.cat, torch.as_tensor)
    Rj, pj, cj = jpg.solve_pose_graph(jnp.asarray(est_R), jnp.asarray(est_p),
                                      *ej, iters=8)
    Rt, pt, ct = tpg.solve_pose_graph(t(est_R), t(est_p), *et, iters=8)
    np.testing.assert_allclose(n(Rt), np.asarray(Rj), atol=1e-3)
    np.testing.assert_allclose(n(pt), np.asarray(pj), atol=1e-3)
    drift0 = np.linalg.norm(est_p[-1] - gt_p[-1])
    drift1 = np.linalg.norm(n(pt[-1]) - n(pt[0]) - (gt_p[-1] - gt_p[0]))
    assert drift0 > 0.5 and drift1 < 0.2 * drift0
    # a masked edge is a dead edge
    mask = torch.ones(K, dtype=torch.bool)
    mask[3] = False
    Rm, pm, _ = tpg.solve_pose_graph(t(est_R), t(est_p), *et[:4],
                                     et[4] * mask[:, None], iters=2)
    Rn, pn, _ = tpg.solve_pose_graph(t(est_R), t(est_p), *et,
                                     edge_mask=mask, iters=2)
    assert torch.equal(pm, pn) and torch.equal(Rm, Rn)


def test_assemble_pose_system_matches_jax_and_oracle():
    """tests/test_dist_gba.py:82-110's graph: the JAX package's one-hot
    assembly and the dense scatter oracle, atol 1e-3, chi2 rtol 1e-5."""
    rng = np.random.default_rng(0)
    K, E = 12, 40
    i_idx = rng.integers(0, K - 1, E).astype(np.int32)
    j_idx = (i_idx + rng.integers(1, K - i_idx)).astype(np.int32)
    r = rng.normal(0, 1, (E, 6)).astype(np.float32)
    Ji = rng.normal(0, 1, (E, 6, 6)).astype(np.float32)
    Jj = rng.normal(0, 1, (E, 6, 6)).astype(np.float32)
    w6 = rng.uniform(0.1, 2.0, (E, 6)).astype(np.float32)
    Hj, gj, cj = jpg.assemble_pose_system(
        *(jnp.asarray(x) for x in (i_idx, j_idx, r, Ji, Jj, w6)), K=K)
    Ht, gt, ct = tpg.assemble_pose_system(
        t(i_idx, torch.int32), t(j_idx, torch.int32), t(r), t(Ji), t(Jj),
        t(w6), K)
    Ho = np.zeros((6 * K, 6 * K))
    go = np.zeros(6 * K)
    for e in range(E):
        A = np.zeros((6, 6 * K))
        A[:, 6 * i_idx[e]:6 * i_idx[e] + 6] = Ji[e]
        A[:, 6 * j_idx[e]:6 * j_idx[e] + 6] = Jj[e]
        Aw = A * w6[e][:, None]
        Ho += Aw.T @ A
        go += Aw.T @ r[e]
    for H, g in ((n(Ht), n(gt)), (np.asarray(Hj), np.asarray(gj))):
        np.testing.assert_allclose(H, Ho, atol=1e-3)
        np.testing.assert_allclose(g, go, atol=1e-3)
    np.testing.assert_allclose(n(Ht), np.asarray(Hj), atol=1e-3)
    assert np.isclose(float(ct), float(np.sum(w6 * r * r)), rtol=1e-5)
    assert np.isclose(float(ct), float(cj), rtol=1e-5)


# --------------------------------------------------------------------------
# downsampling
# --------------------------------------------------------------------------

@pytest.mark.parametrize("masked", [False, True])
def test_downsample_close_matches_jax(masked):
    """tests/test_downsample.py:38-59's cloud (and 10% of it masked): the
    same kept source points as the JAX package, each a real input point
    and its voxel's closest to the centroid."""
    rng = np.random.default_rng(0)
    pts = rng.uniform(-5, 5, (300, 3)).astype(np.float32)
    mask = ((rng.uniform(size=300) > 0.1) if masked
            else np.ones(300)).astype(np.float32)
    oj, mj, sj = jds.voxel_downsample_close(jnp.asarray(pts),
                                            jnp.asarray(mask), 1.0, 256)
    ot, mt, st = tds.voxel_downsample_close(t(pts), t(mask), 1.0, 256)
    np.testing.assert_array_equal(n(mt), np.asarray(mj))
    np.testing.assert_array_equal(n(st), np.asarray(sj))
    np.testing.assert_array_equal(n(ot), np.asarray(oj))
    assert st.dtype == torch.int32
    src = n(st)[n(mt)]
    np.testing.assert_array_equal(n(ot)[n(mt)], pts[src])
    keys = np.floor(pts / 1.0).astype(np.int64)
    for s in src:
        same = np.where(np.all(keys == keys[s], 1) & (mask > 0))[0]
        d = np.sum((pts[same] - pts[same].mean(0)) ** 2, 1)
        assert s == same[np.argmin(d)]
    # all points masked: nothing kept (tests/test_downsample.py:72-78)
    _, m0, _ = tds.voxel_downsample_close(t(pts), torch.zeros(300), 1.0, 64)
    assert not torch.any(m0)


def test_downsample_pvec_matches_jax():
    """tests/test_downsample.py:62-78's cloud: centroids within 1e-5 and
    mean covariances within tests/test_downsample.py's 1e-4."""
    rng = np.random.default_rng(0)
    pts = rng.uniform(-3, 3, (200, 3)).astype(np.float32)
    var = np.einsum("ni,nj->nij", pts * 0 + 1.0,
                    np.abs(rng.uniform(0.5, 1.5, (200, 3)))).astype(np.float32)
    var = 0.5 * (var + np.swapaxes(var, 1, 2))
    mask = np.ones(200, np.float32)
    oj, vj, mj = jds.voxel_downsample_pvec(jnp.asarray(pts), jnp.asarray(var),
                                           jnp.asarray(mask), 1.0, 256)
    ot, vt, mt = tds.voxel_downsample_pvec(t(pts), t(var), t(mask), 1.0, 256)
    np.testing.assert_array_equal(n(mt), np.asarray(mj))
    np.testing.assert_allclose(n(ot), np.asarray(oj), atol=1e-5)
    np.testing.assert_allclose(n(vt), np.asarray(vj), atol=1e-4)
    assert n(mt).sum() > 100


# --------------------------------------------------------------------------
# the structural BTC extractor
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def structural_visits():
    """tests/test_torch_loop.py's two visits of one place, and the JAX
    structural extraction of each (ground profile)."""
    scene = sim.make_scene()
    kfs = [keyframe_cloud(scene, (0.0, 0.0, 1.0), 0.0, 1),
           keyframe_cloud(scene, (1.0, -1.5, 1.0), 0.7, 9)]
    cfg = jbtc.BtcConfig.profile(False, extractor="structural")
    ext = jax.jit(jbtc.extract, static_argnums=2)
    descs = [{k: np.array(v) for k, v in
              ext(jnp.asarray(c), jnp.asarray(m), cfg).items()}
             for c, m, _, _ in kfs]
    return kfs, descs


@pytest.mark.parametrize("visit", [0, 1])
def test_structural_extract_matches_jax(structural_visits, visit):
    """Masks and codes equal, geometry within 1e-3 (the projection
    extractor's parity tolerance, tests/test_torch_loop.py)."""
    kfs, descs = structural_visits
    c, m, _, _ = kfs[visit]
    dj = descs[visit]
    cfg = tbtc.BtcConfig.profile(False, extractor="structural")
    dt = {k: n(v) for k, v in tbtc.extract(t(c), t(m), cfg).items()}
    assert dt["binary"].shape[-1] == cfg.code_bits == 24
    for k in ("plane_valid", "tri_valid", "binary"):
        np.testing.assert_array_equal(dt[k], dj[k], err_msg=k)
    for k in ("plane_centers", "plane_normals", "sides", "verts"):
        np.testing.assert_allclose(dt[k], dj[k], atol=1e-3, err_msg=k)
    assert dj["tri_valid"].sum() > 50


def test_structural_corners_match_jax(structural_visits):
    """The corner stage alone, from the JAX package's planes."""
    kfs, _ = structural_visits
    c, m, _, _ = kfs[0]
    cfg_j = jbtc.BtcConfig.profile(False, extractor="structural")
    cfg_t = tbtc.BtcConfig.profile(False, extractor="structural")
    pj = [np.array(x) for x in jax.jit(jbtc._extract_planes,
                                       static_argnums=2)(
        jnp.asarray(c), jnp.asarray(m), cfg_j)]
    cj = [np.array(x) for x in jax.jit(jbtc._structural_corners,
                                       static_argnums=6)(
        jnp.asarray(c), jnp.asarray(m), *(jnp.asarray(x) for x in pj[:3]),
        jnp.asarray(pj[4]), cfg_j)]
    ct = [n(x) for x in tbtc._structural_corners(
        t(c), t(m), *(torch.as_tensor(x) for x in pj[:3]), cfg_t)]
    np.testing.assert_array_equal(ct[3], cj[3])                 # valid
    np.testing.assert_array_equal(ct[2], cj[2])                 # codes
    np.testing.assert_array_equal(ct[1], cj[1])                 # support
    np.testing.assert_allclose(ct[0], cj[0], atol=1e-3)         # corners
    assert cj[3].sum() >= 10
