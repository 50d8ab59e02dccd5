"""The plain reference on its own, on the CPU: the RANSAC verification
against the program's `DescriptorDB.verify` on synthetic descriptors, the
map comparison on clusters built by hand, and the pose fit."""

import numpy as np
import pytest

from slambench.reference import moments as rmo
from slambench.reference import poses as rpo
from slambench.reference import ransac as rra


def rot(rng):
    q = rng.normal(size=4)
    q /= np.linalg.norm(q)
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)]])


def descriptors(rng, T=80, inliers=50, planes=40, bits=12):
    """A query and a candidate: the candidate's first `inliers` triangles
    and its planes are the query's moved by (R, t) with noise; the rest
    random."""
    R, t = rot(rng), rng.normal(scale=5.0, size=3)
    qv = rng.uniform(-20, 20, size=(T, 3, 3))
    cv = rng.uniform(-20, 20, size=(T, 3, 3))
    cv[:inliers] = qv[:inliers] @ R.T + t + rng.normal(
        scale=0.05, size=(inliers, 3, 3))
    qb = (rng.random((T, 3, bits)) < 0.5).astype(np.float32)
    cb = qb.copy()
    flip = rng.random((T, 3, bits)) < 0.15
    cb[flip] = 1.0 - cb[flip]
    qc = rng.uniform(-20, 20, size=(planes, 3))
    qn = rng.normal(size=(planes, 3))
    qn /= np.linalg.norm(qn, axis=1, keepdims=True)
    keep = planes * 3 // 4
    cc = np.concatenate([qc[:keep] @ R.T + t,
                         rng.uniform(-20, 20, (planes - keep, 3))])
    cn = np.concatenate([qn[:keep] @ R.T, qn[keep:]])

    def d(v, b, c, n):
        return dict(verts=v.astype(np.float32), binary=b,
                    sides=np.zeros((T, 3), np.float32),
                    tri_valid=np.ones(T, bool),
                    plane_centers=c.astype(np.float32),
                    plane_normals=n.astype(np.float32),
                    plane_valid=np.ones(planes, bool))
    pairs = [(i, i) for i in range(T)] + [
        (int(a), int(b)) for a, b in rng.integers(0, T, size=(60, 2))]
    return d(qv, qb, qc, qn), d(cv, cb, cc, cn), pairs


@pytest.mark.parametrize("seed", range(6))
def test_ransac_agrees_with_the_program(seed):
    from voxelslam_tpu_torch.loop import btc
    rng = np.random.default_rng(seed)
    cfg = btc.BtcConfig()
    db = btc.DescriptorDB(cfg, use_native=False)
    q, c, pairs = descriptors(rng, inliers=50 if seed % 3 else 3)
    db.add(7, c)
    prog = db.verify(q, 7, pairs)
    ref, fragile = rra.verify(q, db.frames[7], pairs, cfg.ransac_hyps,
                              cfg.vertex_tol, cfg.plane_norm_tol,
                              cfg.plane_dist_tol)
    assert not fragile
    assert not rra.mismatch(prog, ref)
    assert (ref is None) == (seed % 3 == 0)
    if ref is not None:
        bad = dict(prog, t=np.asarray(prog["t"]) + 1e-2)
        assert rra.mismatch(bad, ref)
        assert rra.mismatch(None, ref)


def clusters_of(q, keys_of_points):
    """Per-voxel (n, mu, S) built point by point, the way a map slot
    holds them: packed keys, n, mu, S."""
    ks = rmo.pack(keys_of_points)
    u, inv = np.unique(ks, return_inverse=True)
    n = np.bincount(inv).astype(np.float64)
    mu = np.stack([np.bincount(inv, q[:, a]) for a in range(3)], 1) / n[:, None]
    S = np.zeros((len(u), 3, 3))
    for i, x in zip(inv, q):
        d = x - mu[i]
        S[i] += np.outer(d, d)
    return u, n, mu, S


def test_map_comparison():
    rng = np.random.default_rng(3)
    q = rng.uniform(-8, 8, size=(500, 3))
    m = np.ones(500)
    R, p = rot(rng), rng.normal(size=3)
    size = 1.0
    keys = np.floor((q @ R.T + p) / size).astype(np.int64)
    u, n, mu, S = clusters_of(q, keys)
    ref = rmo.scan_totals(q, m)
    assert rmo.totals_gap(rmo.cluster_totals(n, mu, S), ref) < 1e-12
    assert rmo.key_violations(q, m, R, p, size, 0.03, u, n) == 0
    # the pose the check is given, a little off the one the step used
    assert rmo.key_violations(q, m, R, p + 0.01, size, 0.03, u, n) == 0
    # the fullest voxel's points lost
    n_bad = n.copy()
    n_bad[np.argmax(n)] = 0
    assert rmo.key_violations(q, m, R, p, size, 0.03, u, n_bad) > 0
    half = m.copy()
    half[250:] = 0
    assert rmo.totals_gap(rmo.cluster_totals(n, mu, S),
                          rmo.scan_totals(q, half)) > 0.4


def test_pose_fit():
    rng = np.random.default_rng(4)
    p_true = np.cumsum(rng.normal(size=(50, 3)), axis=0)
    R, t = rot(rng), rng.normal(size=3)
    p_est = (p_true - t) @ R          # the truth in another frame
    assert rpo.position_errors(p_est, p_true).max() < 1e-9
    p_est[10] += [0.2, 0, 0]
    assert rpo.position_errors(p_est, p_true).max() > 0.15
    Ra, Rb = rot(rng), rot(rng)
    pa, pb = rng.normal(size=3), rng.normal(size=3)
    assert rpo.edge_error(Ra.T @ (pb - pa), Ra, pa, Rb, pb) < 1e-12
