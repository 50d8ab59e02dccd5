"""Parity of the port's core math (so3, NavState, eig3, Cluster) with the
JAX package, on seeded numpy inputs. Tolerances are f32-level: the two
frameworks round the same formulas in different orders."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voxelslam_tpu.core import so3 as jso3, eig3 as jeig, cluster as jcl
from voxelslam_tpu_torch.core import so3, eig3, cluster as cl
from voxelslam_tpu_torch.core.state import NavState, stack_states

from test_torch_helpers import n, t, random_states, states_both

torch.set_num_threads(1)

ATOL = 2e-6   # f32 rounding of O(1) quantities


def _vectors(rng):
    """Rotation vectors over all regimes: tiny (Taylor branch), generic,
    and near pi."""
    tiny = rng.normal(0, 1e-6, (20, 3))
    gen = rng.normal(0, 1.0, (60, 3))
    axis = rng.normal(0, 1, (20, 3))
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    near_pi = axis * (np.pi - rng.uniform(1e-3, 1e-2, (20, 1)))
    return np.concatenate([tiny, gen, near_pi]).astype(np.float32)


@pytest.mark.parametrize("fn", ["hat", "exp", "jr", "jr_inv"])
def test_so3_vector_fns(fn):
    w = _vectors(np.random.default_rng(0))
    a = np.asarray(getattr(jso3, fn)(jnp.asarray(w)))
    b = n(getattr(so3, fn)(t(w)))
    np.testing.assert_allclose(b, a, atol=2e-5 if fn == "jr_inv" else ATOL)


@pytest.mark.parametrize("fn", ["log", "quat_from_matrix", "vee", "jr_inv_R"])
def test_so3_matrix_fns(fn):
    w = _vectors(np.random.default_rng(1))
    R = np.asarray(jso3.exp(jnp.asarray(w)))          # shared input
    a = np.asarray(getattr(jso3, fn)(jnp.asarray(R)))
    b = n(getattr(so3, fn)(t(R)))
    # log near pi: the axis is recovered from O(1e-3) quaternion parts
    np.testing.assert_allclose(b, a, atol=1e-4 if fn == "jr_inv_R" else 2e-5)


def test_navstate_boxplus_boxminus_index_stack():
    rng = np.random.default_rng(2)
    js, ts = states_both(random_states(rng, 5))
    dx = rng.normal(0, 0.1, (5, 15)).astype(np.float32)
    jp, tp = js.boxplus(jnp.asarray(dx)), ts.boxplus(t(dx))
    for f in ("R", "p", "v", "bg", "ba", "g", "t", "cov"):
        np.testing.assert_allclose(n(getattr(tp, f)),
                                   np.asarray(getattr(jp, f)), atol=ATOL)
    np.testing.assert_allclose(n(tp.boxminus(ts)),
                               np.asarray(jp.boxminus(js)), atol=1e-5)
    np.testing.assert_allclose(n(tp.boxminus(ts)), dx, atol=1e-5)
    one = ts[2]
    assert one.R.shape == (3, 3) and one.t.shape == ()
    st = stack_states([ts[0], ts[3]])
    np.testing.assert_array_equal(n(st.p), n(ts.p[[0, 3]]))
    ident = NavState.identity((4,))
    np.testing.assert_allclose(n(ident.cov[0].diagonal()),
                               [1e-4] * 9 + [1e-5] * 6, rtol=1e-6)


def _sym_cases(rng):
    """Generic SPD, plane-like (one tiny eigenvalue), line-like, exactly
    isotropic, exactly repeated pairs, and covariances of real point
    sets — the regimes the map's plane fit feeds eigh3."""
    A = rng.normal(0, 1, (40, 3, 3))
    generic = A @ A.transpose(0, 2, 1)
    U = np.linalg.qr(rng.normal(0, 1, (40, 3, 3)))[0]
    lam_plane = np.stack([rng.uniform(1e-6, 1e-4, 40),
                          rng.uniform(0.5, 1, 40), rng.uniform(1, 2, 40)], 1)
    plane = U @ (lam_plane[:, :, None] * U.transpose(0, 2, 1))
    lam_line = np.stack([rng.uniform(1e-6, 1e-5, 40),
                         rng.uniform(1e-5, 2e-5, 40), rng.uniform(1, 2, 40)], 1)
    line = U @ (lam_line[:, :, None] * U.transpose(0, 2, 1))
    iso = np.eye(3)[None] * rng.uniform(0.1, 2, (5, 1, 1))
    rep = np.stack([np.diag([1.0, 1.0, 2.0]), np.diag([3.0, 1.0, 1.0]),
                    np.zeros((3, 3))])
    return np.concatenate([generic, plane, line, iso, rep]).astype(np.float32)


def test_eigvalsh3_parity():
    """The trigonometric closed form loses ~sqrt(eps) ~ 3e-4 (relative to
    the largest eigenvalue) where acos meets a near-degenerate pair, and
    the two frameworks' acos/cos round differently there; eigh3 restores
    full accuracy with its Rayleigh refinement (next test)."""
    M = _sym_cases(np.random.default_rng(3))
    a = np.asarray(jeig.eigvalsh3(jnp.asarray(M)))
    b = n(eig3.eigvalsh3(t(M)))
    scale = np.abs(M).max(axis=(1, 2), keepdims=True)[:, :, 0]
    np.testing.assert_allclose(b / np.maximum(scale, 1e-30),
                               a / np.maximum(scale, 1e-30), atol=5e-4)


def test_eigh3_parity_signs_and_order():
    """Eigenvalues ascend and eigenvectors carry the JAX package's signs
    (torch.linalg.eigh would pick its own)."""
    M = _sym_cases(np.random.default_rng(4))
    wa, Va = (np.asarray(x) for x in jeig.eigh3(jnp.asarray(M)))
    wb, Vb = (n(x) for x in eig3.eigh3(t(M)))
    scale = np.maximum(np.abs(M).max(axis=(1, 2)), 1e-30)[:, None]
    np.testing.assert_allclose(wb / scale, wa / scale, atol=2e-6)
    assert np.all(np.diff(wb, axis=1) >= 0)
    # vectors of well-separated eigenvalues must agree including sign;
    # inside an exactly repeated eigenspace any basis is correct
    gap = np.diff(wa, axis=1) / scale
    sep = np.stack([gap[:, 0] > 1e-3, (gap[:, 0] > 1e-3) & (gap[:, 1] > 1e-3),
                    gap[:, 1] > 1e-3], 1)
    diff = np.abs(Vb - Va).max(axis=1)                  # per column
    assert np.all(diff[sep] < 2e-3), diff[sep].max()
    # every returned basis is orthonormal and diagonalizes M
    np.testing.assert_allclose(Vb.transpose(0, 2, 1) @ Vb,
                               np.broadcast_to(np.eye(3), Vb.shape), atol=1e-5)
    recon = Vb @ (wb[:, :, None] * Vb.transpose(0, 2, 1))
    np.testing.assert_allclose(recon / scale[:, :, None],
                               M / scale[:, :, None], atol=2e-5)


def test_cluster_ops_parity():
    rng = np.random.default_rng(5)
    pts = rng.normal(0, 1, (6, 30, 3)).astype(np.float32) + 5.0
    m = (rng.random((6, 30)) > 0.3).astype(np.float32)
    m[0] = 0.0                                       # one empty cluster
    ja = jcl.from_points(jnp.asarray(pts), jnp.asarray(m))
    ta = cl.from_points(t(pts), t(m))
    half = m.copy()
    half[:, 15:] = 0.0
    jb = jcl.from_points(jnp.asarray(pts), jnp.asarray(half))
    tb = cl.from_points(t(pts), t(half))
    R = np.asarray(jso3.exp(jnp.asarray(rng.normal(0, 1, 3).astype(np.float32))))
    p = rng.normal(0, 3, 3).astype(np.float32)
    cases = [
        (ja, ta), (jcl.merge(ja, jb), cl.merge(ta, tb)),
        (jcl.subtract(ja, jb), cl.subtract(ta, tb)),
        (jcl.transform(ja, jnp.asarray(R), jnp.asarray(p)),
         cl.transform(ta, t(R), t(p))),
    ]
    for jc, tc in cases:
        np.testing.assert_allclose(n(tc.n), np.asarray(jc.n), atol=0)
        np.testing.assert_allclose(n(tc.mu), np.asarray(jc.mu), atol=1e-5)
        np.testing.assert_allclose(n(tc.S), np.asarray(jc.S), atol=2e-4)
    np.testing.assert_allclose(n(cl.cov(ta)), np.asarray(jcl.cov(ja)),
                               atol=1e-5)
    for a, b in zip(jcl.raw_moments(ja), cl.raw_moments(ta)):
        np.testing.assert_allclose(n(b), np.asarray(a), rtol=1e-5, atol=1e-3)


def _cfg_tree(cfg):
    import dataclasses
    return dataclasses.asdict(cfg)


@pytest.mark.parametrize("name", sorted(__import__(
    "voxelslam_tpu.config", fromlist=["_PRESETS"])._PRESETS))
def test_config_presets_equal_reference(name):
    """The port's copy of the config tree: every preset, field by field."""
    from voxelslam_tpu import config as jc
    from voxelslam_tpu_torch import config as tc
    assert _cfg_tree(tc.preset(name)) == _cfg_tree(jc.preset(name))


def test_config_defaults_small_and_override_equal_reference():
    from voxelslam_tpu import config as jc
    from voxelslam_tpu_torch import config as tc
    assert _cfg_tree(tc.SlamConfig()) == _cfg_tree(jc.SlamConfig())
    assert _cfg_tree(tc.small_test_config()) == _cfg_tree(jc.small_test_config())
    ov = {"map": {"capacities": [64, 128, 256], "win_size": 6},
          "odom": {"point_max": 300}, "lidar_type": "ouster"}
    assert (_cfg_tree(tc.override(tc.small_test_config(), ov))
            == _cfg_tree(jc.override(jc.small_test_config(), ov)))
    with pytest.raises(AttributeError):
        tc.override(tc.SlamConfig(), {"no_such_field": 1})


def test_simulator_and_metrics_copies_agree():
    """io/simulator.py and utils/metrics.py are numpy-only copies: the same
    seed gives the same scans, IMU samples and error metrics."""
    from voxelslam_tpu.io import simulator as jsim
    from voxelslam_tpu.utils import metrics as jmet
    from voxelslam_tpu_torch.io import simulator as tsim
    from voxelslam_tpu_torch.utils import metrics as tmet
    kw = dict(duration=2.0, speed=1.2, wobble=0.25, yaw_rate=0.3, ramp=1.2)
    ja, ta = jsim.make_trajectory(**kw), tsim.make_trajectory(**kw)
    room = dict(half_extent=(14.0, 12.0, 3.5), center=(4.0, 0.0, 1.0))
    jn, jd = jsim.box_room(**room)
    tn, td = tsim.box_room(**room)
    np.testing.assert_array_equal(tn, jn)
    a = jsim.lidar_scan(ja, 0.3, 0.4, jn, jd, n_az=40, n_el=8, noise=0.01,
                        seed=3)
    b = tsim.lidar_scan(ta, 0.3, 0.4, tn, td, n_az=40, n_el=8, noise=0.01,
                        seed=3)
    for k in ("points", "offsets", "hit"):
        np.testing.assert_array_equal(b[k], a[k])
    for x in (0.1, 0.77, 1.5):
        for u, v in zip(ta.imu_at(x), ja.imu_at(x)):
            np.testing.assert_array_equal(u, v)
    rng = np.random.default_rng(0)
    est, gt = rng.normal(size=(50, 3)), rng.normal(size=(50, 3))
    assert tmet.ate_rmse(est, gt) == jmet.ate_rmse(est, gt)
