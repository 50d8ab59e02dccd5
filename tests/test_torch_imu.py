"""Parity of the port's IMU modules (EKF propagate / de-skew / static
init, preintegration and its factor) with the JAX package, on the
simulator's analytic IMU stream."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voxelslam_tpu.imu import ekf as jekf, preintegration as jpre
from voxelslam_tpu.io import simulator as sim
from voxelslam_tpu_torch.imu import ekf, preintegration as pre

from test_torch_helpers import n, t, random_states, states_both

torch.set_num_threads(1)


def _imu_packet(M=48, t0=0.5):
    """One scan's padded IMU batch from the simulator (200 Hz), starting
    one sample before the previous scan end like the pipeline's."""
    traj = sim.make_trajectory(duration=2.0, speed=1.2, wobble=0.25,
                               yaw_rate=0.3, ramp=1.2)
    ts = np.arange(t0 - 0.01, t0 + 0.1 + 1e-6, 1.0 / 200.0)
    gyr = np.array([traj.imu_at(x)[0] for x in ts])
    acc = np.array([traj.imu_at(x)[1] for x in ts])
    k = len(ts)
    T = np.full(M, ts[-1], np.float32)
    G = np.zeros((M, 3), np.float32)
    A = np.zeros((M, 3), np.float32)
    m = np.zeros(M, np.float32)
    T[:k], G[:k], A[:k], m[:k] = ts, gyr, acc, 1.0
    return traj, T, G, A, m, t0, t0 + 0.1


def _start_state(traj, t0):
    R, p, v = traj.state_at(t0)
    d = random_states(np.random.default_rng(0), 1)
    d = {k: v_[0] for k, v_ in d.items()}
    d.update(R=R.astype(np.float32), p=p.astype(np.float32),
             v=v.astype(np.float32), g=np.array([0, 0, -9.8], np.float32),
             t=np.float32(t0))
    return states_both(d)


COVS = [np.full(3, c, np.float32) for c in (0.1, 0.1, 1e-4, 1e-4)]


def _prop(mod, state, T, G, A, m, beg, end, tt):
    return mod.propagate(state, tt(T), tt(G), tt(A), tt(m), beg, end, beg,
                         *[tt(c) for c in COVS])


def test_propagate_parity_and_sequential_oracle():
    traj, T, G, A, m, beg, end = _imu_packet()
    js, ts = _start_state(traj, beg)
    jst, jposes = _prop(jekf, js, T, G, A, m, beg, end, jnp.asarray)
    tst, tposes = _prop(ekf, ts, T, G, A, m, beg, end, t)
    sst, sposes = ekf.propagate_sequential(ts, t(T), t(G), t(A), t(m), beg,
                                           end, beg, *[t(c) for c in COVS])
    for f in ("R", "p", "v", "t"):
        np.testing.assert_allclose(n(getattr(tst, f)),
                                   np.asarray(getattr(jst, f)), atol=2e-5)
        np.testing.assert_allclose(n(getattr(tst, f)),
                                   n(getattr(sst, f)), atol=2e-5)
    # covariance entries are O(1e-2): relative-to-max 1e-5
    scale = np.abs(np.asarray(jst.cov)).max()
    np.testing.assert_allclose(n(tst.cov) / scale,
                               np.asarray(jst.cov) / scale, atol=1e-5)
    np.testing.assert_allclose(n(tst.cov) / scale, n(sst.cov) / scale,
                               atol=1e-5)
    for f in ("offt", "R", "p", "v", "w", "a"):
        np.testing.assert_allclose(n(getattr(tposes, f)),
                                   np.asarray(getattr(jposes, f)), atol=2e-5)
    assert np.isinf(n(tposes.offt)).any()          # invalid intervals kept


def test_deskew_parity():
    """Unsorted pose offsets (+inf at invalid intervals) must resolve as
    the JAX binary search does."""
    traj, T, G, A, m, beg, end = _imu_packet()
    js, ts = _start_state(traj, beg)
    jst, jposes = _prop(jekf, js, T, G, A, m, beg, end, jnp.asarray)
    tst, tposes = _prop(ekf, ts, T, G, A, m, beg, end, t)
    rng = np.random.default_rng(1)
    pts = rng.uniform(-10, 10, (800, 3)).astype(np.float32)
    off = rng.uniform(0, 0.1, 800).astype(np.float32)
    off[:5] = [0.0, 0.1, 0.05, -0.01, 0.2]
    Rx = np.array([[0, -1, 0], [1, 0, 0], [0, 0, 1]], np.float32)
    tx = np.array([0.04, 0.02, -0.03], np.float32)
    a = jekf.deskew(jnp.asarray(pts), jnp.asarray(off), jposes, jst,
                    jnp.asarray(Rx), jnp.asarray(tx))
    b = ekf.deskew(t(pts), t(off), tposes, tst, t(Rx), t(tx))
    np.testing.assert_allclose(n(b), np.asarray(a), atol=1e-4)


@pytest.mark.parametrize("g_normalized", [False, True])
def test_static_init_parity(g_normalized):
    rng = np.random.default_rng(2)
    acc = (np.array([0.1, -0.2, 9.78]) + rng.normal(0, 0.01, (40, 3)))
    if g_normalized:
        acc = acc / 9.8
    gyr = rng.normal(0, 1e-3, (40, 3))
    m = np.ones(40, np.float32)
    m[-3:] = 0.0
    a = jekf.static_init(jnp.asarray(acc, jnp.float32),
                         jnp.asarray(gyr, jnp.float32), jnp.asarray(m),
                         livox_g_normalized=True)
    b = ekf.static_init(t(acc), t(gyr), t(m), livox_g_normalized=True)
    for x, y in zip(a, b):
        np.testing.assert_allclose(n(y), np.asarray(x), rtol=1e-6, atol=1e-6)


def _preint_inputs(seed=3, N=47):
    traj, T, G, A, m, beg, end = _imu_packet(M=N + 1)
    g_mid = 0.5 * (G[:-1] + G[1:])
    a_mid = 0.5 * (A[:-1] + A[1:])
    heads = np.clip(T[:-1], beg, end)
    tails = np.clip(T[1:], beg, end)
    dt = ((tails - heads) * m[:-1] * m[1:]).astype(np.float32)
    rng = np.random.default_rng(seed)
    bg = rng.normal(0, 1e-3, 3).astype(np.float32)
    ba = rng.normal(0, 1e-2, 3).astype(np.float32)
    nm = np.diag([0.1] * 3 + [0.1] * 3).astype(np.float32)
    nw = np.diag([1e-4] * 6).astype(np.float32)
    return g_mid, a_mid, dt, m[1:], bg, ba, nm, nw


def _integrate_both(seed=3):
    args = _preint_inputs(seed)
    a = jpre.integrate(*[jnp.asarray(x) for x in args])
    b = pre.integrate(*[t(x) for x in args])
    return a, b


def _assert_preint_close(a, b, atol=1e-6):
    for f in ("R_delta", "p_delta", "v_delta", "R_bg", "p_bg", "p_ba",
              "v_bg", "v_ba", "dtime", "bg_lin", "ba_lin"):
        np.testing.assert_allclose(n(getattr(b, f)),
                                   np.asarray(getattr(a, f)), atol=atol,
                                   err_msg=f)
    scale = np.abs(np.asarray(a.cov)).max()
    np.testing.assert_allclose(n(b.cov) / scale, np.asarray(a.cov) / scale,
                               atol=atol)


def test_integrate_parity():
    a, b = _integrate_both()
    _assert_preint_close(a, b)
    assert float(b.dtime) == pytest.approx(0.1, abs=1e-6)


def test_merge_parity():
    a1, b1 = _integrate_both(3)
    a2, b2 = _integrate_both(4)
    # one more composition of O(0.2) Jacobians on top of two integrations
    # whose f32 matmuls round differently on each side: 5e-6
    _assert_preint_close(jpre.merge(a1, a2), pre.merge(b1, b2), atol=5e-6)


@pytest.mark.parametrize("with_gravity", [False, True])
def test_factor_parity(with_gravity):
    """residual, closed-form Jacobian, evaluate_closed, cov_inv and chi2
    over a batch of window pairs (the port's batch dim is the JAX vmap)."""
    rng = np.random.default_rng(5)
    args = [_preint_inputs(s) for s in (6, 7, 8)]
    ja = [jpre.integrate(*[jnp.asarray(x) for x in a]) for a in args]
    import jax
    jb = jax.tree.map(lambda *x: jnp.stack(x), *ja)
    tb = pre.Preint(**{f.name: torch.stack(
        [t(np.asarray(getattr(p, f.name))) for p in ja])
        for f in dataclasses.fields(pre.Preint)})
    d = random_states(rng, 4)
    js, ts = states_both(d)
    j1, j2 = js[slice(0, 3)], js[slice(1, 4)]
    t1, t2 = ts[0:3], ts[1:4]
    r_j = jax.vmap(jpre.residual)(jb, j1, j2)
    np.testing.assert_allclose(n(pre.residual(tb, t1, t2)), np.asarray(r_j),
                               rtol=1e-4, atol=1e-4)
    J_j = jax.vmap(lambda p, a, b: jpre.jacobian_closed(p, a, b,
                                                        with_gravity))(jb, j1, j2)
    np.testing.assert_allclose(n(pre.jacobian_closed(tb, t1, t2, with_gravity)),
                               np.asarray(J_j), atol=1e-4)
    W_j = jax.vmap(jpre.cov_inv)(jb)
    W_t = pre.cov_inv(tb)
    # the inverse of a covariance spanning 1e-9..1e-2: compare in its own
    # scale; evaluate_closed / chi2 below use the same W on both sides
    np.testing.assert_allclose(n(W_t) / np.abs(np.asarray(W_j)).max(),
                               np.asarray(W_j) / np.abs(np.asarray(W_j)).max(),
                               atol=2e-3)
    Wn = np.asarray(W_j)
    c_j, H_j, g_j = jax.vmap(lambda p, a, b, w: jpre.evaluate_closed(
        p, a, b, with_gravity, w))(jb, j1, j2, jnp.asarray(Wn))
    c_t, H_t, g_t = pre.evaluate_closed(tb, t1, t2, with_gravity, t(Wn))
    for x, y in ((c_j, c_t), (H_j, H_t), (g_j, g_t)):
        x = np.asarray(x)
        np.testing.assert_allclose(n(y) / np.abs(x).max(),
                                   x / np.abs(x).max(), atol=2e-4)
    np.testing.assert_allclose(n(pre.chi2(tb, t1, t2, t(Wn))),
                               np.asarray(c_j), rtol=2e-4)
