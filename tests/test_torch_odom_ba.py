"""Parity of the port's odometry update (iEKF against the voxel map and
the init-phase kd-tree variant) and window optimizers (lm_li,
lm_li_gravity and the closed-form LiDAR factor) with the JAX package.

The port runs the JAX early-exiting loops as fixed trips with masked
updates; the results must agree to f32 solve accuracy."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from voxelslam_tpu.ba import lidar_factor as jlf, optimizers as jopt
from voxelslam_tpu.core import cluster as jcl
from voxelslam_tpu.core.state import NavState as JNavState
from voxelslam_tpu.imu import preintegration as jpre
from voxelslam_tpu.io import simulator as sim
from voxelslam_tpu.odom import iekf as jiekf
from voxelslam_tpu_torch.ba import lidar_factor as lf, optimizers as opt
from voxelslam_tpu_torch.core.state import NavState
from voxelslam_tpu_torch.imu.preintegration import Preint
from voxelslam_tpu_torch.odom import iekf

from test_torch_helpers import (n, t, to_port, states_both, random_states,
                                window_frames, build_maps, small_map_config,
                                port_map_config)

torch.set_num_threads(1)

DEPT_ERR, BEAM_ERR = 0.02, 0.05


def _assert_states_close(a, b, atol, fields=("R", "p", "v", "bg", "ba", "g")):
    for f in fields:
        np.testing.assert_allclose(n(getattr(b, f)),
                                   np.asarray(getattr(a, f)), atol=atol,
                                   err_msg=f)


# --------------------------------------------------------------------------
# iEKF
# --------------------------------------------------------------------------

def _scan_against_map(seed):
    """A map of 4 room scans, and a 5th scan with its true pose and a
    propagated state 1 deg / 5 cm off it."""
    jcfg = small_map_config()
    rng = np.random.default_rng(seed)
    frames = window_frames(rng, 5, 500)
    jl, tl, _, _ = build_maps(jcfg, frames[:4])
    R, p, loc, mask, _ = frames[4]
    d = {k: v[0] for k, v in random_states(rng, 1).items()}
    dR = Rotation.from_rotvec([0.01, -0.012, 0.006]).as_matrix()
    d.update(R=(R @ dR).astype(np.float32),
             p=(p + np.array([0.05, -0.03, 0.02])).astype(np.float32),
             cov=(np.eye(15) * 1e-3).astype(np.float32))
    js, ts = states_both(d)
    return jcfg, jl, tl, (R, p, loc, mask), js, ts


def test_point_var_body_and_var_world_parity():
    rng = np.random.default_rng(0)
    pts = rng.uniform(-20, 20, (400, 3)).astype(np.float32)
    pts[:3] = [[0, 0, 5], [0.1, 0, -8], [3, 4, 0]]        # |d_z| >= 0.9 branch
    vb_j = jiekf.point_var_body(jnp.asarray(pts), DEPT_ERR, BEAM_ERR)
    vb_t = iekf.point_var_body(t(pts), DEPT_ERR, BEAM_ERR)
    np.testing.assert_allclose(n(vb_t), np.asarray(vb_j), rtol=1e-5,
                               atol=1e-8)
    js, ts = states_both({k: v[0] for k, v in random_states(rng, 1).items()})
    np.testing.assert_allclose(
        n(iekf.var_world(ts, t(pts), vb_t)),
        np.asarray(jiekf.var_world(js, jnp.asarray(pts), vb_j)),
        rtol=1e-4, atol=1e-7)


def test_iekf_update_parity():
    jcfg, jl, tl, (R, p, loc, mask), js, ts = _scan_against_map(1)
    var_b = np.asarray(jiekf.point_var_body(jnp.asarray(loc), DEPT_ERR,
                                            BEAM_ERR))
    a, ok_a, da = jiekf.iekf_update(js, jl, jcfg, jnp.asarray(loc),
                                    jnp.asarray(var_b), jnp.asarray(mask),
                                    max_iter=4, degrade_eig=14.0)
    b, ok_b, db = iekf.iekf_update(ts, tl, port_map_config(jcfg), t(loc),
                                   t(var_b), t(mask), max_iter=4,
                                   degrade_eig=14.0)
    assert bool(ok_b) == bool(ok_a)
    assert int(db["matches"]) == int(da["matches"]) > 200
    assert int(db["iters"]) == int(da["iters"])
    np.testing.assert_allclose(n(db["nnt_eig"]), np.asarray(da["nnt_eig"]),
                               rtol=1e-4)
    # a few f32 Kalman solves: 2e-5 on poses, 1e-5 of the covariance scale
    _assert_states_close(a, b, 2e-5)
    scale = np.abs(np.asarray(a.cov)).max()
    np.testing.assert_allclose(n(b.cov) / scale, np.asarray(a.cov) / scale,
                               atol=1e-5)
    # the update moved the state back towards the true pose
    assert np.linalg.norm(n(b.p) - p) < 0.5 * np.linalg.norm(n(ts.p) - p)


def test_iekf_update_kdtree_parity():
    rng = np.random.default_rng(2)
    frames = window_frames(rng, 4, 500)
    ref = np.concatenate([loc @ R.T + p for R, p, loc, _, _ in frames[:3]])
    ref_mask = np.concatenate([m for _, _, _, m, _ in frames[:3]])
    R, p, loc, mask, _ = frames[3]
    d = {k: v[0] for k, v in random_states(rng, 1).items()}
    dR = Rotation.from_rotvec([-0.008, 0.01, 0.012]).as_matrix()
    d.update(R=(R @ dR).astype(np.float32),
             p=(p + np.array([-0.04, 0.03, 0.02])).astype(np.float32),
             cov=(np.eye(15) * 1e-3).astype(np.float32))
    js, ts = states_both(d)
    a = jiekf.iekf_update_kdtree(js, jnp.asarray(ref), jnp.asarray(ref_mask),
                                 jnp.asarray(loc), jnp.asarray(mask))
    b = iekf.iekf_update_kdtree(ts, t(ref), t(ref_mask), t(loc), t(mask))
    _assert_states_close(a, b, 2e-5)
    assert np.linalg.norm(n(b.p) - p) < 0.5 * np.linalg.norm(n(ts.p) - p)


# --------------------------------------------------------------------------
# window optimizers (the window of tests/test_ba.py::TestLMLI)
# --------------------------------------------------------------------------

def _window(seed, W=4):
    """Simulated window: true states, preintegrations between them and
    room-plane factors in body frames (JAX objects)."""
    rng = np.random.default_rng(seed)
    traj = sim.make_trajectory(duration=2.0, speed=1.5, wobble=0.4)
    t_scans = 0.2 + 0.1 * np.arange(W)
    states = []
    for ts_ in t_scans:
        R, p, v = traj.state_at(ts_)
        states.append(dataclasses.replace(
            JNavState.identity(), R=jnp.array(R, jnp.float32),
            p=jnp.array(p, jnp.float32), v=jnp.array(v, jnp.float32),
            t=jnp.array(ts_, jnp.float32)))
    states = jax.tree.map(lambda *x: jnp.stack(x), *states)
    preints = []
    for i in range(W - 1):
        ts, gyr, acc = sim.imu_stream(traj, rate=200.0, t0=t_scans[i],
                                      t1=t_scans[i + 1] + 1e-4)
        g = 0.5 * (gyr[:-1] + gyr[1:]).astype(np.float32)
        a = 0.5 * (acc[:-1] + acc[1:]).astype(np.float32)
        dt = np.diff(ts).astype(np.float32)
        preints.append(jpre.integrate(
            jnp.array(g), jnp.array(a), jnp.array(dt), jnp.ones(len(dt)),
            jnp.zeros(3), jnp.zeros(3), jnp.eye(6) * 1e-4,
            jnp.eye(6) * 1e-6))
    preints = jax.tree.map(lambda *x: jnp.stack(x), *preints)
    normals, dsp = sim.box_room()
    wins = []
    for pi in range(len(normals)):
        frame_cl = []
        for i in range(W):
            R, p, _ = traj.state_at(t_scans[i])
            uv = rng.uniform(-2, 2, (50, 2))
            nrm = normals[pi]
            t1 = np.cross(nrm, [0.3, 0.7, 0.2])
            t1 /= np.linalg.norm(t1)
            t2 = np.cross(nrm, t1)
            pts_w = -dsp[pi] * nrm + uv[:, :1] * t1 + uv[:, 1:] * t2
            pts_w += nrm * rng.normal(0, 0.002, (50, 1))
            frame_cl.append(jcl.from_points(jnp.array((pts_w - p) @ R,
                                                      jnp.float32)))
        wins.append(jax.tree.map(lambda *x: jnp.stack(x), *frame_cl))
    F = len(normals)
    fb = jlf.FactorBatch(
        win=jax.tree.map(lambda *x: jnp.stack(x), *wins),
        fix=jax.tree.map(lambda *x: jnp.stack(x),
                         *[jcl.Cluster.empty() for _ in range(F)]),
        coeff=jnp.ones(F), valid=jnp.ones(F, bool))
    # perturb every frame but the first (gauge) in rotation, position and
    # velocity
    dx = rng.normal(0, 0.02, (W, 15)).astype(np.float32)
    dx[0] = 0.0
    dx[:, 9:] = 0.0
    bad = states.boxplus(jnp.asarray(dx))
    return bad, preints, fb, states


@pytest.fixture(scope="module")
def window():
    """One simulated window shared by the optimizer tests (building it
    eagerly on the JAX side is most of their time)."""
    return _window(3)


def _port_window(bad, preints, fb):
    return (to_port(bad, NavState), to_port(preints, Preint),
            to_port(fb, lf.FactorBatch))


def test_lidar_factor_cost_hess_grad_parity(window):
    bad, preints, fb, _ = window
    _, _, tfb = _port_window(bad, preints, fb)
    W = bad.t.shape[0]
    jft = jlf.transpose_factors(fb)
    tft = lf.transpose_factors(tfb)
    for x, y in zip(jft, tft):
        np.testing.assert_array_equal(n(y), np.asarray(x))
    mask = np.ones(W, np.float32)
    Hj, gj = jlf.hess_grad_ct_t(jft, bad.R, bad.p, jnp.asarray(mask))
    Ht, gt = lf.hess_grad_ct_t(tft, t(bad.R), t(bad.p), t(mask))
    for x, y in ((Hj, Ht), (gj, gt)):
        x = np.asarray(x)
        np.testing.assert_allclose(n(y) / np.abs(x).max(),
                                   x / np.abs(x).max(), atol=1e-4)
    np.testing.assert_allclose(
        float(lf.cost_t(tft, t(bad.R), t(bad.p), t(mask))),
        float(jlf.cost_t(jft, bad.R, bad.p, jnp.asarray(mask))), rtol=1e-4)


@pytest.mark.parametrize("gravity", [False, True])
def test_lm_li_parity(window, gravity):
    """lm_li and lm_li_gravity from the same perturbed window: same
    accept/reject path (conv), residuals within 1e-3 relative, states
    within 1e-4 (three damped f32 solves of a 60-dim system)."""
    bad, preints, fb, truth = window
    if gravity:
        bad = dataclasses.replace(
            bad, g=bad.g + jnp.asarray([0.05, -0.04, 0.1], jnp.float32))
    tbad, tpre, tfb = _port_window(bad, preints, fb)
    W = bad.t.shape[0]
    mask = np.ones(W, np.float32)
    if gravity:
        a = jopt.lm_li_gravity(bad, fb, preints, jnp.asarray(mask),
                               max_iter=3, g_prior_w=1.0)
        b = opt.lm_li_gravity(tbad, tfb, tpre, t(mask), max_iter=3,
                              g_prior_w=1.0)
    else:
        a = jopt.lm_li(bad, fb, preints, jnp.asarray(mask), max_iter=3)
        b = opt.lm_li(tbad, tfb, tpre, t(mask), max_iter=3)
    (sa, Ha, r0a, r1a, ca), (sb, Hb, r0b, r1b, cb) = a, b
    assert bool(cb) == bool(ca)
    np.testing.assert_allclose(float(r0b), float(r0a), rtol=1e-4)
    np.testing.assert_allclose(float(r1b), float(r1a), rtol=1e-3)
    assert float(r1b) < float(r0b)
    _assert_states_close(sa, sb, 1e-4)
    Ha = np.asarray(Ha)
    np.testing.assert_allclose(n(Hb) / np.abs(Ha).max(), Ha / np.abs(Ha).max(),
                               atol=1e-4)
    # the optimizer moved the window towards the truth
    err = lambda s: np.abs(n(s.p) - np.asarray(truth.p)).max()
    assert err(sb) < err(tbad)
