"""Touched-slot map tracking (`MapConfig.track_touched`) and the
factor-major harvest of the port against the JAX package.

A tracked level lists, per window frame, the slots its scan touched; the
sparse marginalize folds only those. Scenarios are tests/test_voxel_map.py's
(TestSparseMarginalize: three 500-point scans at small_test_config's
widths), with its tolerances."""

import dataclasses
import functools
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voxelslam_tpu.config import small_test_config
from voxelslam_tpu.core import so3 as jso3
from voxelslam_tpu.map import voxel_map as jvm
from voxelslam_tpu_torch import convert
from voxelslam_tpu_torch.ba import lidar_factor as tlf
from voxelslam_tpu_torch.map import voxel_map as tvm
from voxelslam_tpu_torch.utils import checkpoint as tck

from test_torch_helpers import (n, t, to_np_dict, window_frames,
                                small_map_config, port_map_config)

torch.set_num_threads(1)

_jax_insert = jax.jit(jvm.insert_scan_touched, static_argnums=1)
_jax_refresh = jax.jit(jvm.refresh_planes, static_argnums=1)


def _configs(track=True):
    jcfg = dataclasses.replace(small_test_config().map, track_touched=track)
    return jcfg, port_map_config(jcfg)


def _scans(seed, W):
    """tests/test_voxel_map.py TestSparseMarginalize._build's poses and
    three 500-point scans into slots 0..2."""
    rng = np.random.default_rng(seed)
    Rs = np.stack([np.asarray(jso3.exp(jnp.array(rng.normal(0, 0.1, 3),
                                                  jnp.float32)))
                   for _ in range(W)])
    ps = rng.normal(0, 0.5, (W, 3)).astype(np.float32)
    scans = []
    for i in range(3):
        pts = rng.uniform(-4, 4, (500, 3)).astype(np.float32)
        scans.append((pts @ Rs[i].T + ps[i], pts))
    return Rs, ps, scans


@functools.lru_cache(maxsize=None)
def _build_both(seed, track=True):
    jcfg, tcfg = _configs(track)
    Rs, ps, scans = _scans(seed, jcfg.win_size)
    jl, tl = jvm.empty_map(jcfg), tvm.empty_map(tcfg)
    jt, tt = [], []
    for i, (wld, pts) in enumerate(scans):
        jl, a = _jax_insert(jl, jcfg, jnp.array(wld), jnp.array(pts),
                            jnp.full((500,), 1e-4), jnp.ones(500), i,
                            float(i))
        tl, b = tvm.insert_scan_touched(tl, tcfg, t(wld), t(pts),
                                        torch.full((500,), 1e-4),
                                        torch.ones(500), i, float(i))
        jt.append(a)
        tt.append(b)
    mp = np.arange(jcfg.win_size, dtype=np.int32)
    return jcfg, tcfg, jl, tl, jt, tt, Rs, ps, mp


def _fix_close(a, b, nv=True):
    """tests/test_voxel_map.py:447-473's tolerances."""
    np.testing.assert_allclose(n(a.fix.n), np.asarray(b.fix.n), atol=1e-5)
    np.testing.assert_allclose(n(a.fix.mu), np.asarray(b.fix.mu), atol=1e-4)
    np.testing.assert_allclose(n(a.fix.S), np.asarray(b.fix.S), atol=3e-3)
    if nv:
        np.testing.assert_allclose(n(a.fix_nv), np.asarray(b.fix_nv),
                                   atol=1e-4)


def test_empty_map_tracks_at_unique_max():
    jcfg, tcfg = _configs()
    for jl, tl in zip(jvm.empty_map(jcfg), tvm.empty_map(tcfg)):
        assert tuple(tl.tsl.shape) == tuple(jl.tsl.shape)
        assert tl.tsl.dtype == torch.int32
        np.testing.assert_array_equal(n(tl.tsl), np.asarray(jl.tsl))
    with pytest.raises(ValueError):       # batched (GBA) levels stay T = 0
        tvm.empty_level(64, 4, 8, nw=2)


def test_tracked_insert_matches_jax():
    """tsl rows equal, touched slots equal, window rows within
    tests/test_torch_map.py's insert tolerances."""
    _, _, jl, tl, jt, tt, _, _, _ = _build_both(7)
    for a, b in zip(jl, tl):
        np.testing.assert_array_equal(n(b.keys), np.asarray(a.keys))
        np.testing.assert_array_equal(n(b.tsl), np.asarray(a.tsl))
        np.testing.assert_allclose(n(b.win.n), np.asarray(a.win.n), atol=1e-5)
        np.testing.assert_allclose(n(b.win.mu), np.asarray(a.win.mu),
                                   atol=2e-4)
        np.testing.assert_allclose(n(b.win.S), np.asarray(a.win.S), atol=2e-3)
        np.testing.assert_allclose(n(b.win_nv), np.asarray(a.win_nv),
                                   atol=1e-5)
        np.testing.assert_array_equal(n(b.jour), np.asarray(a.jour))
        C = a.keys.shape[0]
        # the invariant: window stats only at listed slots
        for w in range(b.tsl.shape[0]):
            listed = np.zeros(C + 1, bool)
            listed[n(b.tsl[w])] = True
            assert not np.any(n(b.win.n[w])[~listed[:C]])
    for sa, sb in zip(jt, tt):
        for (ja, jv, jd), (ta, tv, td) in zip(sa, sb):
            np.testing.assert_array_equal(n(ta), np.asarray(ja))
            np.testing.assert_array_equal(n(tv), np.asarray(jv))
            assert int(td) == int(jd)


@pytest.mark.parametrize("straddle", [False, True])
def test_sparse_marginalize_matches_jax_and_full(straddle):
    """TestSparseMarginalize's scenario (mgsize 2) through both packages:
    the port's sparse fold against the JAX sparse fold and against the
    port's own full fold; with `straddle`, fixed counts one below
    max_points (tests/test_voxel_map.py:475-504)."""
    jcfg, tcfg, jl, tl, _, _, Rs, ps, mp = _build_both(11)
    _, _, jf, tf, _, _, _, _, _ = _build_both(11, track=False)

    def strad(levels, tw):
        if not straddle:
            return levels
        out = []
        for lv in levels:
            if tw:
                nn = torch.where(torch.sum(lv.win.n, 0) > 0,
                                 float(jcfg.max_points - 1), lv.fix.n)
            else:
                nn = jnp.where(jnp.sum(lv.win.n, 0) > 0,
                               jnp.float32(jcfg.max_points - 1), lv.fix.n)
            out.append(dataclasses.replace(
                lv, fix=dataclasses.replace(lv.fix, n=nn)))
        return tuple(out)

    oj = jvm.marginalize(strad(jl, False), jcfg, jnp.asarray(Rs),
                         jnp.asarray(ps), jnp.asarray(mp), 3, 2)
    ot = tvm.marginalize(strad(tl, True), tcfg, t(Rs), t(ps),
                         t(mp, torch.int32), 3, 2)
    of = tvm.marginalize(strad(tf, True), tcfg, t(Rs), t(ps),
                         t(mp, torch.int32), 3, 2)
    for a, b, c in zip(ot, oj, of):
        _fix_close(a, b)
        C = a.keys.shape[0]
        _fix_close(a, dataclasses.replace(
            c, fix=dataclasses.replace(c.fix, n=n(c.fix.n), mu=n(c.fix.mu),
                                       S=n(c.fix.S)), fix_nv=n(c.fix_nv)))
        assert float(torch.sum(a.win.n[0])) == 0.0
        assert float(torch.sum(a.win.n[1])) == 0.0
        np.testing.assert_allclose(n(a.win.n[2]), n(c.win.n[2]))
        assert np.all(n(a.tsl[0]) == C) and np.all(n(a.tsl[1]) == C)
        np.testing.assert_array_equal(n(a.tsl), np.asarray(b.tsl))
        if straddle:
            assert float(torch.max(a.fix.n)) > jcfg.max_points


def test_evict_remaps_tsl_like_jax():
    """Evict a tracked map whose scans carry travel stamps 0, 1, 2 at
    max_dist 1.5 (the first scan's new voxels go): tsl remapped exactly as
    the JAX package remaps it, and the invariant still holds."""
    _, _, jl, tl, _, _, _, _, _ = _build_both(5)
    ej, dj = jvm.evict(jl, 2.0, 1.5)
    et, dt = tvm.evict(tl, 2.0, 1.5)
    np.testing.assert_array_equal(n(dt), np.asarray(dj))
    for a, b in zip(et, ej):
        np.testing.assert_array_equal(n(a.keys), np.asarray(b.keys))
        np.testing.assert_array_equal(n(a.tsl), np.asarray(b.tsl))
        np.testing.assert_allclose(n(a.win.n), np.asarray(b.win.n), atol=1e-5)
        C = a.keys.shape[0]
        for w in range(a.tsl.shape[0]):
            listed = np.zeros(C + 1, bool)
            listed[n(a.tsl[w])] = True
            assert not np.any(n(a.win.n[w])[~listed[:C]])
        assert np.any(n(a.tsl) < C)


def test_unique_cap_past_track_width_raises():
    """U > T raises ValueError in both packages."""
    jcfg, tcfg = _configs()
    pts = np.random.default_rng(0).uniform(-4, 4, (600, 3)).astype(np.float32)
    jlv = jvm.empty_level(1 << 12, jcfg.win_size, 8)
    tlv = tvm.empty_level(1 << 12, tcfg.win_size, 8)
    with pytest.raises(ValueError):
        jvm.insert_scan_level(jlv, 0.5, 64, jnp.array(pts), jnp.array(pts),
                              jnp.full((600,), 1e-4), jnp.ones(600), 0, 0.0)
    with pytest.raises(ValueError):
        tvm.insert_scan_level(tlv, 0.5, 64, t(pts), t(pts),
                              torch.full((600,), 1e-4), torch.ones(600), 0,
                              0.0)


def test_fused_insert_refuses_tracked_levels():
    """The steady step's insert raises ValueError on tracked levels in both
    packages: a pipeline with tracking on fails there, not at empty_map."""
    jcfg, tcfg = _configs()
    pts = np.random.default_rng(1).uniform(-4, 4, (64, 3)).astype(np.float32)
    eye = np.eye(3, dtype=np.float32)
    with pytest.raises(ValueError):
        jvm.insert_scan_fused(jvm.empty_map(jcfg), jcfg, jnp.array(pts),
                              jnp.array(pts), jnp.full((64,), 1e-4),
                              jnp.ones(64), 0, 0.0, jnp.array(eye),
                              jnp.zeros(3))
    with pytest.raises(ValueError):
        tvm.insert_scan_fused(tvm.empty_map(tcfg), tcfg, t(pts), t(pts),
                              torch.full((64,), 1e-4), torch.ones(64), 0,
                              0.0, t(eye), torch.zeros(3))


def test_harvest_matches_jax_and_transposes_to_harvest_t():
    """The factor-major harvest of a refreshed 4-frame room map against
    the JAX package's (equal counts and validity, stats within the insert
    tolerances), and transpose_factors of it equals harvest_t."""
    jcfg = small_map_config()
    tcfg = port_map_config(jcfg)
    frames = window_frames(np.random.default_rng(2), 4, 600)
    jl, tl = jvm.empty_map(jcfg), tvm.empty_map(tcfg)
    for i, (R, p, loc, mask, tr) in enumerate(frames):
        wld = loc @ R.T + p
        jl, _ = _jax_insert(jl, jcfg, jnp.asarray(wld), jnp.asarray(loc),
                            jnp.asarray(tr), jnp.asarray(mask), i, 0.0)
        tl = tvm.insert_scan(tl, tcfg, t(wld), t(loc), t(tr), t(mask), i, 0.0)
    Rs = np.stack([f[0] for f in frames])
    ps = np.stack([f[1] for f in frames])
    mp = np.arange(4, dtype=np.int32)
    jl = _jax_refresh(jl, jcfg, jnp.asarray(Rs), jnp.asarray(ps),
                      jnp.asarray(mp), 4)
    tl = tvm.refresh_planes(tl, tcfg, t(Rs), t(ps), t(mp, torch.int32), 4)
    mp = np.array([2, 0, 3, 1], np.int32)
    fj = jvm.harvest(jl, jcfg, jnp.asarray(mp), 128)
    ft = tvm.harvest(tl, tcfg, t(mp, torch.int32), 128)
    np.testing.assert_array_equal(n(ft.valid), np.asarray(fj.valid))
    np.testing.assert_array_equal(n(ft.coeff), np.asarray(fj.coeff))
    assert n(ft.valid).sum() > 20
    for a, b in ((ft.win, fj.win), (ft.fix, fj.fix)):
        np.testing.assert_allclose(n(a.n), np.asarray(b.n), atol=1e-5)
        np.testing.assert_allclose(n(a.mu), np.asarray(b.mu), atol=2e-4)
        np.testing.assert_allclose(n(a.S), np.asarray(b.S), atol=2e-3)
    for x, y in zip(tlf.transpose_factors(ft),
                    tvm.harvest_t(tl, tcfg, t(mp, torch.int32), 128)):
        assert torch.equal(x, y)


def test_tracked_levels_convert_and_checkpoint_round_trip():
    """A tracked JAX map converts to the port with tsl intact, and a
    SlamSystem with track_touched saves and reloads it unchanged."""
    from voxelslam_tpu_torch.config import SlamConfig
    from voxelslam_tpu_torch.pipeline import SlamSystem
    _, tcfg, jl, _, _, _, _, _, _ = _build_both(3)
    levels = tuple(convert.from_numpy(tvm.VoxelLevel, to_np_dict(lv))
                   for lv in jl)
    for a, b in zip(levels, jl):
        assert a.tsl.dtype == torch.int32
        np.testing.assert_array_equal(n(a.tsl), np.asarray(b.tsl))
    cfg = SlamConfig(map=tcfg)
    sysm = SlamSystem(cfg, enable_loop=False, device="cpu")
    assert all(lv.tsl.shape[1] for lv in sysm.odom.levels)
    sysm.odom.levels = levels
    buf = io.BytesIO()
    tck._Pickler(buf).dump(tck._state_dict(sysm.odom))
    buf.seek(0)
    back = tck._Unpickler(buf, torch.device("cpu")).load()["levels"]
    for a, b in zip(back, levels):
        assert torch.equal(a.tsl, b.tsl) and a.tsl.dtype == torch.int32
        assert torch.equal(a.win.S, b.win.S)
