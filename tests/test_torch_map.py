"""Parity of the port's voxel map (main-path subset: fused insert, plane
refresh, matching, harvest, marginalization, eviction) with the JAX
package. Maps are built on both sides from the same seeded room scans;
hash keys and slots must match exactly, cluster statistics within the
TestFusedInsert tolerances of tests/test_voxel_map.py (n 1e-5, mu 2e-4,
S 2e-3)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voxelslam_tpu.map import voxel_map as jvm
from voxelslam_tpu_torch.map import voxel_map as tvm

from test_torch_helpers import (n, t, window_frames, build_maps,
                                assert_level_close, small_map_config,
                                port_map_config)

torch.set_num_threads(1)

DEPT_ERR, BEAM_ERR = 0.02, 0.05


def _maps(seed, n_built=3, jours=None):
    """Maps built from n_built room scans at window slots 0.., plus one
    more scan (R, p, local points, mask) for the test to insert."""
    jcfg = small_map_config()
    rng = np.random.default_rng(seed)
    frames = window_frames(rng, n_built + 1, 400)
    jl, tl, Rs, ps = build_maps(jcfg, frames[:n_built], jours)
    return jcfg, port_map_config(jcfg), frames, jl, tl, Rs, ps


def _assert_tables_close(ja, tb):
    for la, lb in zip(ja, tb):
        assert_level_close(la, lb)
        for a, b in ((la.win_nv, lb.win_nv), (la.fix_nv, lb.fix_nv),
                     (la.tot_nv, lb.tot_nv)):
            np.testing.assert_allclose(n(b), np.asarray(a), atol=1e-5)
        np.testing.assert_array_equal(n(lb.jour), np.asarray(la.jour))


def _fused_insert_both(jcfg, tcfg, frames, jl, tl, slot, interpret=False):
    R, p, loc, mask, _ = frames[-1]
    wld = loc @ R.T + p
    nv = np.asarray(jvm.point_noise_record(jnp.asarray(loc), DEPT_ERR,
                                           BEAM_ERR))
    ja, jt = jvm.insert_scan_fused(
        jl, jcfg, jnp.asarray(wld), jnp.asarray(loc), jnp.asarray(nv),
        jnp.asarray(mask), slot, 2.0, jnp.asarray(R), jnp.asarray(p),
        interpret=interpret)
    tb, tt = tvm.insert_scan_fused(tl, tcfg, t(wld), t(loc), t(nv), t(mask),
                                   slot, 2.0, t(R), t(p))
    return ja, jt, tb, tt


def test_point_noise_record_and_expand_noise():
    rng = np.random.default_rng(0)
    pts = rng.uniform(-20, 20, (500, 3)).astype(np.float32)
    np.testing.assert_allclose(
        n(tvm.point_noise_record(t(pts), DEPT_ERR, BEAM_ERR)),
        np.asarray(jvm.point_noise_record(jnp.asarray(pts), DEPT_ERR,
                                          BEAM_ERR)), rtol=1e-5, atol=1e-9)
    tr = rng.uniform(0, 1e-3, 500).astype(np.float32)
    np.testing.assert_array_equal(n(tvm.expand_noise(t(tr))),
                                  np.asarray(jvm.expand_noise(jnp.asarray(tr))))


@pytest.mark.parametrize("interpret", [False, True])
def test_insert_scan_fused_parity(interpret):
    """Fused insert into a populated map: the port's `accumulate_ref`
    against the JAX accumulate as its XLA fallback and as the Pallas
    kernel in interpret mode."""
    jcfg, tcfg, frames, jl, tl, Rs, ps = _maps(1)
    ja, jt, tb, tt = _fused_insert_both(jcfg, tcfg, frames, jl, tl, 3,
                                        interpret)
    _assert_tables_close(ja, tb)
    # the port's touched entries end with the points the dedup dropped
    # past unique_max, which the JAX package does not count (none here)
    for (sa, va, da), (sb, vb, db, ub) in zip(jt, tt):
        np.testing.assert_array_equal(n(sb), np.asarray(sa))
        np.testing.assert_array_equal(n(vb), np.asarray(va))
        assert int(db) == int(da)
        assert int(ub) == 0
    assert n(tb[0].win.n[3]).sum() > 300


def test_insert_scan_touched_parity():
    """The dense scatter insert used by the init path."""
    jcfg, tcfg, frames, jl, tl, Rs, ps = _maps(2)
    R, p, loc, mask, tr = frames[-1]
    wld = loc @ R.T + p
    ja, jt = jvm.insert_scan_touched(jl, jcfg, jnp.asarray(wld),
                                     jnp.asarray(loc), jnp.asarray(tr),
                                     jnp.asarray(mask), 3, 1.5)
    tb, tt = tvm.insert_scan_touched(tl, tcfg, t(wld), t(loc), t(tr),
                                     t(mask), 3, 1.5)
    _assert_tables_close(ja, tb)
    for (sa, va, da), (sb, vb, db) in zip(jt, tt):
        np.testing.assert_array_equal(n(sb), np.asarray(sa))
        np.testing.assert_array_equal(n(vb), np.asarray(va))
        assert int(db) == int(da)


def _assert_planes_close(ja, tb, cfg, min_planes=20):
    """Plane states exact; slab (normal, centre, radius, cmean, cvar,
    state) and eigenvalues within f32 tolerance of O(1) quantities.
    Eigenvalues are compared where the fit can make a voxel a plane
    (n > min_point): a 2-point cluster is rank 1, and the closed-form
    solver's double root at 0 amplifies rounding to ~1e-4 on both
    sides alike."""
    for l, (la, lb) in enumerate(zip(ja, tb)):
        np.testing.assert_array_equal(n(lb.state), np.asarray(la.state))
        fit = np.asarray(la.tot.n) > cfg.min_point[l]
        np.testing.assert_allclose(n(lb.lam)[fit], np.asarray(la.lam)[fit],
                                   atol=2e-5)
        plane = np.asarray(la.state) == jvm.STATE_PLANE
        np.testing.assert_allclose(n(lb.slab)[plane],
                                   np.asarray(la.slab)[plane], atol=2e-4)
    assert sum(int((np.asarray(la.state) == jvm.STATE_PLANE).sum())
               for la in ja) >= min_planes


def test_refresh_planes_full_parity():
    jcfg, tcfg, frames, jl, tl, Rs, ps = _maps(3)
    _assert_planes_close(jl, tl, jcfg)
    _assert_tables_close(jl, tl)          # tot resynced by the full refresh


def test_refresh_planes_touched_parity():
    jcfg, tcfg, frames, jl, tl, Rs, ps = _maps(4)
    ja, jt, tb, tt = _fused_insert_both(jcfg, tcfg, frames, jl, tl, 3)
    Rs = np.concatenate([Rs[:3], frames[-1][0][None]])
    ps = np.concatenate([ps[:3], frames[-1][1][None]])
    mp = np.arange(4, dtype=np.int32)
    ja = jvm.refresh_planes(ja, jcfg, jnp.asarray(Rs), jnp.asarray(ps),
                            jnp.asarray(mp), 4, touched=jt)
    tb = tvm.refresh_planes(tb, tcfg, t(Rs), t(ps), t(mp, torch.int32), 4,
                            touched=tt)
    _assert_planes_close(ja, tb, jcfg)


def test_match_locate_and_eval_parity():
    jcfg, tcfg, frames, jl, tl, Rs, ps = _maps(5)
    R, p, loc, mask, _ = frames[-1]
    wld = (loc @ R.T + p).astype(np.float32)
    rng = np.random.default_rng(6)
    A = rng.normal(0, 3e-3, (len(loc), 3, 3))
    var = (A @ A.transpose(0, 2, 1)).astype(np.float32)
    rec_j, found_j = jvm.match_locate(jl, jcfg, jnp.asarray(wld),
                                      jnp.asarray(mask))
    rec_t, found_t = tvm.match_locate(tl, tcfg, t(wld), t(mask))
    np.testing.assert_array_equal(n(found_t), np.asarray(found_j))
    assert n(found_t).sum() > 100
    np.testing.assert_allclose(n(rec_t), np.asarray(rec_j), atol=2e-4)
    # evaluate both sides' gates on the same (JAX) records
    a = jvm.match_eval(rec_j, found_j, jnp.asarray(wld), jnp.asarray(var),
                       jnp.asarray(mask))
    b = tvm.match_eval(t(rec_j), t(found_j, torch.bool), t(wld), t(var),
                       t(mask))
    np.testing.assert_array_equal(n(b["valid"]), np.asarray(a["valid"]))
    for k in ("dist", "sigma", "normal", "center"):
        np.testing.assert_allclose(n(b[k]), np.asarray(a[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)


def test_compact_indices_exact():
    rng = np.random.default_rng(7)
    for p in (0.0, 0.01, 0.3, 1.0):
        flags = rng.random(777) < p
        for size in (1, 64, 800):
            np.testing.assert_array_equal(
                n(tvm.compact_indices(t(flags, torch.bool), size, 777)),
                np.asarray(jvm.compact_indices(jnp.asarray(flags), size,
                                               777)))


def test_harvest_t_parity():
    jcfg, tcfg, frames, jl, tl, Rs, ps = _maps(8)
    mp = np.array([2, 3, 0, 1], np.int32)          # a rolled window
    a = jvm.harvest_t(jl, jcfg, jnp.asarray(mp), 96)
    b = tvm.harvest_t(tl, tcfg, t(mp, torch.int32), 96)
    assert len(a) == len(b) == 7
    np.testing.assert_array_equal(n(b[6]), np.asarray(a[6]))     # valid
    assert n(b[6]).sum() > 20
    for x, y, tol in zip(a[:6], b[:6], (1e-5, 2e-4, 2e-3, 1e-5, 2e-4, 2e-3)):
        np.testing.assert_allclose(n(y), np.asarray(x), atol=tol)


def test_marginalize_parity():
    jcfg, tcfg, frames, jl, tl, Rs, ps = _maps(9)
    ja, _, tb, _ = _fused_insert_both(jcfg, tcfg, frames, jl, tl, 3)
    Rs = np.concatenate([Rs[:3], frames[-1][0][None]])
    ps = np.concatenate([ps[:3], frames[-1][1][None]])
    mp = np.arange(4, dtype=np.int32)
    for mg in (1, 2):
        a = jvm.marginalize(ja, jcfg, jnp.asarray(Rs), jnp.asarray(ps),
                            jnp.asarray(mp), 4, mg)
        b = tvm.marginalize(tb, tcfg, t(Rs), t(ps), t(mp, torch.int32), 4,
                            mg)
        _assert_tables_close(a, b)
        assert float(n(b[0].win.n[0]).sum()) == 0.0
        assert n(b[0].fix.n).sum() > 300


def test_evict_parity():
    """Voxels first seen more than max_dist of travel ago leave the map;
    the survivors are rehashed into the same slots on both sides."""
    jcfg, tcfg, frames, jl, tl, Rs, ps = _maps(10, jours=[0.0, 1.0, 2.0])
    a, da = jvm.evict(jl, jnp.float32(2.5), 1.0)
    b, db = tvm.evict(tl, torch.tensor(2.5), 1.0)
    np.testing.assert_array_equal(n(db), np.asarray(da))
    _assert_tables_close(a, b)
    # survivors are the few voxels the later scans added: no plane needed
    _assert_planes_close(a, b, jcfg, min_planes=0)
    for lb, l0 in zip(b, tl):
        assert 0 < n(lb.occ).sum() < n(l0.occ).sum()
