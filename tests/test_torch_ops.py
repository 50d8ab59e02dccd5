"""Parity of the port's ops (voxel hash, dedup, downsample, kNN, moment
accumulation) with the JAX package. Hash keys and slots must match
exactly: slot assignment decides which voxel every point lands in."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voxelslam_tpu.ops import (voxel_hash as jvh, downsample as jds,
                               knn as jknn, moments as jmo)
from voxelslam_tpu_torch.ops import voxel_hash as vh, knn, moments as mo
from voxelslam_tpu_torch.ops.downsample import voxel_downsample

from test_torch_helpers import n, t

torch.set_num_threads(1)


def _keys(rng, N, span=40):
    k = rng.integers(-span, span, (N, 3)).astype(np.int32)
    k[:4] = [[2 ** 31 - 1, -2 ** 31, 0], [-1, -1, -1], [65536, -65537, 7],
             [123456789, -987654321, 2 ** 30]]
    return k


@pytest.mark.parametrize("cap", [1 << 11, 1 << 16, 1 << 30, 12345])
def test_hash_key_exact(cap):
    """uint32 multiply/xor-shift/mod emulated in int64: bit-exact."""
    k = _keys(np.random.default_rng(0), 5000, span=2 ** 31 - 1)
    a = np.asarray(jvh.hash_key(jnp.asarray(k), cap))
    b = n(vh.hash_key(t(k, torch.int32), cap))
    np.testing.assert_array_equal(b, a)


def test_voxel_key_exact():
    p = np.random.default_rng(1).uniform(-50, 50, (4000, 3)).astype(np.float32)
    for size in (1.0, 0.5, 0.25):
        np.testing.assert_array_equal(n(vh.voxel_key(t(p), size)),
                                      np.asarray(jvh.voxel_key(jnp.asarray(p),
                                                               size)))


@pytest.mark.parametrize("unique_max", [64, 4096])
def test_dedup_keys_exact(unique_max):
    """Same uniques in the same order and the same inverse map, including
    when uniques overflow unique_max (the same subset is dropped)."""
    rng = np.random.default_rng(2)
    k = _keys(rng, 3000, span=12)
    valid = rng.random(3000) > 0.2
    a = jvh.dedup_keys(jnp.asarray(k), jnp.asarray(valid), unique_max)
    b = vh.dedup_keys(t(k, torch.int32), t(valid, torch.bool), unique_max)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(n(y), np.asarray(x))


def test_insert_lookup_exact():
    """Two insert batches into a small table (existing-key hits, probe
    chains, elections, exhausted chains) and lookups of present, absent
    and invalid keys: tables and slots identical."""
    rng = np.random.default_rng(3)
    C = 512
    jk, jo = jvh.empty_table(C)
    tk, to = vh.empty_table(C)
    for r in range(2):
        q = np.unique(_keys(rng, 400, span=30)[4:], axis=0)
        q = q[rng.permutation(len(q))]
        valid = rng.random(len(q)) > 0.1
        jk, jo, js = jvh.insert(jk, jo, jnp.asarray(q), jnp.asarray(valid))
        tk, to, ts = vh.insert(tk, to, t(q, torch.int32), t(valid, torch.bool))
        np.testing.assert_array_equal(n(ts), np.asarray(js))
        np.testing.assert_array_equal(n(tk), np.asarray(jk))
        np.testing.assert_array_equal(n(to), np.asarray(jo))
    assert (n(ts) < 0).any() and (n(ts) >= 0).any()     # drops exercised
    q = _keys(rng, 600, span=30)
    valid = rng.random(600) > 0.1
    np.testing.assert_array_equal(
        n(vh.lookup(tk, to, t(q, torch.int32), t(valid, torch.bool))),
        np.asarray(jvh.lookup(jk, jo, jnp.asarray(q), jnp.asarray(valid))))


def test_voxel_downsample_parity():
    rng = np.random.default_rng(4)
    p = rng.uniform(-10, 10, (3000, 3)).astype(np.float32)
    m = (rng.random(3000) > 0.1).astype(np.float32)
    a = jds.voxel_downsample(jnp.asarray(p), jnp.asarray(m), 0.5, 2048)
    b = voxel_downsample(t(p), t(m), 0.5, 2048)
    np.testing.assert_array_equal(n(b[1]), np.asarray(a[1]))
    np.testing.assert_array_equal(n(b[2]), np.asarray(a[2]))
    np.testing.assert_allclose(n(b[0]), np.asarray(a[0]), atol=1e-5)


@pytest.mark.parametrize("n_valid", [3, 400])
def test_knn_ties_go_to_the_lower_index(n_valid):
    """Duplicated refs (equal distances at and around the 5th place) and
    rows with fewer than 5 valid refs (ties at +inf): the same indices as
    `jax.lax.top_k`, which puts the lower index first."""
    rng = np.random.default_rng(6)
    base = rng.integers(-3, 4, (100, 3)).astype(np.float32)
    ref = base[rng.integers(0, 100, 400)]                # many exact copies
    rmask = np.zeros(400, np.float32)
    rmask[rng.permutation(400)[:n_valid]] = 1.0
    q = rng.integers(-3, 4, (300, 3)).astype(np.float32)
    ia, da = jknn.knn(jnp.asarray(q), jnp.asarray(ref), jnp.asarray(rmask), 5,
                      chunk=128)
    ib, db = knn.knn(t(q), t(ref), t(rmask), 5, chunk=128)
    np.testing.assert_array_equal(n(ib), np.asarray(ia))
    np.testing.assert_array_equal(n(db), np.asarray(da))


def test_knn_and_plane_fit_parity():
    rng = np.random.default_rng(5)
    ref = rng.uniform(-5, 5, (1500, 3)).astype(np.float32)
    ref[:, 2] = 0.01 * rng.normal(size=1500)             # a plane z ~ 0
    ref[1000:, 2] += 3.0                                 # and a second one
    rmask = (rng.random(1500) > 0.2).astype(np.float32)
    q = rng.uniform(-5, 5, (700, 3)).astype(np.float32)
    q[:, 2] = rng.choice([0.02, 3.0, 1.5], 700)
    ia, da = jknn.knn(jnp.asarray(q), jnp.asarray(ref), jnp.asarray(rmask), 5,
                      chunk=256)
    ib, db = knn.knn(t(q), t(ref), t(rmask), 5, chunk=256)
    np.testing.assert_array_equal(n(ib), np.asarray(ia))
    np.testing.assert_allclose(n(db), np.asarray(da), atol=1e-4)
    a = jknn.plane_fit_nn(jnp.asarray(q), jnp.asarray(ref), jnp.asarray(rmask))
    b = knn.plane_fit_nn(t(q), t(ref), t(rmask))
    np.testing.assert_array_equal(n(b["valid"]), np.asarray(a["valid"]))
    assert n(b["valid"]).sum() > 100
    # a 5-point fit whose two smallest scatter eigenvalues nearly tie
    # (near-collinear neighbours) has no well-defined normal: f32
    # rounding alone turns it; compare the well-conditioned fits
    A = ref[np.asarray(ia)].astype(np.float64)
    D = A - A.mean(1, keepdims=True)
    lam = np.linalg.eigvalsh(np.einsum("nki,nkj->nij", D, D))
    good = (lam[:, 1] - lam[:, 0]) > 1e-2 * lam[:, 2]
    assert good.mean() > 0.8
    np.testing.assert_allclose(n(b["normal"])[good],
                               np.asarray(a["normal"])[good], atol=1e-4)
    # d = -n.c with |c| up to ~5 m: the normal's 1e-4 shows up 5x larger
    np.testing.assert_allclose(n(b["d"])[good], np.asarray(a["d"])[good],
                               atol=5e-4)


def _moment_inputs(rng, caps, P):
    q = rng.uniform(-0.5, 0.5, (P, 3)).astype(np.float32)
    nv = rng.normal(0, 1e-3, (P, 5)).astype(np.float32)
    w = (rng.random(P) > 0.2).astype(np.float32)
    slots = np.stack([rng.integers(0, c, P) for c in caps]).astype(np.int32)
    slots[:, :P // 3] = 3                                # a hot slot
    return q, nv, w, slots


def test_pack_unpack_parity():
    q, nv, w, _ = _moment_inputs(np.random.default_rng(6), (8,), 200)
    a = jmo.pack_updates(jnp.asarray(q), jnp.asarray(nv), jnp.asarray(w))
    b = mo.pack_updates(t(q), t(nv), t(w))
    np.testing.assert_array_equal(n(b), np.asarray(a))
    np.testing.assert_array_equal(n(mo.unpack_sym6(b[:, 4:10])),
                                  np.asarray(jmo.unpack_sym6(a[:, 4:10])))


@pytest.mark.parametrize("interpret", [False, True])
def test_accumulate_ref_vs_jax(interpret):
    """The plain version against the JAX accumulate, both as its XLA
    scatter-add fallback and as the Pallas TPU kernel in interpret mode
    (as tests/test_voxel_map.py runs it). Sums of <= P/3 rows of O(1):
    atol 1e-5."""
    caps = (64, 128, 256)
    P = 150
    rng = np.random.default_rng(7)
    q, nv, w, slots = _moment_inputs(rng, caps, P)
    upd = np.stack([np.asarray(jmo.pack_updates(
        jnp.asarray(q), jnp.asarray(nv), jnp.asarray(w)))] * len(caps))
    upd[1] *= 0.5
    a = jmo.accumulate(jnp.asarray(slots), jnp.asarray(upd), caps,
                       interpret=interpret)
    b = mo.accumulate_ref(t(slots, torch.int32), t(upd), caps)
    for x, y in zip(a, b):
        np.testing.assert_allclose(n(y), np.asarray(x), atol=1e-5)
