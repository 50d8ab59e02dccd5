"""The fixed-order scatter-add (`voxelslam_tpu_torch/ops/segment_add.py`)
on the CPU: its launch plan, a numpy emulation of the CUDA kernels'
schedule (`csrc/segment_add.cu`) held bitwise to a sequential scatter-add
on both paths, and the port against the JAX package's
`.at[idx].add(val, mode="drop")` at the call sites' shapes.

The emulation follows the kernels step by step: path 2's partition (chunks,
per-bucket counts, the stable multi-split a warp of 32 at a time), each
sum block's list (all of idx, or its bucket's segments in chunk order), the
tiles, the order-preserving compaction CHUNK entries at a time, and, SUB
entries at a time, the same multi-split by tile row, the val rows staged in
that order and a chain a row. Rows never share an add, so a row's bits
depend only on the order of its entries: the emulation shows the schedule
keeps ascending source order. `tests/test_torch_kernels.py`
holds the kernels themselves to the CPU's index_add_ on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voxelslam_tpu_torch.core.tensors import drop_add
from voxelslam_tpu_torch.ops import segment_add as sa

torch.set_num_threads(1)

# XLA's CPU scatter may sum a row in another order than ascending source
# index: float32 rounding of up to a few thousand unit-normal terms on a
# hot row (tests/test_torch_steady_graph.py's tolerance)
RTOL, ATOL = 1e-5, 1e-4


def sequential(buf, idx, val):
    """out[r] = buf[r] + val[s0] + val[s1] + ..., ascending s, in buf's
    dtype; indices outside [0, C) dropped."""
    out = buf.copy()
    C = len(buf)
    for i, r in enumerate(idx):
        if 0 <= r < C:
            out[r] = out[r] + val[i]
    return out


def _multisplit(keys, cursor):
    """One pass of the kernels' stable multi-split: keys (<= THREADS, one a
    thread; -1 none) placed a warp of 32 lanes at a time at cursor[key] +
    the key's count in earlier warps + in earlier lanes. Returns the places
    (-1 for none) and advances cursor."""
    keys = np.asarray(keys)
    wc = np.zeros((sa.WARPS, len(cursor)), np.int64)
    places = np.full(len(keys), -1, np.int64)
    ranks = {}
    for t, k in enumerate(keys):
        if k < 0:
            continue
        seen = ranks.setdefault(t // 32, {})
        places[t] = seen.get(k, 0)                  # earlier lanes, same key
        seen[k] = places[t] + 1
    for w, seen in ranks.items():
        for k, c in seen.items():
            wc[w, k] = c
    for t, k in enumerate(keys):
        if k >= 0:
            places[t] += cursor[k] + wc[:t // 32, k].sum()
    cursor += wc.sum(axis=0)
    return places


def _partition(idx, C, pl):
    """partition_kernel: each chunk's sources placed by bucket, stably, a
    pass of THREADS at a time. Returns (part (N, 2), loff (P, B + 1))."""
    N, B = len(idx), pl.blocks
    part = np.full((N, 2), -1, np.int64)
    loff = np.zeros((pl.P, B + 1), np.int64)
    for p in range(pl.P):
        s0, s1 = p * pl.S, min(N, (p + 1) * pl.S)
        rows = idx[s0:s1]
        valid = (rows >= 0) & (rows < C)
        cnt = np.bincount(rows[valid] // pl.Rs, minlength=B)
        loff[p, :B] = np.cumsum(cnt) - cnt
        loff[p, B] = cnt.sum()
        cursor = loff[p, :B].copy()
        for base in range(s0, s1, sa.THREADS):
            r = idx[base:min(s1, base + sa.THREADS)]
            keys = np.where((r >= 0) & (r < C), r // pl.Rs, -1)
            for t, pos in enumerate(_multisplit(keys, cursor)):
                if pos >= 0:
                    part[s0 + pos] = (base + t, r[t])
    return part, loff


def _lists(idx, C, pl):
    """Each sum block's list of (source, row), in the order it reads it."""
    src = np.arange(len(idx))
    if pl.path == 1:
        return [(src, idx)] * pl.blocks
    part, loff = _partition(idx, C, pl)
    out = []
    for b in range(pl.blocks):
        seg = np.concatenate([part[p * pl.S + loff[p, b]:
                                   p * pl.S + loff[p, b + 1]]
                              for p in range(pl.P)]).reshape(-1, 2)
        out.append((seg[:, 0], seg[:, 1]))
    return out


def emulate(buf, idx, val, pl):
    """The kernels' schedule under plan `pl`, in numpy, in buf's dtype."""
    C = buf.shape[0]
    b2 = buf.reshape(C, -1)
    D = b2.shape[1]
    v2 = val.reshape(len(idx), D).astype(b2.dtype)
    out = np.full_like(b2, np.nan)
    for b, (lsrc, lrow) in enumerate(_lists(np.asarray(idx), C, pl)):
        brow0, brow1 = b * pl.Rs, min(C, (b + 1) * pl.Rs)
        for row0 in range(brow0, brow1, pl.R):
            nrows = min(pl.R, brow1 - row0)
            tile = b2[row0:row0 + nrows].copy()
            for j0 in range(0, len(lsrc), sa.CHUNK):
                # A. the pass's entries in the tile, in list order
                rel = lrow[j0:j0 + sa.CHUNK] - row0
                keep = (rel >= 0) & (rel < nrows)
                ksrc, krow = lsrc[j0:j0 + sa.CHUNK][keep], rel[keep]
                for e0 in range(0, len(ksrc), pl.sub):
                    # C1. the batch sorted by tile row, stably; B. its val
                    # rows in that order; C2. a chain a row
                    bsrc, brow = ksrc[e0:e0 + pl.sub], krow[e0:e0 + pl.sub]
                    cnt = np.bincount(brow, minlength=nrows)
                    start = np.concatenate([[0], np.cumsum(cnt)])
                    order = np.empty(len(bsrc), np.int64)
                    order[_multisplit(brow, start[:-1].copy())] = np.arange(
                        len(bsrc))
                    stash = v2[bsrc[order]]
                    for r in np.flatnonzero(cnt):
                        acc = tile[r].copy()
                        for j in range(start[r], start[r + 1]):
                            acc = acc + stash[j]
                        tile[r] = acc
            out[row0:row0 + nrows] = tile
    return out.reshape(buf.shape)


def _bits(a):
    a = np.ascontiguousarray(a)
    return a.view(np.int64 if a.dtype == np.float64 else np.int32)


def case(name):
    """(buf, idx, val) of a call site's shape, float32, int64 idx, from a
    seed; index C (dropped) among the sources."""
    rng = np.random.default_rng(sum(map(ord, name)))
    C, N, D = {"downsample": (4096, 4096, 4), "gba_insert": (8192, 8192, 9),
               "hot_rows": (4096, 4096, 4),
               "pose_graph": (1000 * 1000, 4036, 36),
               "pose_graph_g": (1000, 2018, 6)}[name]
    if name.startswith("pose_graph"):
        K = int(round(C ** 0.5)) if name == "pose_graph" else C
        i = np.concatenate([np.arange(K - 1), rng.integers(0, K, 10)])
        j = np.concatenate([np.arange(1, K), rng.integers(0, K, 10)])
        idx = (np.concatenate([i * K + i, i * K + j, j * K + i, j * K + j])
               if name == "pose_graph" else np.concatenate([i, j]))
        idx = np.resize(idx, N)
    else:
        idx = rng.integers(0, C + 1, N)
        if name == "hot_rows":              # 90% of the sources on 4 rows
            hot = rng.random(N) < 0.9
            idx[hot] = rng.choice(rng.integers(0, C, 4), hot.sum())
    idx[::97] = C
    buf = rng.normal(size=(C, D)).astype(np.float32)
    val = rng.normal(size=(N, D)).astype(np.float32)
    if name == "pose_graph":
        buf = np.zeros((C, 6, 6), np.float32)
        val = val.reshape(N, 6, 6)
    return buf, idx, val


PLAN_SHAPES = [
    (4096, 4096, 4, torch.float32, 8),          # the downsample (main path)
    (4096, 4096, 4, torch.float32, 4),
    (8192, 8192, 9, torch.float32, 8),          # a GBA window's insert
    (32768, 32768, 9, torch.float32, 8),        # fleet_batch 4
    (1000 * 1000, 4036, 36, torch.float32, 8),  # the pose graph's blocks
    (1000, 2018, 6, torch.float64, 8),
    (257, 900, 1, torch.float32, 8),
    (4096, 0, 4, torch.float32, 8),
    (200_000, 200_000, 1, torch.float32, 8),    # a large BTC cloud
    (64, 1_000_000, 36, torch.float64, 4),
]


@pytest.mark.parametrize("shape", PLAN_SHAPES,
                         ids=lambda s: "x".join(map(str, s[:3]))
                         + f"-{str(s[3])[6:]}-i{s[4] * 8}")
def test_plan_sizes_and_threshold(shape):
    """R a multiple of 8, shared memory within a block's 232,448 bytes,
    the blocks covering the rows once, and the path the threshold's."""
    C, N, D, dtype, isz = shape
    pl = sa.plan(C, N, D, dtype, isz)
    esz = torch.empty((), dtype=dtype).element_size()
    assert pl.R % 8 == 0 and pl.R >= 8 and pl.Rs >= pl.R
    assert pl.R * D * esz <= sa.TILE_BYTES
    assert pl.smem <= sa.SMEM_MAX and pl.smem_part <= sa.SMEM_MAX
    assert pl.blocks * pl.Rs >= C > (pl.blocks - 1) * pl.Rs
    assert pl.lg >= min(D, 32) and pl.lg & (pl.lg - 1) == 0
    assert pl.sub % 32 == 0 and 32 <= pl.sub <= 256
    one = sa.plan(C, N, D, dtype, isz, path=1)
    idx_bytes = one.blocks * N * isz
    own = (2 * C * D + N * D) * esz + N * isz
    assert pl.path == (1 if idx_bytes <= max(sa.ONE_LAUNCH_IDX_BYTES, own)
                       else 2)
    assert pl.launches == pl.path
    if pl.path == 2:
        assert 1 <= pl.P <= sa.PMAX and pl.P * pl.S >= N
        assert pl.blocks <= sa.BMAX
    else:
        assert pl.P == 0 and pl.Rs == pl.R


def test_plan_main_path_is_one_launch():
    """The downsample's shape (C = N = 4,096, D = 4, int64 idx) is one
    launch of 128 blocks of 32 rows; a GBA batch of four windows is two."""
    pl = sa.plan(4096, 4096, 4)
    assert (pl.path, pl.launches, pl.R, pl.blocks) == (1, 1, 32, 128)
    assert sa.plan(32768, 32768, 9).launches == 2


@pytest.mark.parametrize("bad", [(0, 5, 3), (10, 5, 0), (2 ** 31, 5, 3),
                                 (10, 5, 100_000)])
def test_plan_rejects_what_the_kernel_cannot_take(bad):
    with pytest.raises(ValueError):
        sa.plan(*bad)


@pytest.mark.parametrize("path", [1, 2])
@pytest.mark.parametrize("D", [1, 4, 9, 36])
def test_emulated_schedule_small_plans(path, D):
    """Both paths with small chunks, tiles and stashes (several partition
    chunks, sub-tiles in a bucket, several stash batches), a hot row and
    the dropped index: bitwise the sequential sum."""
    rng = np.random.default_rng(D + 10 * path)
    C, N = 203, 1500
    idx = rng.integers(0, C + 1, N)
    idx[::3] = 11
    idx[5::50] = -1                        # outside [0, C): dropped too
    buf = rng.normal(size=(C, D)).astype(np.float32)
    val = rng.normal(size=(N, D)).astype(np.float32)
    pl = sa.plan(C, N, D, path=path)
    if path == 2:
        pl = pl._replace(P=5, S=300, Rs=40, blocks=6, R=16, sub=32)
    else:
        pl = pl._replace(R=24, Rs=24, blocks=9, sub=64)
    assert np.array_equal(_bits(emulate(buf, idx, val, pl)),
                          _bits(sequential(buf, idx, val)))


CASES = ["downsample", "gba_insert", "hot_rows", "pose_graph",
         "pose_graph_g"]


@pytest.mark.parametrize("name", CASES)
def test_call_site_shapes_match_jax(name):
    """At each call site's shape: the emulated kernels (the plan's path and
    the other) and the CPU path bitwise the sequential sum, and within the
    float32 tolerance of the JAX package's drop-mode scatter-add."""
    buf, idx, val = case(name)
    want = sequential(buf.reshape(len(buf), -1), idx,
                      val.reshape(len(idx), -1)).reshape(buf.shape)
    C, D = len(buf), buf[0].size
    pl = sa.plan(C, len(idx), D)
    paths = [pl.path] if name == "pose_graph" else [1, 2]
    for path in paths:
        got = emulate(buf, idx, val, sa.plan(C, len(idx), D, path=path))
        assert np.array_equal(_bits(got), _bits(want)), path
    tb, ti, tv = map(torch.from_numpy, (buf, idx, val))
    port = sa.segment_add(tb, ti, tv)
    assert np.array_equal(_bits(port.numpy()), _bits(want))
    jx = np.asarray(jnp.asarray(buf).at[idx].add(val, mode="drop"))
    np.testing.assert_allclose(jx, want, rtol=RTOL, atol=ATOL)


def test_int32_idx_float64_values_match_jax():
    """int32 indices and float64 values (the emulation in float64): bitwise
    the sequential sum; within the float32 tolerance of JAX's (float32
    here: the tests run JAX without x64)."""
    rng = np.random.default_rng(64)
    C, N, D = 500, 3000, 6
    idx = rng.integers(0, C + 1, N).astype(np.int32)
    buf = rng.normal(size=(C, D))
    val = rng.normal(size=(N, D))
    want = sequential(buf, idx, val)
    for path in (1, 2):
        got = emulate(buf, idx, val, sa.plan(C, N, D, torch.float64, 4,
                                             path=path))
        assert np.array_equal(_bits(got), _bits(want))
    port = drop_add(torch.from_numpy(buf), torch.from_numpy(idx),
                    torch.from_numpy(val))
    assert port.dtype == torch.float64
    assert np.array_equal(_bits(port.numpy()), _bits(want))
    jx = np.asarray(jnp.asarray(buf, jnp.float32).at[idx].add(
        jnp.asarray(val, jnp.float32), mode="drop"))
    np.testing.assert_allclose(jx, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("what", ["no_sources", "all_dropped"])
def test_empty_and_dropped_match_jax(what):
    """N = 0, and every index C: the result is buf, bitwise, as JAX's."""
    rng = np.random.default_rng(7)
    C, D = 300, 4
    N = 0 if what == "no_sources" else 800
    idx = np.full(N, C, np.int64)
    buf = rng.normal(size=(C, D)).astype(np.float32)
    val = rng.normal(size=(N, D)).astype(np.float32)
    assert np.array_equal(_bits(emulate(buf, idx, val, sa.plan(C, N, D))),
                          _bits(buf))
    port = sa.segment_add(*map(torch.from_numpy, (buf, idx, val)))
    assert np.array_equal(_bits(port.numpy()), _bits(buf))
    jx = np.asarray(jnp.asarray(buf).at[idx].add(val, mode="drop"))
    assert np.array_equal(_bits(jx), _bits(buf))


def test_zero_flag_ignores_buf():
    """`zero=True`: buf's values are not read (NaN here); the result is the
    sums alone, bitwise those added to a zero buffer, as the pose graph
    uses it."""
    rng = np.random.default_rng(12)
    C, N, D = 120, 700, 6
    idx = torch.as_tensor(rng.integers(0, C + 1, N))
    val = torch.as_tensor(rng.normal(size=(N, D)).astype(np.float32))
    junk = torch.full((C, D), float("nan"))
    got = sa.segment_add(junk, idx, val, zero=True)
    want = sa.segment_add(torch.zeros(C, D), idx, val)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
