"""Fixed-capacity open-addressing hash for integer voxel keys (port of
`voxelslam_tpu/ops/voxel_hash.py`).

Same table layout, hash, triangular probe sequence (PROBES = 8 rounds)
and round-tagged scatter-min insert elections as the JAX package, so the
two place every key in the same slot. Torch has no uint32 arithmetic:
the hash runs in int64 with every product and shift reduced mod 2^32,
and 32x32-bit products are split so no int64 product can overflow.
XLA's `mode="drop"` scatters become writes into one spare row at index C.
"""

from __future__ import annotations

import torch

PROBES = 8
EMPTY_KEY = -(2 ** 31)          # int32 min: stored in keys[:, 0] when free
_INIT_TAG = 2 ** 31 - 1         # int32 max
_M32 = 0xFFFFFFFF


def voxel_key(points: torch.Tensor, voxel_size: float) -> torch.Tensor:
    """World points (..., 3) -> integer voxel coords (..., 3) int32
    (floor-toward-negative binning, reference tools.hpp:207-216)."""
    return torch.floor(points / voxel_size).to(torch.int32)


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """(h * c) mod 2^32 for 0 <= h < 2^32 in int64 without overflow: the
    constant is split into 16-bit halves, each partial product < 2^48."""
    lo, hi = c & 0xFFFF, c >> 16
    return (h * lo + (((h * hi) & 0xFFFF) << 16)) & _M32


def hash_key(keys: torch.Tensor, capacity: int) -> torch.Tensor:
    """Mix (..., 3) int32 coords into table indices [0, capacity), bit-exact
    with the JAX package's uint32 multiplicative hash + murmur3
    finalizer."""
    k = keys.to(torch.int64) & _M32
    h = _mul32(k[..., 0], 73856093)
    h = (h + _mul32(k[..., 1], 19349669)) & _M32
    h = (h + _mul32(k[..., 2], 83492791)) & _M32
    h = h ^ (h >> 16)
    h = _mul32(h, 0x7FEB352D)
    h = h ^ (h >> 15)
    h = _mul32(h, 0x846CA68B)
    h = h ^ (h >> 16)
    return (h % capacity).to(torch.int32)


def _cands(h0: torch.Tensor, capacity: int) -> torch.Tensor:
    """(Q,) -> (Q, PROBES) int64 probe slots h0 + r(r+1)/2 mod C."""
    r = torch.arange(PROBES, device=h0.device, dtype=torch.int64)
    return (h0.to(torch.int64)[..., None] + (r * (r + 1)) // 2) % capacity


def empty_table(capacity: int, device=None):
    keys = torch.full((capacity, 3), EMPTY_KEY, dtype=torch.int32,
                      device=device)
    occ = torch.zeros((capacity,), dtype=torch.bool, device=device)
    return keys, occ


def _first_true(hit: torch.Tensor) -> torch.Tensor:
    """Index of the first True along the last axis (0 if none), like
    jnp.argmax over bools."""
    return torch.argmax(hit.to(torch.int32), dim=-1)


def lookup(table_keys: torch.Tensor, occ: torch.Tensor,
           queries: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Slots (Q,) int32 of query keys (Q, 3), -1 where absent/invalid.
    Occupancy is implied by the EMPTY_KEY sentinel (`occ` unused, as in
    the JAX package)."""
    del occ
    C = table_keys.shape[0]
    cands = _cands(hash_key(queries, C), C)                   # (Q, PROBES)
    k = table_keys[cands]                                     # (Q, PROBES, 3)
    hit = torch.all(k == queries[..., None, :], dim=-1)
    r_first = _first_true(hit)
    slot = torch.gather(cands, -1, r_first[..., None])[..., 0]
    return torch.where(valid & torch.any(hit, dim=-1), slot, -1).to(torch.int32)


def insert(table_keys: torch.Tensor, occ: torch.Tensor,
           queries: torch.Tensor, valid: torch.Tensor):
    """Insert deduplicated keys; returns (table_keys, occ, slots (Q,) int32).

    Existing keys resolve to their slot from one (Q, PROBES) gather; free
    slots are claimed in PROBES sequential scatter-min elections with tag
    r*Q + query index (earlier rounds always win). Rows whose chain is
    exhausted get slot -1. The input tables are not modified."""
    C = table_keys.shape[0]
    Q = queries.shape[0]
    dev = queries.device
    cands = _cands(hash_key(queries, C), C)                   # (Q, PROBES)
    ks = table_keys[cands]
    occ_r = ks[..., 0] != EMPTY_KEY
    hits = occ_r & torch.all(ks == queries[:, None, :], dim=-1)
    any_hit = torch.any(hits, dim=-1) & valid
    hit_slot = torch.gather(cands, 1, _first_true(hits)[:, None])[:, 0]

    slot = torch.where(any_hit, hit_slot, -1)
    done = ~valid | any_hit
    # one spare entry at C receives the dropped (non-wanting) claims
    election = torch.full((C + 1,), _INIT_TAG, dtype=torch.int64, device=dev)
    qidx = torch.arange(Q, dtype=torch.int64, device=dev)
    for r in range(PROBES):
        cand = cands[:, r]
        tag = r * Q + qidx
        want = ~done & ~occ_r[:, r] & (election[cand] == _INIT_TAG)
        e_idx = torch.where(want, cand, C)
        e_upd = torch.where(want, tag, _INIT_TAG)
        election = election.scatter_reduce(0, e_idx, e_upd, "amin",
                                           include_self=True)
        won = want & (election[cand] == tag)
        slot = torch.where(won, cand, slot)
        done = done | won

    new = (slot >= 0) & ~occ[torch.clamp(slot, min=0)]
    tgt = torch.where(new, slot, C)
    keys_p = torch.cat([table_keys, table_keys.new_zeros((1, 3))])
    keys_p[tgt] = queries.to(table_keys.dtype)
    occ_p = torch.cat([occ, occ.new_zeros((1,))])
    occ_p.index_fill_(0, tgt, True)        # a scalar fill, no host copy
    return keys_p[:C], occ_p[:C], slot.to(torch.int32)


def dedup_keys(keys: torch.Tensor, valid: torch.Tensor, unique_max: int):
    """Deduplicate (N, 3) int32 keys -> (uniq_keys (unique_max, 3),
    uniq_valid (unique_max,), inverse (N,) int32, -1 for invalid/overflow).

    Sorted by (hash, packed xy, sign-flipped z) exactly like the JAX
    package's lexsort: three stable sorts, least significant key first,
    so overflow drops the same pseudo-random subset of uniques."""
    N = keys.shape[0]
    dev = keys.device
    imax = 2 ** 31 - 1
    big = torch.where(valid[:, None], keys.to(torch.int32),
                      torch.full_like(keys, imax, dtype=torch.int32))
    h = hash_key(big, 1 << 30).to(torch.int64)
    h = torch.where(valid, h, imax)
    b = big.to(torch.int64) & _M32
    xy = ((b[:, 0] << 16) & _M32) | (b[:, 1] & 0xFFFF)
    zu = b[:, 2] ^ 0x80000000
    order = torch.sort(zu, stable=True).indices
    order = order[torch.sort(xy[order], stable=True).indices]
    order = order[torch.sort(h[order], stable=True).indices]
    sk = big[order]
    hs, xys, zus = h[order], xy[order], zu[order]
    first = torch.cat([
        torch.ones((1,), dtype=torch.bool, device=dev),
        (hs[1:] != hs[:-1]) | (xys[1:] != xys[:-1]) | (zus[1:] != zus[:-1]),
    ])
    valid_sorted = valid[order]
    first = first & valid_sorted
    uid_sorted = torch.cumsum(first.to(torch.int64), 0) - 1
    overflow = uid_sorted >= unique_max
    uid_sorted = torch.where(valid_sorted & ~overflow, uid_sorted, -1)

    keep = first & ~overflow
    tgt = torch.where(keep, uid_sorted, unique_max)
    uniq_keys = torch.full((unique_max + 1, 3), EMPTY_KEY, dtype=torch.int32,
                           device=dev)
    uniq_keys[tgt] = sk
    uniq_keys = uniq_keys[:unique_max]
    n_uniq = torch.sum(keep.to(torch.int64))
    uniq_valid = torch.arange(unique_max, device=dev) < n_uniq

    inverse = torch.empty((N,), dtype=torch.int64, device=dev)
    inverse[order] = uid_sorted
    return uniq_keys, uniq_valid, inverse.to(torch.int32)
