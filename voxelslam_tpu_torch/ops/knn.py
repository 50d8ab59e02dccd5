"""Brute-force k-nearest-neighbour + batched 5-point plane fits (port of
`voxelslam_tpu/ops/knn.py`), used by the init-phase kd-tree LIO and the
loop-verification ICP."""

from __future__ import annotations

import torch

from ..core.eig3 import eigh3_forward

NMATCH = 5  # reference tools.hpp:17


def _smallest_k(d2: torch.Tensor, k: int):
    """The k smallest entries along the last axis, ascending, ties to the
    lower column (as `jax.lax.top_k` orders them), without a host round
    trip.

    Each entry becomes one int64 key: its f32 bits, made monotone as a
    signed integer, in the high word and its column in the low word. The
    keys of a row are distinct and order as (value, column), so `topk`
    over them has no ties to break."""
    bits = d2.view(torch.int32)
    mono = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    col = torch.arange(d2.shape[-1], dtype=torch.int64, device=d2.device)
    key = (mono.to(torch.int64) << 32) | col
    idx = torch.topk(key, k, dim=-1, largest=False, sorted=True).values
    idx = idx & 0xFFFFFFFF
    return idx, torch.gather(d2, -1, idx)


def knn(query: torch.Tensor, ref: torch.Tensor, ref_mask: torch.Tensor,
        k: int, chunk: int = 2048):
    """k nearest refs per query: (idx (..., N, k) int64, dist2 (..., N, k)).

    query (N, 3), ref (M, 3), ref_mask (M,); or with a leading batch axis
    on all three, each batch against its own refs. Invalid refs get +inf
    distance. Per query chunk the distances are one `addmm` (`baddbmm`
    with a batch axis), (|q|^2 + |r|^2 + penalty) - 2 q r^T, and ties go
    to the lower ref index as with `jax.lax.top_k`."""
    r2p = torch.sum(ref * ref, dim=-1) + torch.where(ref_mask > 0, 0.0,
                                                     float("inf"))
    mm = torch.addmm if query.dim() == 2 else torch.baddbmm
    idxs, d2s = [], []
    for s in range(0, query.shape[-2], chunk):
        qc = query[..., s:s + chunk, :]
        d2 = mm(torch.sum(qc * qc, dim=-1)[..., :, None]
                + r2p[..., None, :], qc, ref.transpose(-1, -2), alpha=-2.0)
        idx, val = _smallest_k(d2, k)
        idxs.append(idx)
        d2s.append(val)
    return (torch.cat(idxs, dim=-2),
            torch.clamp(torch.cat(d2s, dim=-2), min=0.0))


def plane_fit_nn(query_world: torch.Tensor, ref: torch.Tensor,
                 ref_mask: torch.Tensor, resid_thr: float = 0.1,
                 max_dist2: float = 4.0):
    """5-NN plane fit per query (reference lio_state_estimation_kdtree,
    voxelslam.cpp:1159-1191) through the neighbours' centroid. Valid only
    when all 5 neighbours are real, within sqrt(max_dist2) and within the
    relative residual gate. Takes `knn`'s shapes, with or without the
    batch axis. Returns dict(valid, normal (..., N, 3), d (..., N)) for
    the plane n.x + d = 0."""
    idx, d2 = knn(query_world, ref, ref_mask, NMATCH)
    nn_ok = torch.all(torch.isfinite(d2) & (d2 <= max_dist2), dim=-1)
    if ref.dim() == 2:
        A = ref[idx]                               # (N, 5, 3)
    else:
        bi = torch.arange(ref.shape[0], device=ref.device)[:, None, None]
        A = ref[bi, idx]                           # (B, N, 5, 3)
    c = torch.mean(A, dim=-2)
    D = A - c[..., None, :]
    M = torch.einsum("...ki,...kj->...ij", D, D)
    _, V = eigh3_forward(M)
    normal = V[..., :, 0]
    d = -torch.sum(normal * c, dim=-1)
    resid = torch.abs(torch.einsum("...ki,...i->...k", A, normal)
                      + d[..., None])
    ok = torch.all(resid <= resid_thr * torch.clamp(torch.abs(d)[..., None],
                                                    min=1e-6), dim=-1)
    valid = ok & nn_ok & torch.all(torch.isfinite(normal), dim=-1)
    normal = torch.where(valid[..., None], normal, 0.0)
    d = torch.where(valid, d, 0.0)
    return dict(valid=valid, normal=normal, d=d)
