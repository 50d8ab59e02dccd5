"""Brute-force k-nearest-neighbour + batched 5-point plane fits (port of
`voxelslam_tpu/ops/knn.py`), used by the init-phase kd-tree LIO."""

from __future__ import annotations

import torch

from ..core.eig3 import eigh3

NMATCH = 5  # reference tools.hpp:17


def knn(query: torch.Tensor, ref: torch.Tensor, ref_mask: torch.Tensor,
        k: int, chunk: int = 2048):
    """k nearest refs per query: (idx (N,k) int64, dist2 (N,k)).

    Invalid refs get +inf distance. Distances come from one matmul per
    query chunk; the k smallest are taken by a stable sort, so ties go to
    the lower ref index as with `jax.lax.top_k`."""
    r2 = torch.sum(ref * ref, dim=-1)
    penal = torch.where(ref_mask > 0, 0.0, float("inf"))
    idxs, d2s = [], []
    for s in range(0, query.shape[0], chunk):
        qc = query[s:s + chunk]
        d2 = (torch.sum(qc * qc, dim=-1)[:, None] + r2[None, :]
              - 2.0 * (qc @ ref.T)) + penal[None, :]
        srt = torch.sort(d2, dim=-1, stable=True)
        idxs.append(srt.indices[:, :k])
        d2s.append(srt.values[:, :k])
    return torch.cat(idxs), torch.clamp(torch.cat(d2s), min=0.0)


def plane_fit_nn(query_world: torch.Tensor, ref: torch.Tensor,
                 ref_mask: torch.Tensor, resid_thr: float = 0.1,
                 max_dist2: float = 4.0):
    """5-NN plane fit per query (reference lio_state_estimation_kdtree,
    voxelslam.cpp:1159-1191) through the neighbours' centroid. Valid only
    when all 5 neighbours are real, within sqrt(max_dist2) and within the
    relative residual gate. Returns dict(valid, normal (N,3), d (N,)) for
    the plane n.x + d = 0."""
    idx, d2 = knn(query_world, ref, ref_mask, NMATCH)
    nn_ok = torch.all(torch.isfinite(d2) & (d2 <= max_dist2), dim=-1)
    A = ref[idx]                                   # (N, 5, 3)
    c = torch.mean(A, dim=1)
    D = A - c[:, None, :]
    M = torch.einsum("nki,nkj->nij", D, D)
    _, V = eigh3(M)
    normal = V[:, :, 0]
    d = -torch.sum(normal * c, dim=-1)
    resid = torch.abs(torch.einsum("nki,ni->nk", A, normal) + d[:, None])
    ok = torch.all(resid <= resid_thr * torch.clamp(torch.abs(d)[:, None],
                                                    min=1e-6), dim=-1)
    valid = ok & nn_ok & torch.all(torch.isfinite(normal), dim=-1)
    normal = torch.where(valid[:, None], normal, 0.0)
    d = torch.where(valid, d, 0.0)
    return dict(valid=valid, normal=normal, d=d)
