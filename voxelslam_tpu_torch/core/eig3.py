"""Batched closed-form eigendecomposition of symmetric 3x3 matrices
(port of `voxelslam_tpu/core/eig3.py`).

The analytic trigonometric method (no iteration) with the JAX package's
exact eigenvector construction, degenerate-case fallbacks and final
stable argsort, so eigenvalue order and eigenvector signs match it —
`torch.linalg.eigh` would choose other signs. Eigenvalues ascend
(Eigen's SelfAdjointEigenSolver convention used by the reference). The
JAX package's custom JVP has no counterpart: nothing here is
differentiated.
"""

from __future__ import annotations

import torch


def eigvalsh3(A: torch.Tensor) -> torch.Tensor:
    """Eigenvalues (ascending) of symmetric (..., 3, 3) matrices."""
    q = (A[..., 0, 0] + A[..., 1, 1] + A[..., 2, 2]) / 3.0
    eye = torch.eye(3, dtype=A.dtype, device=A.device)
    B = A - q[..., None, None] * eye
    p2 = torch.sum(B * B, dim=(-2, -1)) / 6.0
    p = torch.sqrt(torch.clamp(p2, min=0.0))
    safe_p = torch.clamp(p, min=1e-30)
    Bn = B / safe_p[..., None, None]
    detBn = (
        Bn[..., 0, 0] * (Bn[..., 1, 1] * Bn[..., 2, 2] - Bn[..., 1, 2] * Bn[..., 2, 1])
        - Bn[..., 0, 1] * (Bn[..., 1, 0] * Bn[..., 2, 2] - Bn[..., 1, 2] * Bn[..., 2, 0])
        + Bn[..., 0, 2] * (Bn[..., 1, 0] * Bn[..., 2, 1] - Bn[..., 1, 1] * Bn[..., 2, 0])
    )
    r = torch.clamp(detBn * 0.5, -1.0, 1.0)
    phi = torch.acos(r) / 3.0
    two_pi_3 = 2.0943951023931953
    w2 = q + 2.0 * p * torch.cos(phi)
    w0 = q + 2.0 * p * torch.cos(phi + two_pi_3)
    w1 = 3.0 * q - w0 - w2
    return torch.stack([w0, w1, w2], dim=-1)


def _col(M: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """M[..., :, k] for a per-batch column index k (...,)."""
    idx = k[..., None, None].expand(k.shape + (3, 1))
    return torch.gather(M, -1, idx)[..., 0]


def _unit(v: torch.Tensor) -> torch.Tensor:
    n = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    return v / torch.clamp(n, min=1e-30)


def _eigvec_for(A: torch.Tensor, lam_others: torch.Tensor) -> torch.Tensor:
    """Eigenvector of the eigenvalue not in `lam_others` (..., 2): the
    largest column of (A - l1 I)(A - l2 I) (Cayley-Hamilton)."""
    eye = torch.eye(3, dtype=A.dtype, device=A.device)
    M = ((A - lam_others[..., 0, None, None] * eye)
         @ (A - lam_others[..., 1, None, None] * eye))
    norms = torch.sum(M * M, dim=-2)
    return _unit(_col(M, torch.argmax(norms, dim=-1)))


def _ortho(u: torch.Tensor) -> torch.Tensor:
    """Unit vector orthogonal to u: cross with the least-aligned axis."""
    idx = torch.argmin(torch.abs(u), dim=-1)
    e = torch.nn.functional.one_hot(idx, 3).to(u.dtype)
    return _unit(torch.linalg.cross(u, e, dim=-1))


def _orthogonalize(v: torch.Tensor, anchor: torch.Tensor) -> torch.Tensor:
    v = v - torch.sum(v * anchor, dim=-1, keepdim=True) * anchor
    n = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    ok = n[..., 0] > 1e-8
    return torch.where(ok[..., None], v / torch.clamp(n, min=1e-30),
                       _ortho(anchor))


def eigh3(A: torch.Tensor):
    """Eigen-decomposition of symmetric (..., 3, 3): returns (w, V) with w
    ascending and V[..., :, k] the unit eigenvector of w[..., k]."""
    A = (A + A.transpose(-1, -2)) * 0.5
    w = eigvalsh3(A)
    scale = torch.clamp(torch.amax(torch.abs(w), dim=-1), min=1e-30)

    # slices, not index lists: a list index is a host-to-device copy
    v2 = _eigvec_for(A, w[..., 0:2])
    v0 = _eigvec_for(A, w[..., 1:3])

    gap_lo = (w[..., 1] - w[..., 0]) / scale
    gap_hi = (w[..., 2] - w[..., 1]) / scale
    use_v2 = gap_hi >= gap_lo

    v0_a = _orthogonalize(v0, v2)
    v2_b = _orthogonalize(v2, v0)
    v0f = torch.where(use_v2[..., None], v0_a, v0)
    v2f = torch.where(use_v2[..., None], v2, v2_b)
    v1 = _unit(torch.linalg.cross(v2f, v0f, dim=-1))

    iso = ((w[..., 2] - w[..., 0]) / scale < 1e-12)[..., None]
    eye = torch.eye(3, dtype=A.dtype, device=A.device)
    v0f = torch.where(iso, eye[0], v0f)
    v1 = torch.where(iso, eye[1], v1)
    v2f = torch.where(iso, eye[2], v2f)

    V = torch.stack([v0f, v1, v2f], dim=-1)
    # Rayleigh-quotient refinement w_k = v_k^T A v_k, then a stable sort
    # (ties keep the lower index, like jnp.argsort)
    w_r = torch.sum(V * (A @ V), dim=-2)
    order = torch.argsort(w_r, dim=-1, stable=True)
    w_r = torch.gather(w_r, -1, order)
    V = torch.gather(V, -1, order[..., None, :].expand(V.shape))
    return w_r, V
