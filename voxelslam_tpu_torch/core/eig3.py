"""Batched closed-form eigendecomposition of symmetric 3x3 matrices
(port of `voxelslam_tpu/core/eig3.py`).

The analytic trigonometric method (no iteration) with the JAX package's
exact eigenvector construction, degenerate-case fallbacks and final
stable argsort, so eigenvalue order and eigenvector signs match it —
`torch.linalg.eigh` would choose other signs. Eigenvalues ascend
(Eigen's SelfAdjointEigenSolver convention used by the reference).

`eigh3` is a `torch.autograd.Function` whose derivative is the JAX
package's custom JVP, the first-order perturbation formulas

    d lambda_k = u_k^T dA u_k
    d u_k      = sum_{j != k} (u_j^T dA u_k) / (lambda_k - lambda_j) u_j

with gaps under `_GAP_EPS` dropped, in both modes: `jvp` is the formula
and `backward` its adjoint, written in differentiable ops on the saved
(w, V), so `torch.func.jacfwd(torch.func.grad(f))` differentiates it
again. Autograd never sees the eigenvector construction itself, whose
derivative near repeated eigenvalues is another one.

`eigh3_forward` is the same construction without the Function: the
callers that take no derivative (the LM loops' `_eig_t`, the map's plane
refresh, knn normals, BTC) call it and build no autograd node.
"""

from __future__ import annotations

import torch

_GAP_EPS = 1e-9


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
    axes = torch.arange(3, device=u.device)   # one_hot, with no host read
    e = (idx[..., None] == axes).to(u.dtype)
    return _unit(torch.linalg.cross(u, e, dim=-1))


def _orthogonalize(v: torch.Tensor, anchor: torch.Tensor) -> torch.Tensor:
    v = v - torch.sum(v * anchor, dim=-1, keepdim=True) * anchor
    n = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    ok = n[..., 0] > 1e-8
    return torch.where(ok[..., None], v / torch.clamp(n, min=1e-30),
                       _ortho(anchor))


def eigh3_forward(A: torch.Tensor):
    """`eigh3`'s values, bit for bit, outside autograd's view: for callers
    that take no derivative (differentiating it gives the construction's
    derivative, not the perturbation formulas)."""
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


def _sym(X: torch.Tensor) -> torch.Tensor:
    return (X + X.transpose(-1, -2)) * 0.5


def _inv_gaps(w: torch.Tensor) -> torch.Tensor:
    """G[..., j, k] = 1 / (w_k - w_j) where |w_k - w_j| > _GAP_EPS, else 0
    (so 0 on the diagonal)."""
    gaps = w[..., None, :] - w[..., :, None]
    big = torch.abs(gaps) > _GAP_EPS
    return torch.where(big, 1.0 / torch.where(big, gaps, 1.0), 0.0)


class Eigh3(torch.autograd.Function):
    """(w, V) = eigh3(A) with the first-order perturbation derivative."""

    generate_vmap_rule = True

    @staticmethod
    def forward(A):
        return eigh3_forward(A)

    @staticmethod
    def setup_context(ctx, inputs, output):
        w, V = output
        ctx.save_for_backward(w, V)
        ctx.save_for_forward(w, V)

    @staticmethod
    def jvp(ctx, dA):
        w, V = ctx.saved_tensors
        S = V.transpose(-1, -2) @ _sym(dA) @ V
        return torch.diagonal(S, dim1=-2, dim2=-1), V @ (S * _inv_gaps(w))

    @staticmethod
    def backward(ctx, gw, gV):
        w, V = ctx.saved_tensors
        M = torch.diag_embed(gw) + (V.transpose(-1, -2) @ gV) * _inv_gaps(w)
        return _sym(V @ M @ V.transpose(-1, -2))


def eigh3(A: torch.Tensor):
    """Eigen-decomposition of symmetric (..., 3, 3): returns (w, V) with w
    ascending and V[..., :, k] the unit eigenvector of w[..., k]."""
    return Eigh3.apply(A)
