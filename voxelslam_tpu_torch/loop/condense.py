"""Anchor condensation of odometry chains for the pose-graph backend
(a copy of `voxelslam_tpu/loop/condense.py`: host numpy only, kept
here so the port imports nothing of the JAX package).

The reference hands GTSAM/ISAM2 a graph with EVERY scan pose as a node
(odometry chains built per session in build_graph, voxelslam.cpp:
2078-2154 in the reference tree; incremental solves at :2552-2561).
ISAM2's Bayes-tree incrementality keeps that tractable at O(10^4) poses.
A dense GN over all scan poses is not (38 GB of normal equations at 12k
scans) — and is also the wrong shape for TPU: one huge ragged sparse
solve instead of a small dense one.

The TPU-native equivalent used here is exact chain elimination:
interior odometry nodes between "anchors" (loop-edge endpoints and
session ends) have exactly two between-factors attached, so
marginalizing them out of the linearized problem is a Schur complement
that reduces each chain segment to ONE composite between-factor with a
composed relative pose and an adjoint-propagated 6x6 covariance. The
anchor graph (O(#loop edges + #sessions) nodes) is then solved densely
on device, and interior poses are recovered by distributing the anchor
corrections along each segment weighted by accumulated chain
covariance — the conditional mean of a chain given its endpoints (exact
in 1D, first-order on SE(3)).

All host math here is vectorized float64 numpy: cumulative adjoints and
covariance prefix sums make every segment query O(1).

Tangent convention: xi = (theta, rho), exp(xi) = (Exp(theta), V(theta) rho),
right perturbation T_meas = T exp(xi).
"""

from __future__ import annotations

import numpy as np


# ---------------------------------------------------------------------------
# batched SE(3) numpy helpers
# ---------------------------------------------------------------------------

def hat(v):
    """(..., 3) -> (..., 3, 3) skew."""
    v = np.asarray(v)
    O = np.zeros(v.shape[:-1] + (3, 3), v.dtype)
    O[..., 0, 1], O[..., 0, 2] = -v[..., 2], v[..., 1]
    O[..., 1, 0], O[..., 1, 2] = v[..., 2], -v[..., 0]
    O[..., 2, 0], O[..., 2, 1] = -v[..., 1], v[..., 0]
    return O


def so3_exp(w):
    """(..., 3) -> (..., 3, 3) Rodrigues."""
    w = np.asarray(w, np.float64)
    th = np.linalg.norm(w, axis=-1, keepdims=True)
    th = np.maximum(th, 1e-300)
    a = w / th
    th = th[..., None]
    A = hat(a)
    I = np.broadcast_to(np.eye(3), A.shape)
    return I + np.sin(th) * A + (1.0 - np.cos(th)) * (A @ A)


def so3_log(R):
    """(3, 3) -> (3,)."""
    tr = np.clip((np.trace(R) - 1.0) * 0.5, -1.0, 1.0)
    th = np.arccos(tr)
    w = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    if th < 1e-8:
        return 0.5 * w
    return w * th / (2.0 * np.sin(th))


def _so3_V(w):
    """Left-Jacobian V(theta): exp(xi) translation factor, batched."""
    w = np.asarray(w, np.float64)
    th = np.linalg.norm(w, axis=-1, keepdims=True)
    th = np.maximum(th, 1e-300)
    a = w / th
    th = th[..., None]
    A = hat(a)
    I = np.broadcast_to(np.eye(3), A.shape)
    s = np.where(th < 1e-8, 1.0 - th * th / 6.0, np.sin(th) / th)
    c = np.where(th < 1e-8, 0.5 * th - th ** 3 / 24.0,
                 (1.0 - np.cos(th)) / th)
    return I + c * A + (1.0 - s) * (A @ A)


def se3_exp(xi):
    """(..., 6) -> (R (...,3,3), p (...,3))."""
    xi = np.asarray(xi, np.float64)
    w, r = xi[..., 0:3], xi[..., 3:6]
    R = so3_exp(w)
    p = np.einsum("...ij,...j->...i", _so3_V(w), r)
    return R, p


def se3_log(R, p):
    """(3,3),(3,) -> (6,)."""
    w = so3_log(np.asarray(R, np.float64))
    V = _so3_V(w[None])[0]
    r = np.linalg.solve(V, np.asarray(p, np.float64))
    return np.concatenate([w, r])


def adjoint(R, p):
    """Batched Ad(T): maps right-tangent to left-tangent,
    Ad = [[R, 0], [hat(p) R, R]] for xi = (theta, rho)."""
    R = np.asarray(R, np.float64)
    p = np.asarray(p, np.float64)
    A = np.zeros(R.shape[:-2] + (6, 6))
    A[..., 0:3, 0:3] = R
    A[..., 3:6, 3:6] = R
    A[..., 3:6, 0:3] = hat(p) @ R
    return A


# ---------------------------------------------------------------------------
# chain condensation
# ---------------------------------------------------------------------------

class CondensedChain:
    """Prefix structure over one session's scan-pose chain.

    Rs (n,3,3), ps (n,3): current absolute poses (the chain's relative
    measurements are derived from these, exactly as the dense builder
    did). v6 (n,6): per-scan diagonal covariance from the local-BA
    Hessian; v6[k] covers the edge (k-1 -> k), matching the dense
    builder's `info.append(1/b.v6)`.

    G[k] = sum_{j<=k} Ad(T_j) diag(v6_j) Ad(T_j)^T  (G[0] = 0), so the
    composite covariance of segment (a, b] in the right-tangent at b is

        Sigma_ab = Ad(T_b)^-1 (G_b - G_a) Ad(T_b)^-T.

    cw[k] = sum_{j<=k} tr(diag(v6_j)) gives frame-independent
    interpolation weights along a segment.
    """

    def __init__(self, Rs: np.ndarray, ps: np.ndarray, v6: np.ndarray):
        self.R = np.asarray(Rs, np.float64)
        self.p = np.asarray(ps, np.float64)
        n = self.R.shape[0]
        v6 = np.asarray(v6, np.float64)
        Ad = adjoint(self.R, self.p)                      # (n, 6, 6)
        contrib = np.einsum("nij,nj,nkj->nik", Ad, v6, Ad)
        contrib[0] = 0.0
        self.G = np.cumsum(contrib, axis=0)               # (n, 6, 6)
        w = v6.sum(axis=1)
        w[0] = 0.0
        self.cw = np.cumsum(w)                            # (n,)
        self.n = n

    def segment_edge(self, a: int, b: int):
        """Composite between-factor for segment a -> b (a < b).
        Returns (rel_R, rel_p, cov6) with cov6 the full 6x6 covariance
        of the right-tangent measurement noise at b."""
        rel_R = self.R[a].T @ self.R[b]
        rel_p = self.R[a].T @ (self.p[b] - self.p[a])
        Ad_b = adjoint(self.R[b][None], self.p[b][None])[0]
        Ainv = np.linalg.inv(Ad_b)
        cov = Ainv @ (self.G[b] - self.G[a]) @ Ainv.T
        # keep symmetric + regularized (segment of length >= 1 always
        # carries at least one v6, but guard anyway)
        cov = 0.5 * (cov + cov.T) + 1e-12 * np.eye(6)
        return rel_R, rel_p, cov

    def interp_fraction(self, a: int, b: int) -> np.ndarray:
        """(b-a-1,) covariance-weighted fractions for interior nodes
        a+1..b-1 (exact conditional-mean weights for a 1D chain)."""
        tot = self.cw[b] - self.cw[a]
        if tot <= 0:
            return np.linspace(0, 1, b - a + 1)[1:-1]
        return (self.cw[a + 1:b] - self.cw[a]) / tot


def residual_info(rel_R: np.ndarray, cov6: np.ndarray) -> np.ndarray:
    """Map a right-tangent measurement covariance into the solver's
    residual space and invert.

    Residual r = [Log(rel_R^T Ri^T Rj), Ri^T (pj - pi) - rel_p]
    (posegraph.edge_residual): a measurement perturbation
    T_meas = T exp(xi) gives d r_rot = -theta and
    d r_trans = -rel_R rho, so cov_r = B cov6 B^T with
    B = diag(-I, -rel_R)."""
    B = np.zeros((6, 6))
    B[0:3, 0:3] = -np.eye(3)
    B[3:6, 3:6] = -np.asarray(rel_R, np.float64)
    cov_r = B @ cov6 @ B.T
    return np.linalg.inv(0.5 * (cov_r + cov_r.T) + 1e-12 * np.eye(6))


def apply_segment_correction(chain: CondensedChain, a: int, b: int,
                             La_R, La_p, Lb_R, Lb_p):
    """World-frame left corrections L = T_new T_old^-1 at anchors a and
    b, geodesically interpolated over the interior nodes by accumulated
    chain covariance. Returns (R_new, p_new) for nodes a+1..b-1
    (empty arrays when the segment has no interior)."""
    if b - a <= 1:
        return (np.zeros((0, 3, 3)), np.zeros((0, 3)))
    # L_i = exp(s_i * log(L_b L_a^-1)) L_a
    dR = np.asarray(Lb_R) @ np.asarray(La_R).T
    dp = np.asarray(Lb_p) - dR @ np.asarray(La_p)
    xi = se3_log(dR, dp)
    s = chain.interp_fraction(a, b)                       # (m,)
    Ri, pi = se3_exp(s[:, None] * xi)                     # (m,3,3),(m,3)
    L_R = Ri @ La_R
    L_p = np.einsum("nij,j->ni", Ri, La_p) + pi
    R_old = chain.R[a + 1:b]
    p_old = chain.p[a + 1:b]
    R_new = L_R @ R_old
    p_new = np.einsum("nij,nj->ni", L_R, p_old) + L_p
    return R_new, p_new
