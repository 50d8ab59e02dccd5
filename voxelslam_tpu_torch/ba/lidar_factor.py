"""The point-cluster eigenvalue LiDAR BA factor (port of the factor-minor
path of `voxelslam_tpu/ba/lidar_factor.py`; the reference LidarFactor,
voxel_map.hpp:124-339).

Per harvested plane voxel the cost is coeff * lambda_0(Cov(fix + sum_i
T_i . win_i)); `hess_grad_ct_t` assembles its exact Hessian and gradient
in closed form (the reference's acc_evaluate2, re-derived for centered
clusters — see the JAX package for the derivation). Arrays keep the
factor axis last, the layout `map.voxel_map.harvest_t` emits.

The global BA runs these functions under torch.func.vmap over a batch of
windows (`ba.optimizers.lm_lidar`). The contractions and the scalar sum
whose batched kernels sum in another order than a single window's, on the
CPU (one thread or several) or on the H100 at the global BA's shapes, go
through `core.tensors.per_window`, so each window's result keeps the bits
it has alone; the plain `torch.einsum`s were found batch-invariant there.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.cluster import Cluster
from ..core.eig3 import eigh3
from ..core.tensors import per_window, window_bmm, window_einsum, window_wsum


@dataclasses.dataclass
class FactorBatch:
    """Harvested plane factors: win (F, W) local clusters per window frame,
    fix (F,) world cluster of marginalized points."""
    win: Cluster          # (F, W, ...)
    fix: Cluster          # (F, ...)
    coeff: torch.Tensor   # (F,)
    valid: torch.Tensor   # (F,) bool


def transpose_factors(f: FactorBatch):
    """FactorBatch (F, W, ...) -> factor-minor tuple (n_l (W,F),
    mu_l (W,3,F), S_l (W,3,3,F), fix_n (F,), fix_mu (3,F), fix_S (3,3,F),
    wgt_base (F,))."""
    return (f.win.n.T, f.win.mu.permute(1, 2, 0), f.win.S.permute(1, 2, 3, 0),
            f.fix.n, f.fix.mu.T, f.fix.S.permute(1, 2, 0),
            (f.coeff * f.valid).to(f.win.mu.dtype))


def _rot_t(R, v):
    """(W,3,3) x (W,3,F) -> (W,3,F)."""
    return sum(R[:, :, j, None] * v[:, None, j] for j in range(3))


def _rot_mat_t(R, S):
    """R S R^T for (W,3,3) and (W,3,3,F) -> (W,3,3,F)."""
    e = sum(R[:, :, j, None, None] * S[:, None, j] for j in range(3))
    return sum(e[:, :, None, k, :] * R[:, None, :, k, None] for k in range(3))


# Contractions as the one bmm torch.einsum makes of each (the same
# operands, shapes and strides, so the same bits), through `window_bmm`:
# one op where the einsum dispatches a dozen views.

def _ein_af_abf(x, y):
    """einsum("af,abf->bf", x, y) ("wf,wif->if", "if,ikf->kf")."""
    return window_bmm(x.T[:, None, :], y.permute(2, 0, 1))[:, 0].T


def _ein_f_wjf(x, y):
    """einsum("f,wjf->wj", x, y)."""
    W, J, F = y.shape
    return window_bmm(x.view(1, 1, F), y.reshape(W * J, F).T[None]).reshape(
        W, J)


def _ein_wif_wif(x, y):
    """einsum("wif,wif->wf", x, y)."""
    W, _, F = x.shape
    return window_bmm(x.permute(0, 2, 1).reshape(W * F, 1, 3),
                      y.permute(0, 2, 1).reshape(W * F, 3, 1)).reshape(W, F)


def _ein_wf_wikf(x, y):
    """einsum("wf,wikf->wik", x, y)."""
    W, I, K, F = y.shape
    return window_bmm(x[:, None, :], y.reshape(W, I * K, F).transpose(
        1, 2)).reshape(W, I, K)


def _ein_wf_wf(x, y):
    """einsum("wf,wf->w", x, y)."""
    return window_bmm(x[:, None, :], y[:, :, None])[:, 0, 0]


def _total_clusters_t(ft, Rs, ps, win_mask):
    """Combined world cluster per factor: (n_t (F,), mu_t (3,F),
    S_t (3,3,F))."""
    n_l, mu_l, S_l, fix_n, fix_mu, fix_S, _ = ft
    m = win_mask
    n_w = n_l * m[:, None]
    mu_w = _rot_t(Rs, mu_l) + ps[:, :, None]
    S_w = _rot_mat_t(Rs, S_l)
    n_t = fix_n + torch.sum(n_w, dim=0)
    inv_n = 1.0 / torch.clamp(n_t, min=1.0)
    mu_t = (fix_n[None] * fix_mu
            + _ein_af_abf(n_w, mu_w)) * inv_n[None]
    d_w = mu_w - mu_t[None]
    d_f = fix_mu - mu_t
    S_t = (fix_S + fix_n[None, None] * (d_f[:, None] * d_f[None])
           + window_wsum(S_w, m)
           + torch.einsum("wf,wif,wjf->ijf", n_w, d_w, d_w))
    empty = (n_t == 0)[None]
    mu_t = torch.where(empty, 0.0, mu_t)
    S_t = torch.where(empty[None], 0.0, S_t)
    return n_t, mu_t, S_t


def _eig_t(n_t, mu_t, S_t):
    """(lam (F,3), U (3,3,F)) of the covariances S/n."""
    cov = S_t * (1.0 / torch.clamp(n_t, min=1.0))[None, None]
    lam, U = eigh3(cov.permute(2, 0, 1))
    return lam, U.permute(1, 2, 0)


def cost_t(ft, Rs, ps, win_mask):
    """Eigen-factor residual sum_f wgt_f lambda0_f."""
    n_t, mu_t, S_t = _total_clusters_t(ft, Rs, ps, win_mask)
    lam, _ = _eig_t(n_t, mu_t, S_t)
    wgt = ft[6] * (n_t > 0)
    return per_window(torch.sum, wgt * lam[:, 0])


def _cross_t(x, y, axis):
    x, y = torch.broadcast_tensors(x, y)
    return torch.linalg.cross(x, y, dim=axis)


def hess_grad_ct_t(ft, Rs0, ps0, win_mask):
    """Exact (6W, 6W) Hessian and (6W,) gradient of the eigen cost by
    closed-form eigen-perturbation assembly, factor axis last."""
    n_l, mu_l, S_l, fix_n, fix_mu, fix_S, wgt_base = ft
    W = Rs0.shape[0]
    F = n_l.shape[1]
    dtype = Rs0.dtype
    m = win_mask.to(dtype)

    n_t, mu_t, S_t = _total_clusters_t(ft, Rs0, ps0, win_mask)
    N = torch.clamp(n_t, min=1.0)
    lam, U = _eig_t(n_t, mu_t, S_t)
    u0 = U[:, 0]
    wgt = wgt_base * (n_t > 0)

    b = sum(Rs0[:, j, :, None, None] * U[j][None, None] for j in range(3))
    a = b[:, :, 0]
    Sb = sum(S_l[:, :, l, None, :] * b[:, None, l] for l in range(3))
    Sa = Sb[:, :, 0]
    mwk = (sum(mu_l[:, i, None] * b[:, i] for i in range(3))
           + sum(ps0[:, i, None, None] * U[i][None] for i in range(3)))
    u0mw = mwk[:, 0]
    u0mu = torch.einsum("if,if->f", mu_t, u0)
    bk = _ein_af_abf(mu_t, U)

    cxa = _cross_t(mu_l, a, 1)
    cxb = _cross_t(mu_l[:, :, None], b, 1)
    rotS = _cross_t(Sb, a[:, :, None], 1) + _cross_t(Sa[:, :, None], b, 1)

    nm = n_l * m[:, None]
    invN = (1.0 / N)[None]
    A_rot = (m[:, None, None, None] * rotS
             + nm[:, None, None] * (cxa[:, :, None] * mwk[:, None]
                                    + u0mw[:, None, None] * cxb)
             ) * invN[:, None, None]
    A_tr = (nm[:, None, None]
            * (u0[None, :, None] * mwk[:, None]
               + u0mw[:, None, None] * U[None])) * invN[:, None, None]
    q_rot = nm[:, None] * cxa * invN[:, None]
    q_tr = nm[:, None] * u0[None] * invN[:, None]
    ck_rot = nm[:, None, None] * cxb * invN[:, None, None]
    ck_tr = nm[:, None, None] * U[None] * invN[:, None, None]

    q = torch.cat([q_rot, q_tr], dim=1)                  # (W, 6, F)
    A6 = torch.cat([A_rot, A_tr], dim=1)                 # (W, 6, 3, F)
    ck6 = torch.cat([ck_rot, ck_tr], dim=1)
    Q = A6 - q[:, :, None] * bk[None, None] - u0mu[None, None, None] * ck6

    grad = _ein_f_wjf(wgt, Q[:, :, 0]).reshape(-1)

    gap = lam[:, 0:1] - lam[:, 1:3]
    inv_gap = torch.where(torch.abs(gap) > 1e-9, 1.0 / gap, 0.0)
    s2 = (wgt[:, None] * inv_gap).T                      # (2, F)
    Qk = Q[:, :, 1:3].reshape(W * 6, 2, F)
    A2 = (Qk * s2[None]).reshape(W * 6, 2 * F)
    B2 = Qk.reshape(W * 6, 2 * F)
    H = 2.0 * per_window(lambda x, y: x @ y.T, A2, B2)
    q60 = q.reshape(W * 6, F)
    H = H - 2.0 * per_window(lambda x, y: x @ y.T, q60 * wgt[None], q60)

    alpha = (wgt / N)[None] * m[:, None]                 # (W, F)
    aSa = _ein_wif_wif(a, Sa)
    mua = _ein_wif_wif(mu_l, a)
    hs = _cross_t(a[:, :, None], S_l, 1)
    aSaH = _cross_t(hs, a[:, None], 2)
    coef_ss = 2.0 * nm * (u0mw - u0mu[None])
    I3 = torch.eye(3, dtype=dtype, device=Rs0.device)

    def red(c, x, y):
        return torch.einsum("wf,wif,wjf->wij", alpha * c, x, y)

    one = torch.ones_like(aSa)
    blk_ww = (-2.0 * _ein_wf_wikf(alpha, aSaH)
              + red(one, Sa, a) + red(one, a, Sa)
              - 2.0 * _ein_wf_wf(alpha, aSa)[:, None, None] * I3
              + 2.0 * red(nm, cxa, cxa)
              + 0.5 * (red(coef_ss, mu_l, a) + red(coef_ss, a, mu_l))
              - _ein_wf_wf(alpha * coef_ss, mua)[:, None, None]
              * I3)
    blk_wt = 2.0 * window_einsum("wf,wif,jf->wij", alpha * nm, cxa, u0)
    blk_tt = 2.0 * window_einsum("wf,if,jf->wij", alpha * nm, u0, u0)
    blk = torch.cat([torch.cat([blk_ww, blk_wt], dim=-1),
                     torch.cat([blk_wt.transpose(-1, -2), blk_tt], dim=-1)],
                    dim=-2)                              # (W, 6, 6)
    # block_diag(*blk) by selection, which torch.func.vmap batches
    on_diag = torch.eye(W, dtype=torch.bool, device=Rs0.device)[:, None, :,
                                                                None]
    H = H + torch.where(on_diag, blk[:, :, None, :], 0.0).reshape(W * 6,
                                                                  W * 6)
    H = 0.5 * (H + H.T)
    return H, grad
