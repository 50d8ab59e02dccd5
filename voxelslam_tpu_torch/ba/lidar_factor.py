"""The point-cluster eigenvalue LiDAR BA factor (port of
`voxelslam_tpu/ba/lidar_factor.py`; the reference LidarFactor,
voxel_map.hpp:124-339).

Per harvested plane voxel the cost is coeff * lambda_0(Cov(fix + sum_i
T_i . win_i)). Two layouts of the same factors:

- factor-major (`FactorBatch`, leaves (F, W, ...)): `cost`, `grad`
  (`torch.func.grad`), `hess_grad` (`torch.func.jacfwd` of the gradient,
  through `core.eig3.eigh3`'s perturbation derivative), `hess_grad_ct`
  (the closed form: `hess_grad_ct_t` on the transposed batch) and
  `hess_grad_analytic` (per (factor, frame) moment Jacobians by autodiff,
  eigen-perturbation assembly). No entry point runs them: they are the
  autodiff oracle the production Newton system is held to, as in the JAX
  package.
- factor-minor (`transpose_factors`, factor axis last, the layout
  `map.voxel_map.harvest_t` emits): `cost_t` and `hess_grad_ct_t`, the
  closed-form Hessian and gradient the LM loops run (the reference's
  acc_evaluate2, re-derived for centered clusters; see the JAX package for
  the derivation).

The global BA runs the factor-minor functions under torch.func.vmap over a
batch of windows (`ba.optimizers.lm_lidar`). The contractions and the
scalar sum whose batched kernels sum in another order than a single
window's, on the CPU (one thread or several) or on the H100 at the global
BA's shapes, go through `core.tensors.per_window`, so each window's result
keeps the bits it has alone; the plain `torch.einsum`s were found
batch-invariant there.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core import cluster as cl
from ..core import so3
from ..core.cluster import Cluster
from ..core.eig3 import eigh3, eigh3_forward
from ..core.tensors import per_window, window_bmm, window_einsum, window_wsum


@dataclasses.dataclass
class FactorBatch:
    """Harvested plane factors: win (F, W) local clusters per window frame,
    fix (F,) world cluster of marginalized points."""
    win: Cluster          # (F, W, ...)
    fix: Cluster          # (F, ...)
    coeff: torch.Tensor   # (F,)
    valid: torch.Tensor   # (F,) bool


def total_clusters(f: FactorBatch, Rs, ps, win_mask) -> Cluster:
    """Combined world cluster per factor (one anchored reduction over the
    window axis). Rs (W,3,3), ps (W,3), win_mask (W,)."""
    m = win_mask.to(Rs.dtype)
    n_w = f.win.n * m[None, :]                                    # (F, W)
    mu_w = torch.einsum("wij,fwj->fwi", Rs, f.win.mu) + ps[None]
    S_w = torch.einsum("wij,fwjk,wlk->fwil", Rs, f.win.S, Rs)
    n_t = f.fix.n + torch.sum(n_w, dim=1)
    inv_n = 1.0 / torch.clamp(n_t, min=1.0)
    mu_t = (f.fix.n[:, None] * f.fix.mu
            + torch.einsum("fw,fwi->fi", n_w, mu_w)) * inv_n[:, None]
    d_w = mu_w - mu_t[:, None]
    d_f = f.fix.mu - mu_t
    S_t = (f.fix.S
           + f.fix.n[:, None, None] * (d_f[:, :, None] * d_f[:, None, :])
           + torch.einsum("fwij,w->fij", S_w, m)
           + torch.einsum("fw,fwi,fwj->fij", n_w, d_w, d_w))
    empty = (n_t == 0)[:, None]
    mu_t = torch.where(empty, 0.0, mu_t)
    S_t = torch.where(empty[..., None], 0.0, S_t)
    return Cluster(n=n_t, mu=mu_t, S=S_t)


def cost(f: FactorBatch, Rs, ps, win_mask):
    """Total eigen-factor residual sum_f coeff_f * lambda0_f (reference
    evaluate_only_residual, voxel_map.hpp:285-325)."""
    total = total_clusters(f, Rs, ps, win_mask)
    lam, _ = eigh3(cl.cov(total))
    w = f.coeff * f.valid * (total.n > 0)
    return torch.sum(w * lam[:, 0])


def cost_at(f: FactorBatch, Rs0, ps0, dx, win_mask):
    """Cost at right-perturbed poses; dx (W, 6) = [rot, trans] a frame."""
    return cost(f, Rs0 @ so3.exp(dx[:, 0:3]), ps0 + dx[:, 3:6], win_mask)


def grad(f: FactorBatch, Rs0, ps0, win_mask):
    """(W, 6) gradient of the eigen cost at the current poses."""
    z = Rs0.new_zeros((Rs0.shape[0], 6))
    return torch.func.grad(lambda d: cost_at(f, Rs0, ps0, d, win_mask))(z)


def hess_grad(f: FactorBatch, Rs0, ps0, win_mask):
    """Exact (6W, 6W) Hessian and (6W,) gradient by forward-mode autodiff
    of the gradient: 6W tangents through the whole cost and eigensolve."""
    W = Rs0.shape[0]

    def g(dflat):
        return torch.func.grad(lambda d: cost_at(
            f, Rs0, ps0, d.reshape(W, 6), win_mask))(dflat)

    z = Rs0.new_zeros((W * 6,))
    H = torch.func.jacfwd(g)(z)
    return 0.5 * (H + H.T), g(z)


def hess_grad_ct(f: FactorBatch, Rs0, ps0, win_mask):
    """Exact (6W, 6W) Hessian and (6W,) gradient by the closed-form
    eigen-perturbation assembly (the JAX package's `hess_grad_ct`): the
    production `hess_grad_ct_t` on the transposed batch."""
    return hess_grad_ct_t(transpose_factors(f), Rs0, ps0, win_mask)


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
    lam, U = eigh3_forward(cov.permute(2, 0, 1))
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


def _frame_moments(Rw, pw, n, mu, S, m, d):
    """World-frame raw moments of ONE frame's cluster under a right pose
    perturbation d = [rot, trans]: (P, mn) with P = m (R' S R'^T +
    n mu' mu'^T) and mn = m n mu'. The rotation goes through `so3.exp` as
    a batch of one: under `torch.func.jacfwd` an unbatched call's 0-dim
    norm plus a Python float gets float64 tangents (torch 2.13)."""
    Rd = Rw @ so3.exp(d[None, 0:3])[0]
    mu_w = Rd @ mu + pw + d[3:6]
    P = m * (Rd @ S @ Rd.T + n * torch.outer(mu_w, mu_w))
    return P, (m * n) * mu_w


def hess_grad_analytic(f: FactorBatch, Rs0, ps0, win_mask):
    """Exact (6W, 6W) Hessian and (6W,) gradient by the second-order
    eigenvalue perturbation of C = P_t/N - mu_t mu_t^T, whose per-frame
    moment Jacobians and Hessians come from `torch.func.jacfwd` /
    `torch.func.hessian` of `_frame_moments` per (factor, frame) under
    `torch.func.vmap` (see the JAX package's `hess_grad_analytic`)."""
    W = Rs0.shape[0]
    F = f.coeff.shape[0]
    dtype = Rs0.dtype
    m = win_mask.to(dtype)

    total = total_clusters(f, Rs0, ps0, win_mask)
    N = torch.clamp(total.n, min=1.0)
    mu_t = total.mu
    lam, U = eigh3(cl.cov(total))
    u0 = U[:, :, 0]
    wgt = (f.coeff * f.valid * (total.n > 0)).to(dtype)
    z6 = Rs0.new_zeros((6,))
    vmap = torch.func.vmap

    def jac_fw(Rw, pw, mw, n, mu, S):
        jP, jmn = torch.func.jacfwd(
            lambda d: _frame_moments(Rw, pw, n, mu, S, mw, d))(z6)
        return jP.movedim(-1, 0), jmn.movedim(-1, 0)   # tangent axis first

    jac_w = vmap(jac_fw)                                 # over W
    dP, dmn = vmap(lambda n, mu, S: jac_w(Rs0, ps0, m, n, mu, S))(
        f.win.n, f.win.mu, f.win.S)             # (F, W, 6, 3, 3), (F, W, 6, 3)
    dmu_t = dmn / N[:, None, None, None]

    A = torch.einsum("fi,fwjil,flk->fwjk", u0, dP, U) / N[:, None, None, None]
    q = torch.einsum("fi,fwji->fwj", u0, dmu_t)
    ck = torch.einsum("fwji,fik->fwjk", dmu_t, U)
    bk = torch.einsum("fi,fik->fk", mu_t, U)
    u0mu = bk[:, 0]
    Q = (A - q[..., None] * bk[:, None, None, :]
         - u0mu[:, None, None, None] * ck)

    grad = torch.einsum("f,fwj->wj", wgt, Q[..., 0]).reshape(-1)

    gap = lam[:, 0:1] - lam[:, 1:3]
    inv_gap = torch.where(torch.abs(gap) > 1e-9, 1.0 / gap, 0.0)
    Qk = Q[..., 1:3].reshape(F, W * 6, 2)
    H = 2.0 * torch.einsum("fak,fbk->ab",
                           Qk * (wgt[:, None] * inv_gap)[:, None, :], Qk)
    q60 = q.reshape(F, W * 6)
    H = H - 2.0 * torch.einsum("f,fa,fb->ab", wgt, q60, q60)

    def hess_fw(u0f, Rw, pw, mw, n, mu, S):
        def scal(d):
            P, mn = _frame_moments(Rw, pw, n, mu, S, mw, d)
            return torch.stack([u0f @ P @ u0f, u0f @ mn])
        return torch.func.hessian(scal)(z6)              # (2, 6, 6)

    hess_w = vmap(hess_fw, in_dims=(None, 0, 0, 0, 0, 0, 0))
    h2 = vmap(lambda u0f, n, mu, S: hess_w(u0f, Rs0, ps0, m, n, mu, S))(
        u0, f.win.n, f.win.mu, f.win.S)                  # (F, W, 2, 6, 6)
    blk = ((h2[:, :, 0] - 2.0 * u0mu[:, None, None, None] * h2[:, :, 1])
           / N[:, None, None, None])
    H = H + torch.block_diag(*torch.einsum("f,fwij->wij", wgt, blk))
    return 0.5 * (H + H.T), grad
