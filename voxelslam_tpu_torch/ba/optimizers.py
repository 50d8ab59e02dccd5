"""Levenberg-Marquardt for the sliding window (port of
`voxelslam_tpu/ba/optimizers.py`: `lm_lidar`, the LiDAR-only 6-DoF LM of
the global BA, and `lm_li`/`lm_li_gravity`; the reference
Lidar_BA_Optimizer and LI_BA_Optimizer[Gravity], voxel_map.hpp:342-976).

Nielsen damping (voxel_map.hpp:422-497), gauge fixed by pinning the
first frame. The JAX `while_loop` becomes `max_iter` fixed trips whose
updates are masked once the loop would have exited (iteration cap or
relative-decrease tolerance), so no trip syncs with the host."""

from __future__ import annotations

import dataclasses

import torch

from ..core import so3
from ..core.state import NavState, DIM
from ..core.tensors import tmap
from ..imu import preintegration as pre
from . import lidar_factor as lf

_REL_TOL = 1e-6
GRAVITY_NORM = 9.81


def _solve_scaled(H: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Solve H dx = -g with Jacobi scaling (f32 LU, as the JAX package).
    `solve_ex` without its error check: `linalg.solve` reads the LU's info
    back to the host, a sync per call on the card."""
    d = torch.sqrt(torch.clamp(torch.diagonal(H), min=1e-12))
    Hs = H / d[:, None] / d[None, :]
    dx = torch.linalg.solve_ex(Hs, -(g / d))[0]
    return dx / d


def _gauge_fix(H: torch.Tensor, g: torch.Tensor, dim: int):
    H = H.clone()
    g = g.clone()
    H[:dim, :] = 0.0
    H[:, :dim] = 0.0
    H[:dim, :dim] = torch.eye(dim, dtype=H.dtype, device=H.device)
    g[:dim] = 0.0
    return H, g


def _nielsen_update(u, rho):
    q = 1.0 - (2.0 * rho - 1.0) ** 3
    return u * torch.clamp(q, min=1.0 / 3.0)


def lm_lidar(Rs, ps, factors, win_mask, max_iter: int = 3, u0: float = 0.01):
    """LiDAR-only LM over (W,) poses (Rs (W,3,3), ps (W,3)); factors a
    FactorBatch or the factor-minor tuple. Dead frames (win_mask 0) are
    pinned by an identity diagonal, so their update is exactly zero.
    Returns (Rs, ps, H, r0, r1, conv)."""
    W = Rs.shape[0]
    if isinstance(factors, lf.FactorBatch):
        factors = lf.transpose_factors(factors)
    H, g = lf.hess_grad_ct_t(factors, Rs, ps, win_mask)
    r0 = lf.cost_t(factors, Rs, ps, win_mask)
    dead_diag = torch.diag(torch.repeat_interleave(1.0 - win_mask, 6))

    dev, dtype = Rs.device, Rs.dtype
    it = torch.zeros((), dtype=torch.int64, device=dev)
    u = torch.full((), u0, dtype=dtype, device=dev)      # no host copy
    v = torch.full((), 2.0, dtype=dtype, device=dev)
    r1 = r0
    conv = torch.ones((), dtype=torch.bool, device=dev)
    for _ in range(max_iter):
        live = it < max_iter
        Hf, gf = _gauge_fix(H, g, 6)
        Hf = Hf + dead_diag
        Dg = torch.diagonal(Hf)
        dx = _solve_scaled(Hf + u * torch.diag(Dg), gf)
        dxw = dx.reshape(W, 6)
        Rs_n = Rs @ so3.exp(dxw[:, 0:3])
        ps_n = ps + dxw[:, 3:6]
        q1 = 0.5 * torch.dot(dx, u * (Dg * dx) - gf)
        r2 = lf.cost_t(factors, Rs_n, ps_n, win_mask)
        q = r1 - r2
        accept = q > 0
        rho = q / torch.clamp(q1, min=1e-20)
        u_acc = _nielsen_update(u, rho)
        acc_live = live & accept
        Rs = torch.where(acc_live, Rs_n, Rs)
        ps = torch.where(acc_live, ps_n, ps)
        H_n, g_n = lf.hess_grad_ct_t(factors, Rs, ps, win_mask)
        H = torch.where(acc_live, H_n, H)
        g = torch.where(acc_live, g_n, g)
        done_tol = torch.abs(q / torch.clamp(r1, min=1e-20)) < _REL_TOL
        r1 = torch.where(acc_live, r2, r1)
        u = torch.where(live, torch.where(accept, u_acc, u * v), u)
        v = torch.where(live, torch.where(accept, 2.0, 2.0 * v), v)
        conv = torch.where(live, conv & accept, conv)
        it = torch.where(live, torch.where(done_tol, max_iter, it + 1), it)
    return Rs, ps, H, r0, r1, conv


def _block_place(blocks, mask2d, W: int):
    """Place (K, B, B) blocks at the (i, j) positions where mask2d
    (K, W, W) is 1 -> (W*B, W*B)."""
    B = blocks.shape[-1]
    return torch.einsum("kij,kab->iajb", mask2d, blocks).reshape(W * B, W * B)


def _imu_terms(states: NavState, preints: pre.Preint, imu_coef,
               with_gravity, Winv=None, pair_mask=None):
    """Stacked IMU factor contributions (H, g, chi) in the 15W [+3]
    layout; states (W,), preints (W-1,)."""
    W = states.t.shape[0]
    n = W * DIM + (3 if with_gravity else 0)
    dev, dtype = states.p.device, states.p.dtype
    st1 = states[0:W - 1]
    st2 = states[1:W]
    if Winv is None:
        Winv = pre.cov_inv(preints)
    chi, jtj, gg = pre.evaluate_closed(preints, st1, st2, with_gravity, Winv)
    if pair_mask is not None:
        chi = chi * pair_mask
        jtj = jtj * pair_mask[:, None, None]
        gg = gg * pair_mask[:, None]
    K = W - 1
    eye = torch.eye(W, dtype=dtype, device=dev)
    eye_i, eye_j = eye[:K], eye[1:]
    m_ii = eye_i[:, :, None] * eye_i[:, None, :]
    m_ij = eye_i[:, :, None] * eye_j[:, None, :]
    m_ji = eye_j[:, :, None] * eye_i[:, None, :]
    m_jj = eye_j[:, :, None] * eye_j[:, None, :]
    D = DIM
    H0 = (_block_place(jtj[:, 0:D, 0:D], m_ii, W)
          + _block_place(jtj[:, 0:D, D:2 * D], m_ij, W)
          + _block_place(jtj[:, D:2 * D, 0:D], m_ji, W)
          + _block_place(jtj[:, D:2 * D, D:2 * D], m_jj, W))
    g0 = (torch.einsum("kw,ka->wa", eye_i, gg[:, 0:D])
          + torch.einsum("kw,ka->wa", eye_j, gg[:, D:2 * D])).reshape(-1)
    if with_gravity:
        H = H0.new_zeros((n, n))
        H[:W * D, :W * D] = H0
        Hg = (torch.einsum("kw,kag->wag", eye_i, jtj[:, 0:D, 2 * D:])
              + torch.einsum("kw,kag->wag", eye_j,
                             jtj[:, D:2 * D, 2 * D:])).reshape(W * D, 3)
        H[:W * D, n - 3:] = Hg
        H[n - 3:, :W * D] = Hg.T
        H[n - 3:, n - 3:] = torch.sum(jtj[:, 2 * D:, 2 * D:], dim=0)
        g = torch.cat([g0, torch.sum(gg[:, 2 * D:], dim=0)])
    else:
        H, g = H0, g0
    return H * imu_coef, g * imu_coef, torch.sum(chi) * imu_coef * 0.5


def _apply_dx(states: NavState, dx: torch.Tensor, with_gravity: bool):
    W = states.t.shape[0]
    out = states.boxplus(dx[:W * DIM].reshape(W, DIM))
    if with_gravity:
        out = dataclasses.replace(out, g=states.g + dx[W * DIM:])
    return out


def _gravity_prior(g_vec, weight):
    """Soft prior on |g| = 9.81: the Jacobian of |g + dg| at dg = 0 is
    g / |g| (closed form of the JAX package's jacfwd)."""
    nrm = torch.linalg.vector_norm(g_vec)
    r = nrm - GRAVITY_NORM
    J = g_vec / nrm
    return weight * torch.outer(J, J), weight * J * r, weight * r * r


def _li_eval(states, factors, preints, win_mask, imu_coef, with_gravity,
             g_prior_w=0.0, Winv=None, pair_mask=None):
    """Full residual + Hessian/gradient in the 15W [+3] layout."""
    W = states.t.shape[0]
    n = W * DIM + (3 if with_gravity else 0)
    H_imu, g_imu, r_imu = _imu_terms(states, preints, imu_coef,
                                     with_gravity, Winv, pair_mask)
    Hl, gl = lf.hess_grad_ct_t(factors, states.R, states.p, win_mask)
    rl = lf.cost_t(factors, states.R, states.p, win_mask)
    Hl4 = torch.nn.functional.pad(Hl.reshape(W, 6, W, 6),
                                  (0, DIM - 6, 0, 0, 0, DIM - 6))
    gl2 = torch.nn.functional.pad(gl.reshape(W, 6), (0, DIM - 6))
    nW = W * DIM
    H = H_imu.clone()
    H[:nW, :nW] += Hl4.reshape(nW, nW)
    g = g_imu.clone()
    g[:nW] += gl2.reshape(nW)
    r = r_imu + rl
    if with_gravity and g_prior_w > 0:
        Hg, gg, rg = _gravity_prior(states.g[0], g_prior_w)
        H[n - 3:, n - 3:] += Hg
        g[n - 3:] += gg
        r = r + rg
    return H, g, r


def _li_residual(states, factors, preints, win_mask, imu_coef,
                 g_prior_w=0.0, Winv=None, pair_mask=None):
    W = states.t.shape[0]
    if Winv is None:
        Winv = pre.cov_inv(preints)
    chi = pre.chi2(preints, states[0:W - 1], states[1:W], Winv)
    if pair_mask is not None:
        chi = chi * pair_mask
    rl = lf.cost_t(factors, states.R, states.p, win_mask)
    r = torch.sum(chi) * imu_coef * 0.5 + rl
    rg = torch.linalg.vector_norm(states.g[0]) - GRAVITY_NORM
    return r + g_prior_w * rg * rg


def lm_li(states: NavState, factors, preints: pre.Preint, win_mask,
          imu_coef: float = 1e-4, max_iter: int = 3, u0: float = 0.01,
          with_gravity: bool = False, g_prior_w: float = 0.0,
          pair_mask=None):
    """LiDAR-inertial windowed LM. states (W,), preints (W-1,), factors a
    FactorBatch or the factor-minor tuple. Returns (states, H, r0, r1,
    conv)."""
    W = states.t.shape[0]
    n = W * DIM + (3 if with_gravity else 0)
    dev, dtype = states.p.device, states.p.dtype
    Winv = pre.cov_inv(preints)
    if isinstance(factors, lf.FactorBatch):
        factors = lf.transpose_factors(factors)
    H, g, r0 = _li_eval(states, factors, preints, win_mask, imu_coef,
                        with_gravity, g_prior_w, Winv, pair_mask)
    dead_diag = torch.zeros((n,), dtype=dtype, device=dev)
    if pair_mask is not None:
        dead_diag[:W * DIM] = torch.repeat_interleave(1.0 - win_mask, DIM)

    it = torch.zeros((), dtype=torch.int64, device=dev)
    u = torch.full((), u0, dtype=dtype, device=dev)      # no host copy
    v = torch.full((), 2.0, dtype=dtype, device=dev)
    r1 = r0
    conv = torch.ones((), dtype=torch.bool, device=dev)
    for _ in range(max_iter):
        live = it < max_iter
        Hf, gf = _gauge_fix(H, g, DIM)
        Hf = Hf + torch.diag(dead_diag)
        Dg = torch.diagonal(Hf)
        dx = _solve_scaled(Hf + u * torch.diag(Dg), gf)
        st_n = _apply_dx(states, dx, with_gravity)
        q1 = 0.5 * torch.dot(dx, u * (Dg * dx) - gf)
        r2 = _li_residual(st_n, factors, preints, win_mask, imu_coef,
                          g_prior_w, Winv, pair_mask)
        q = r1 - r2
        accept = q > 0
        rho = q / torch.clamp(q1, min=1e-20)
        u_acc = _nielsen_update(u, rho)
        acc_live = live & accept
        states = tmap(lambda a, b: torch.where(acc_live, a, b), st_n, states)
        H_n, g_n, _ = _li_eval(states, factors, preints, win_mask, imu_coef,
                               with_gravity, g_prior_w, Winv, pair_mask)
        H = torch.where(acc_live, H_n, H)
        g = torch.where(acc_live, g_n, g)
        done_tol = torch.abs(q / torch.clamp(r1, min=1e-20)) < _REL_TOL
        r1 = torch.where(acc_live, r2, r1)
        u = torch.where(live, torch.where(accept, u_acc, u * v), u)
        v = torch.where(live, torch.where(accept, 2.0, 2.0 * v), v)
        conv = torch.where(live, conv & accept, conv)
        it = torch.where(live, torch.where(done_tol, max_iter, it + 1), it)
    return states, H, r0, r1, conv


def lm_li_gravity(states, factors, preints, win_mask, imu_coef=1e-4,
                  max_iter: int = 3, u0: float = 0.01, g_prior_w: float = 0.0,
                  pair_mask=None):
    return lm_li(states, factors, preints, win_mask, imu_coef, max_iter, u0,
                 with_gravity=True, g_prior_w=g_prior_w, pair_mask=pair_mask)
