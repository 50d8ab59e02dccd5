"""Iterated-EKF LiDAR-inertial odometry update (port of
`voxelslam_tpu/odom/iekf.py`; the reference lio_state_estimation,
voxelslam.cpp:962-1098, and the init-phase kd-tree LIO, :1102-1252).

Both loops run a fixed number of trips with masked accept/freeze, so the
result equals the JAX package's early-exiting loops without a host sync
per iteration. Inverses are `inv_ex` without its error check: `inv`
reads the LU's info back to the host, a sync on the card that a CUDA
graph cannot capture."""

from __future__ import annotations

import dataclasses

import torch

from ..core import so3
from ..core.state import NavState, DIM
from ..core.eig3 import eigvalsh3
from ..core.tensors import tmap
from ..map import voxel_map as vm
from ..ops import knn as knn_ops

ROT_CONV = 0.01 / 57.3    # rad (reference voxelslam.cpp:1069)
TRA_CONV = 0.015 / 100.0  # m


def point_var_body(pts: torch.Tensor, dept_err: float, beam_err: float):
    """Per-point 3x3 covariance from range/bearing noise (calcBodyVar,
    voxelslam.hpp:180-200). pts: (N, 3) body frame."""
    r = torch.linalg.vector_norm(pts, dim=-1, keepdim=True)
    d = pts / torch.clamp(r, min=1e-6)
    eye = torch.eye(3, dtype=pts.dtype, device=pts.device)  # no host copy
    ez = eye[2].expand(d.shape)
    ex = eye[0].expand(d.shape)
    a = torch.where(torch.abs(d[:, 2:3]) < 0.9, ez, ex)
    t1 = torch.linalg.cross(d, a, dim=-1)
    t1 = t1 / torch.clamp(torch.linalg.vector_norm(t1, dim=-1, keepdim=True),
                          min=1e-9)
    t2 = torch.linalg.cross(d, t1, dim=-1)
    sig_d = dept_err ** 2
    sig_t = (beam_err * r) ** 2
    return (sig_d * d[:, :, None] * d[:, None, :]
            + sig_t[..., None] * (t1[:, :, None] * t1[:, None, :]
                                  + t2[:, :, None] * t2[:, None, :]))


def var_world(state: NavState, pts_local: torch.Tensor,
              var_body: torch.Tensor):
    """World-frame per-point covariance incl. pose uncertainty (pvec_update,
    voxelslam.hpp:242-265)."""
    rot_var = state.cov[0:3, 0:3]
    tsl_var = state.cov[3:6, 3:6]
    phat = so3.hat(pts_local)
    return (state.R @ var_body @ state.R.T
            + phat @ rot_var @ phat.transpose(-1, -2) + tsl_var)


def _kalman_step(state: NavState, x_prop: NavState, cov_inv, HTH6, HTz6):
    """One iterated-EKF linear solve (reference voxelslam.cpp:1052-1060).
    Returns (sol (15,), G6 (15, 6)); G is G6 in columns 0:6, zero else."""
    H_T_H = HTH6.new_zeros((DIM, DIM))
    H_T_H[0:6, 0:6] = HTH6
    K1 = torch.linalg.inv_ex(H_T_H + cov_inv)[0]
    G6 = K1[:, 0:6] @ HTH6
    vec = x_prop.boxminus(state)
    sol = K1[:, 0:6] @ HTz6 + vec - G6 @ vec[0:6]
    return sol, G6


def _converged(sol):
    return ((torch.linalg.vector_norm(sol[0:3]) < ROT_CONV)
            & (torch.linalg.vector_norm(sol[3:6]) < TRA_CONV))


def _select(live, new, old):
    return tmap(lambda a, b: torch.where(live, a, b), new, old)


def iekf_update(state: NavState, levels, map_cfg, pts_local, var_body, mask,
                max_iter: int = 4, degrade_eig: float = 14.0):
    """Iterated-EKF update against the voxel map; returns (state, ok,
    diag). The hash probe runs twice, at entry and at iteration
    (max_iter + 1) // 2 (the JAX package's static schedule); updates are
    masked once convergence latches `stop`."""
    x_prop = state
    cov_inv = torch.linalg.inv_ex(state.cov)[0]
    phat = so3.hat(pts_local)
    N = pts_local.shape[0]
    dev, dtype = pts_local.device, pts_local.dtype

    def locate(st):
        return vm.match_locate(levels, map_cfg, pts_local @ st.R.T + st.p,
                               mask)

    def iter_math(st, rec, found):
        vw = var_world(st, pts_local, var_body)
        wld = pts_local @ st.R.T + st.p
        m = vm.match_eval(rec, found, wld, vw, mask)
        ok = m["valid"]
        w = ok.to(dtype) / (5e-4 + m["sigma"])
        nrm = m["normal"]
        jac_r = (phat @ (nrm @ st.R)[:, :, None])[:, :, 0]     # phat R^T n
        jac = torch.cat([jac_r, nrm], dim=-1)
        HTH6 = (jac * w[:, None]).T @ jac
        HTz6 = -((w * m["dist"]) @ jac)
        okf = ok.to(dtype)
        nnt_new = (nrm * okf[:, None]).T @ nrm
        sol, G6 = _kalman_step(st, x_prop, cov_inv, HTH6, HTz6)
        return sol, G6, nnt_new, torch.sum(ok.to(torch.int32)), _converged(sol)

    relocate_at = (max_iter + 1) // 2
    st = state
    stop = torch.zeros((), dtype=torch.bool, device=dev)
    rematch = torch.zeros((), dtype=torch.int32, device=dev)
    nnt = torch.zeros((3, 3), dtype=dtype, device=dev)
    G6 = torch.zeros((DIM, 6), dtype=dtype, device=dev)
    nmatch = torch.zeros((), dtype=torch.int32, device=dev)
    iters = torch.zeros((), dtype=torch.int32, device=dev)
    for k in range(max_iter):
        if k == 0 or k == relocate_at:
            rec, found = locate(st)
        sol, G_new, nnt_new, nm_new, converged = iter_math(st, rec, found)
        live = ~stop
        st = st.boxplus(torch.where(live, sol, 0.0))
        G6 = torch.where(live, G_new, G6)
        nnt = torch.where(live, nnt_new, nnt)
        nmatch = torch.where(live, nm_new, nmatch)
        iters = iters + live.to(torch.int32)
        bump = converged | ((rematch == 0) & (k == max_iter - 2))
        rematch = rematch + (live & bump).to(torch.int32)
        stop = stop | (rematch >= 2)

    G = G6.new_zeros((DIM, DIM))
    G[:, 0:6] = G6
    cov_new = (torch.eye(DIM, dtype=dtype, device=dev) - G) @ st.cov
    st = dataclasses.replace(st, cov=cov_new)
    evals = eigvalsh3(nnt)
    ok = evals[0] >= degrade_eig
    return st, ok, dict(nnt_eig=evals, matches=nmatch, iters=iters)


def iekf_update_kdtree(state: NavState, ref_cloud, ref_mask, pts_local, mask,
                       max_iter: int = 4, prior_deweight: float = 1000.0):
    """Init-phase iEKF against a point cloud with 5-NN plane fits, refit on
    the reference's re-find schedule (first iteration + after
    convergence). max_iter fixed trips; once `stop` latches, the state
    is frozen as the JAX while_loop's exit would leave it."""
    x_prop = state
    cov_inv = torch.linalg.inv_ex(state.cov)[0] / prior_deweight
    phat = so3.hat(pts_local)
    dev = pts_local.device

    def refit(st):
        pf = knn_ops.plane_fit_nn(pts_local @ st.R.T + st.p, ref_cloud,
                                  ref_mask)
        return pf["valid"] & (mask > 0), pf["normal"], pf["d"]

    ok, nrm, dpl = refit(state)
    st = state
    rematch = torch.zeros((), dtype=torch.int32, device=dev)
    stop = torch.zeros((), dtype=torch.bool, device=dev)
    for it in range(max_iter):
        live = ~stop
        wld = pts_local @ st.R.T + st.p
        pd2 = torch.sum(nrm * wld, dim=-1) + dpl
        w = ok.to(wld.dtype)
        jac_r = (phat @ (nrm @ st.R)[:, :, None])[:, :, 0]
        jac = torch.cat([jac_r, nrm], dim=-1)
        HTH6 = (jac * w[:, None]).T @ jac
        HTz6 = -((w * pd2) @ jac)
        sol, _ = _kalman_step(st, x_prop, cov_inv, HTH6, HTz6)
        st_new = st.boxplus(sol)
        converged = _converged(sol)
        do_refit = converged | (it == max_iter - 2)
        ok2, nrm2, d2 = refit(st_new)
        ok_n = torch.where(do_refit, ok2, ok)
        nrm_n = torch.where(do_refit, nrm2, nrm)
        dpl_n = torch.where(do_refit, d2, dpl)
        rematch_n = rematch + converged.to(torch.int32)
        stop_n = (rematch_n >= 2) | (it == max_iter - 1)
        st = _select(live, st_new, st)
        ok = torch.where(live, ok_n, ok)
        nrm = torch.where(live, nrm_n, nrm)
        dpl = torch.where(live, dpl_n, dpl)
        rematch = torch.where(live, rematch_n, rematch)
        stop = torch.where(live, stop_n, stop)
    return st
