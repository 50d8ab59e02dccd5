"""Trajectory evaluation: ATE with SE(3) alignment (host-side numpy).

The reference validates by eye in RViz and external ATE tooling on
dumped alidarState.txt trajectories (SURVEY.md section 4); here ATE is a
first-class metric for tests and benchmarks.
"""

from __future__ import annotations

import numpy as np


def umeyama_se3(src: np.ndarray, dst: np.ndarray):
    """Best-fit rigid transform (R, t) minimizing ||R src + t - dst||."""
    mu_s = src.mean(0)
    mu_d = dst.mean(0)
    H = (src - mu_s).T @ (dst - mu_d)
    U, S, Vt = np.linalg.svd(H)
    d = np.sign(np.linalg.det(Vt.T @ U.T))
    D = np.diag([1.0, 1.0, d])
    R = Vt.T @ D @ U.T
    t = mu_d - R @ mu_s
    return R, t


def ate_rmse(est_p: np.ndarray, gt_p: np.ndarray, align: bool = True):
    """ATE RMSE between (N, 3) estimated and ground-truth positions."""
    est_p = np.asarray(est_p, np.float64)
    gt_p = np.asarray(gt_p, np.float64)
    if align:
        R, t = umeyama_se3(est_p, gt_p)
        est_p = est_p @ R.T + t
    err = est_p - gt_p
    return float(np.sqrt((err ** 2).sum(-1).mean()))


def rpe(est_R: np.ndarray, est_p: np.ndarray, gt_R: np.ndarray,
        gt_p: np.ndarray, delta: int = 1):
    """Relative pose error over a frame gap `delta`.

    est_R/gt_R: (N, 3, 3); est_p/gt_p: (N, 3). Returns
    (trans_rmse [m], rot_rmse [rad]) of the per-pair relative-motion
    discrepancy — the drift metric standard ATE tooling reports
    alongside ATE (the reference relies on external evaluators for
    both, SURVEY.md section 4).
    """
    est_R = np.asarray(est_R, np.float64)
    est_p = np.asarray(est_p, np.float64)
    gt_R = np.asarray(gt_R, np.float64)
    gt_p = np.asarray(gt_p, np.float64)
    n = len(est_p) - delta
    if n <= 0:
        return 0.0, 0.0
    te, re = [], []
    for i in range(n):
        # relative motions in the respective frames
        dR_e = est_R[i].T @ est_R[i + delta]
        dp_e = est_R[i].T @ (est_p[i + delta] - est_p[i])
        dR_g = gt_R[i].T @ gt_R[i + delta]
        dp_g = gt_R[i].T @ (gt_p[i + delta] - gt_p[i])
        E = dR_g.T @ dR_e
        ang = np.arccos(np.clip((np.trace(E) - 1.0) / 2.0, -1.0, 1.0))
        te.append(((dp_e - dp_g) ** 2).sum())
        re.append(ang * ang)
    return float(np.sqrt(np.mean(te))), float(np.sqrt(np.mean(re)))
