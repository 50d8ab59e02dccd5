"""Poses against the generator's ground truth (the IMU's true attitude and
position at each scan's end).

The program's world frame is its own (set at its initialisation), so the
emitted positions of a run are first brought onto the true ones by the
one rigid motion that fits them best (least squares, no scale); each
pose's error is then the distance left. A relative pose (a loop edge, a
GBA edge: frame b in frame a) needs no fit: it is held to the true one,
R_a^T (p_b - p_a).
"""

from __future__ import annotations

import numpy as np


def rigid_fit(src: np.ndarray, dst: np.ndarray):
    """(R, t) minimising sum |R src_i + t - dst_i|^2 over (N, 3) point
    sets (Kabsch: the SVD of the cross-covariance, a reflection
    excluded)."""
    src = np.asarray(src, np.float64)
    dst = np.asarray(dst, np.float64)
    ms, md = src.mean(0), dst.mean(0)
    C = (dst - md).T @ (src - ms)
    U, _, Vt = np.linalg.svd(C)
    d = np.sign(np.linalg.det(U @ Vt))
    R = U @ np.diag([1.0, 1.0, d]) @ Vt
    return R, md - R @ ms


def position_errors(p_est: np.ndarray, p_true: np.ndarray) -> np.ndarray:
    """Per pose, metres between the fitted estimate and the truth."""
    p_est = np.asarray(p_est, np.float64)
    p_true = np.asarray(p_true, np.float64)
    if len(p_est) < 3:
        return np.zeros(0)
    R, t = rigid_fit(p_est, p_true)
    return np.linalg.norm(p_est @ R.T + t - p_true, axis=1)


def relative_true(Ra, pa, Rb, pb):
    """Frame b in frame a: (R_a^T R_b, R_a^T (p_b - p_a))."""
    Ra = np.asarray(Ra, np.float64)
    return Ra.T @ np.asarray(Rb, np.float64), Ra.T @ (
        np.asarray(pb, np.float64) - np.asarray(pa, np.float64))


def edge_error(t_edge, Ra, pa, Rb, pb) -> float:
    """Metres between an edge's translation and the true relative one."""
    _, t_true = relative_true(Ra, pa, Rb, pb)
    return float(np.linalg.norm(np.asarray(t_edge, np.float64) - t_true))
