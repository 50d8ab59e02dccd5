"""EKF forward propagation + per-point de-skew (port of
`voxelslam_tpu/imu/ekf.py`; the reference IMUEKF, ekf_imu.hpp:8-216).

`propagate` is the log-depth form: the rotation prefix and the
covariance affine-pair composition run through `associative_scan` with
JAX's recursion, velocity/position prefixes through a deterministic
doubling prefix sum. `propagate_sequential` is the per-interval loop,
kept as the oracle."""

from __future__ import annotations

import dataclasses

import torch

from ..core import so3
from ..core.state import NavState, DIM
from ..core.tensors import (associative_scan, cumsum0, mv,
                             searchsorted_right, take_row)


@dataclasses.dataclass
class ImuPoses:
    """Per-IMU-interval poses cached for de-skew (reference imu_poses)."""
    offt: torch.Tensor  # (M,) interval-start offsets from scan begin (+inf: invalid)
    R: torch.Tensor     # (M, 3, 3)
    p: torch.Tensor     # (M, 3)
    v: torch.Tensor     # (M, 3)
    w: torch.Tensor     # (M, 3) bias-corrected body rate on the interval
    a: torch.Tensor     # (M, 3) world acceleration (gravity-compensated)


def _scalars(gyr, *xs):
    return [torch.as_tensor(x, dtype=gyr.dtype, device=gyr.device) for x in xs]


def _intervals(state, imu_ts, gyr, acc, mask, last_end, scale_gravity):
    heads_t = torch.maximum(imu_ts[:-1], last_end)
    tails_t = imu_ts[1:]
    pair_valid = (mask[:-1] > 0) & (mask[1:] > 0) & (tails_t >= last_end)
    dt = torch.where(pair_valid, tails_t - heads_t, 0.0)
    w_mid = 0.5 * (gyr[:-1] + gyr[1:]) - state.bg
    a_mid = 0.5 * (acc[:-1] + acc[1:]) * scale_gravity - state.ba
    return heads_t, pair_valid, dt, w_mid, a_mid


def _diag3(c: torch.Tensor) -> torch.Tensor:
    return torch.diag(c)


def propagate_sequential(state: NavState, imu_ts, gyr, acc, mask, scan_beg,
                         scan_end, last_end, cov_gyr, cov_acc, cov_bg, cov_ba,
                         scale_gravity: float = 1.0):
    """Forward-propagate mean + covariance through one scan's IMU batch,
    one interval at a time (IMUEKF::motion_blur, ekf_imu.hpp:41-133).
    Returns (state_at_scan_end, ImuPoses)."""
    scan_beg, scan_end, last_end = _scalars(gyr, scan_beg, scan_end, last_end)
    heads_t, pair_valid, dt, w_mid, a_mid = _intervals(
        state, imu_ts, gyr, acc, mask, last_end, scale_gravity)
    dev, dtype = gyr.device, gyr.dtype
    I3 = torch.eye(3, dtype=dtype, device=dev)
    R, p, v, cov = state.R, state.p, state.v, state.cov
    w_last = torch.zeros(3, dtype=dtype, device=dev)
    a_last = torch.zeros(3, dtype=dtype, device=dev)
    recs = []
    for k in range(dt.shape[0]):
        dt_i, w_i, a_i, valid = dt[k], w_mid[k], a_mid[k], pair_valid[k]
        a_world = R @ a_i + state.g
        recs.append((torch.where(valid, heads_t[k] - scan_beg, float("inf")),
                     R, p, v, w_i, a_world))
        F = torch.eye(DIM, dtype=dtype, device=dev)
        F[0:3, 0:3] = so3.exp(-w_i * dt_i)
        F[0:3, 9:12] = -I3 * dt_i
        F[3:6, 6:9] = I3 * dt_i
        F[6:9, 0:3] = -R @ so3.hat(a_i) * dt_i
        F[6:9, 12:15] = -R * dt_i
        Q = torch.zeros((DIM, DIM), dtype=dtype, device=dev)
        Q[0:3, 0:3] = _diag3(cov_gyr) * dt_i * dt_i
        Q[6:9, 6:9] = R @ _diag3(cov_acc) @ R.T * dt_i * dt_i
        Q[9:12, 9:12] = _diag3(cov_bg) * dt_i * dt_i
        Q[12:15, 12:15] = _diag3(cov_ba) * dt_i * dt_i
        cov_n = F @ cov @ F.T + Q
        p_n = p + v * dt_i + 0.5 * a_world * dt_i * dt_i
        v_n = v + a_world * dt_i
        R_n = R @ so3.exp(w_i * dt_i)
        R, p, v, cov = (torch.where(valid, R_n, R), torch.where(valid, p_n, p),
                        torch.where(valid, v_n, v),
                        torch.where(valid, cov_n, cov))
        w_last = torch.where(valid, w_i, w_last)
        a_last = torch.where(valid, a_world, a_last)
    poses = ImuPoses(*[torch.stack([r[i] for r in recs]) for i in range(6)])
    imu_end = torch.max(torch.where(mask > 0, imu_ts, float("-inf")))
    dte = scan_end - imu_end
    new_state = dataclasses.replace(
        state, v=v + a_last * dte, R=R @ so3.exp(w_last * dte),
        p=p + v * dte + 0.5 * a_last * dte * dte, t=scan_end, cov=cov)
    return new_state, poses


def _mm(a, b):
    return (a[0] @ b[0],)


def _affine(l, r):
    A1, B1 = l
    A2, B2 = r
    return A2 @ A1, A2 @ B1 @ A2.transpose(-1, -2) + B2


def propagate(state: NavState, imu_ts, gyr, acc, mask, scan_beg, scan_end,
              last_end, cov_gyr, cov_acc, cov_bg, cov_ba,
              scale_gravity: float = 1.0):
    """Log-depth EKF propagation (same results as `propagate_sequential`):

      R_k = R_0 E_1 ... E_k        -> associative scan of 3x3 products
      v_k, p_k                     -> prefix sums given the R prefix
      cov_k = F_k cov F_k^T + Q_k  -> associative scan over affine pairs
                                      (A2 A1, A2 B1 A2^T + B2)
    """
    scan_beg, scan_end, last_end = _scalars(gyr, scan_beg, scan_end, last_end)
    heads_t, pair_valid, dt, w_mid, a_mid = _intervals(
        state, imu_ts, gyr, acc, mask, last_end, scale_gravity)
    dev, dtype = gyr.device, gyr.dtype
    M = dt.shape[0]
    I3 = torch.eye(3, dtype=dtype, device=dev)
    pv3 = pair_valid[:, None, None]

    E = torch.where(pv3, so3.exp(w_mid * dt[:, None]), I3)
    pref = associative_scan(_mm, (E,))[0]
    R_starts = torch.cat([state.R[None], state.R @ pref[:-1]])
    R_end = state.R @ pref[-1]

    a_world = mv(R_starts, a_mid) + state.g
    dv = torch.where(pair_valid[:, None], a_world * dt[:, None], 0.0)
    v_in = state.v + cumsum0(dv)
    v_starts = torch.cat([state.v[None], v_in[:-1]])
    dp = torch.where(pair_valid[:, None],
                     v_starts * dt[:, None]
                     + 0.5 * a_world * (dt * dt)[:, None], 0.0)
    p_in = state.p + cumsum0(dp)
    p_starts = torch.cat([state.p[None], p_in[:-1]])
    v_end, p_end = v_in[-1], p_in[-1]

    dt3 = dt[:, None, None]
    F = torch.eye(DIM, dtype=dtype, device=dev).repeat(M, 1, 1)
    F[:, 0:3, 0:3] = so3.exp(-w_mid * dt[:, None])
    F[:, 0:3, 9:12] = -I3 * dt3
    F[:, 3:6, 6:9] = I3 * dt3
    F[:, 6:9, 0:3] = -(R_starts @ so3.hat(a_mid)) * dt3
    F[:, 6:9, 12:15] = -R_starts * dt3
    dt2 = dt3 * dt3
    Q = torch.zeros((M, DIM, DIM), dtype=dtype, device=dev)
    Q[:, 0:3, 0:3] = _diag3(cov_gyr) * dt2
    Q[:, 6:9, 6:9] = (R_starts @ _diag3(cov_acc)
                      @ R_starts.transpose(-1, -2)) * dt2
    Q[:, 9:12, 9:12] = _diag3(cov_bg) * dt2
    Q[:, 12:15, 12:15] = _diag3(cov_ba) * dt2
    F = torch.where(pv3, F, torch.eye(DIM, dtype=dtype, device=dev))
    Q = torch.where(pv3, Q, 0.0)

    A_all, B_all = associative_scan(_affine, (F, Q))
    cov = A_all[-1] @ state.cov @ A_all[-1].T + B_all[-1]

    t_key = torch.where(pair_valid, torch.arange(M, device=dev), -1)
    li = torch.argmax(t_key)
    any_valid = torch.any(pair_valid)
    w_last = torch.where(any_valid, take_row(w_mid, li), 0.0)
    a_last = torch.where(any_valid, take_row(a_world, li), 0.0)

    poses = ImuPoses(
        offt=torch.where(pair_valid, heads_t - scan_beg, float("inf")),
        R=R_starts, p=p_starts, v=v_starts, w=w_mid, a=a_world)

    imu_end = torch.max(torch.where(mask > 0, imu_ts, float("-inf")))
    dte = scan_end - imu_end
    new_state = dataclasses.replace(
        state, v=v_end + a_last * dte, R=R_end @ so3.exp(w_last * dte),
        p=p_end + v_end * dte + 0.5 * a_last * dte * dte, t=scan_end, cov=cov)
    return new_state, poses


def deskew(points: torch.Tensor, offsets: torch.Tensor, poses: ImuPoses,
           state_end: NavState, R_ext: torch.Tensor, t_ext: torch.Tensor):
    """Motion-compensate points (sensor frame at sample time) to the
    scan-end sensor frame (reference ekf_imu.hpp:138-163). Invalid pose
    slots carry offt = +inf."""
    M = poses.offt.shape[0]
    idx = torch.clamp(searchsorted_right(poses.offt, offsets) - 1, 0, M - 1)
    offt = poses.offt[idx]
    dt = torch.where(torch.isfinite(offt), offsets - offt, 0.0)[:, None]
    R_i = poses.R[idx] @ so3.exp(poses.w[idx] * dt)
    p_i = poses.p[idx] + poses.v[idx] * dt + 0.5 * poses.a[idx] * dt * dt
    T_ei = p_i - state_end.p
    pt_imu = points @ R_ext.T + t_ext
    pt_w = mv(R_i, pt_imu) + T_ei
    pt_end = pt_w @ state_end.R
    return (pt_end - t_ext) @ R_ext


def static_init(acc: torch.Tensor, gyr: torch.Tensor, mask: torch.Tensor,
                livox_g_normalized: bool = False):
    """Static initialization (IMUEKF::IMU_init, ekf_imu.hpp:167-209):
    gravity = -mean acc, x9.8 for g-normalized Livox IMUs. Returns
    (gravity, mean_gyr, scale_gravity, n_samples)."""
    m = mask.to(acc.dtype)
    n = torch.clamp(torch.sum(m), min=1.0)
    mean_acc = torch.sum(acc * m[:, None], dim=0) / n
    mean_gyr = torch.sum(gyr * m[:, None], dim=0) / n
    norm = torch.linalg.vector_norm(mean_acc)
    scale = torch.where(bool(livox_g_normalized) & (norm < 2.0), 9.8, 1.0)
    return -mean_acc * scale, mean_gyr, scale, torch.sum(m)
