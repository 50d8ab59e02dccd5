"""Batched SO(3) primitives in f32 (port of `voxelslam_tpu/core/so3.py`).

Rodrigues exp, quaternion-route log, hat/vee and the right Jacobian with
its inverse (reference tools.hpp:51-133), written branch-free over
arbitrary leading batch dims: small-angle cases are `torch.where`s over
Taylor expansions, never data-dependent Python control flow.
"""

from __future__ import annotations

import torch


def hat(v: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix of v, batched: (..., 3) -> (..., 3, 3)."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack([
        torch.stack([zero, -z, y], dim=-1),
        torch.stack([z, zero, -x], dim=-1),
        torch.stack([-y, x, zero], dim=-1),
    ], dim=-2)


def vee(M: torch.Tensor) -> torch.Tensor:
    """Inverse of hat: (..., 3, 3) -> (..., 3)."""
    return torch.stack([M[..., 2, 1] - M[..., 1, 2],
                        M[..., 0, 2] - M[..., 2, 0],
                        M[..., 1, 0] - M[..., 0, 1]], dim=-1) * 0.5


def _safe_norm(v: torch.Tensor) -> torch.Tensor:
    """Norm over the last axis with a 1e-24 bias under the root (finite
    gradient at 0, as in the JAX package)."""
    return torch.sqrt(torch.sum(v * v, dim=-1) + 1e-24)


def _sinc(x: torch.Tensor) -> torch.Tensor:
    small = torch.abs(x) < 1e-4
    xs = torch.where(small, 1.0, x)
    return torch.where(small, 1.0 - x * x / 6.0, torch.sin(xs) / xs)


def _cosc(x: torch.Tensor) -> torch.Tensor:
    small = torch.abs(x) < 1e-4
    xs = torch.where(small, 1.0, x)
    return torch.where(small, 0.5 - x * x / 24.0,
                       (1.0 - torch.cos(xs)) / (xs * xs))


def _eye_like(K: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=K.dtype, device=K.device).expand(K.shape)


def exp(w: torch.Tensor) -> torch.Tensor:
    """SO(3) exponential map (Rodrigues), batched: (..., 3) -> (..., 3, 3)."""
    th = _safe_norm(w)[..., None, None]
    K = hat(w)
    K2 = K @ K
    return _eye_like(K) + _sinc(th) * K + _cosc(th) * K2


def quat_from_matrix(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> unit quaternion (w, x, y, z), batched; Shepperd's
    method, branch-free (all four candidates, pick the largest anchor)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def _cand(t, a, b, c, d):
        s = torch.sqrt(torch.clamp(t, min=1e-20)) * 2.0
        return torch.stack([a / s, b / s, c / s, d / s], dim=-1), s

    qw, sw = _cand(1.0 + tr, (1.0 + tr) * 1.0, m21 - m12, m02 - m20, m10 - m01)
    qx, sx = _cand(1.0 + m00 - m11 - m22, m21 - m12,
                   (1.0 + m00 - m11 - m22) * 1.0, m01 + m10, m02 + m20)
    qy, sy = _cand(1.0 - m00 + m11 - m22, m02 - m20, m01 + m10,
                   (1.0 - m00 + m11 - m22) * 1.0, m12 + m21)
    qz, sz = _cand(1.0 - m00 - m11 + m22, m10 - m01, m02 + m20, m12 + m21,
                   (1.0 - m00 - m11 + m22) * 1.0)
    scales = torch.stack([sw, sx, sy, sz], dim=-1)
    cands = torch.stack([qw, qx, qy, qz], dim=-2)          # (..., 4, 4)
    k = torch.argmax(scales, dim=-1)                        # first max
    idx = k[..., None, None].expand(k.shape + (1, 4))
    q = torch.gather(cands, -2, idx)[..., 0, :]
    return q / _safe_norm(q)[..., None]


def log(R: torch.Tensor) -> torch.Tensor:
    """SO(3) logarithm, batched: (..., 3, 3) -> (..., 3), quaternion route:
    w = 2 atan2(|q_v|, q_w) q_v / |q_v|."""
    q = quat_from_matrix(R)
    qw = q[..., 0]
    qv = q[..., 1:]
    sign = torch.where(qw < 0, -1.0, 1.0)
    qw = qw * sign
    qv = qv * sign[..., None]
    n = _safe_norm(qv)
    theta = 2.0 * torch.atan2(n, qw)
    small = n < 1e-6
    scale = torch.where(small, 2.0 / torch.clamp(qw, min=1e-12),
                        theta / torch.where(small, 1.0, n))
    return qv * scale[..., None]


def jr(w: torch.Tensor) -> torch.Tensor:
    """Right Jacobian of SO(3), batched: (..., 3) -> (..., 3, 3)."""
    th = _safe_norm(w)[..., None, None]
    K = hat(w)
    K2 = K @ K
    small = th < 1e-4
    ths = torch.where(small, 1.0, th)
    c1 = torch.where(small, 0.5 - th * th / 24.0,
                     (1.0 - torch.cos(ths)) / (ths * ths))
    c2 = torch.where(small, 1.0 / 6.0 - th * th / 120.0,
                     (ths - torch.sin(ths)) / (ths * ths * ths))
    return _eye_like(K) - c1 * K + c2 * K2


def jr_inv(w: torch.Tensor) -> torch.Tensor:
    """Inverse right Jacobian of SO(3), batched: (..., 3) -> (..., 3, 3)."""
    th = _safe_norm(w)[..., None, None]
    K = hat(w)
    K2 = K @ K
    small = th < 1e-4
    ths = torch.where(small, 1.0, th)
    c = torch.where(small, 1.0 / 12.0 + th * th / 720.0,
                    1.0 / (ths * ths)
                    - (1.0 + torch.cos(ths)) / (2.0 * ths * torch.sin(ths)))
    return _eye_like(K) + 0.5 * K + c * K2


def jr_inv_R(R: torch.Tensor) -> torch.Tensor:
    """Inverse right Jacobian evaluated at log(R) (reference tools.hpp:118)."""
    return jr_inv(log(R))
