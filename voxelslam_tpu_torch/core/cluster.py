"""Centered point-cluster statistics (port of
`voxelslam_tpu/core/cluster.py`).

n (count), mu (mean), S = sum (p-mu)(p-mu)^T (not divided by n): the
reference's raw PointCluster moments (tools.hpp:304-365) re-parameterised
so f32 stays exact on kilometre-scale maps. Batched over leading dims;
empty clusters (n == 0) keep mu = 0 and S = 0.
"""

from __future__ import annotations

import dataclasses

import torch

from .tensors import tmap


@dataclasses.dataclass
class Cluster:
    n: torch.Tensor    # (...,)
    mu: torch.Tensor   # (..., 3)
    S: torch.Tensor    # (..., 3, 3)

    @staticmethod
    def empty(batch_shape=(), dtype=torch.float32, device=None) -> "Cluster":
        bs = tuple(batch_shape)
        kw = dict(dtype=dtype, device=device)
        return Cluster(n=torch.zeros(bs, **kw), mu=torch.zeros(bs + (3,), **kw),
                       S=torch.zeros(bs + (3, 3), **kw))

    def __getitem__(self, idx) -> "Cluster":
        return tmap(lambda x: x[idx], self)


def _safe_div(a: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    return a / torch.clamp(n, min=1.0)


def _outer(a: torch.Tensor) -> torch.Tensor:
    return a[..., :, None] * a[..., None, :]


def from_points(points: torch.Tensor, mask: torch.Tensor | None = None) -> Cluster:
    """Cluster of a (..., N, 3) point set with optional (..., N) mask."""
    if mask is None:
        mask = torch.ones(points.shape[:-1], dtype=points.dtype,
                          device=points.device)
    mask = mask.to(points.dtype)
    n = torch.sum(mask, dim=-1)
    mu = _safe_div(torch.sum(points * mask[..., None], dim=-2), n[..., None])
    d = (points - mu[..., None, :]) * mask[..., None]
    S = torch.einsum("...ni,...nj->...ij", d, d)
    return Cluster(n=n, mu=mu, S=S)


def merge(a: Cluster, b: Cluster) -> Cluster:
    """Combine two clusters (parallel-axis theorem); reference operator+=."""
    n = a.n + b.n
    mu = _safe_div(a.n[..., None] * a.mu + b.n[..., None] * b.mu, n[..., None])
    da = a.mu - mu
    db = b.mu - mu
    S = (a.S + b.S + a.n[..., None, None] * _outer(da)
         + b.n[..., None, None] * _outer(db))
    both_empty = (n == 0)[..., None]
    mu = torch.where(both_empty, 0.0, mu)
    S = torch.where(both_empty[..., None], 0.0, S)
    return Cluster(n=n, mu=mu, S=S)


def subtract(total: Cluster, part: Cluster) -> Cluster:
    """Remove `part` from `total` (reference operator-=); part ⊆ total."""
    n = total.n - part.n
    mu = _safe_div(total.n[..., None] * total.mu - part.n[..., None] * part.mu,
                   n[..., None])
    dt = total.mu - mu
    dp = part.mu - mu
    S = (total.S - part.S + total.n[..., None, None] * _outer(dt)
         - part.n[..., None, None] * _outer(dp))
    empty = n <= 0
    return Cluster(n=torch.clamp(n, min=0.0),
                   mu=torch.where(empty[..., None], 0.0, mu),
                   S=torch.where(empty[..., None, None], 0.0, S))


def transform(c: Cluster, R: torch.Tensor, t: torch.Tensor) -> Cluster:
    """Rigid transform (reference PointCluster::transform): central
    moments rotate exactly, the mean moves."""
    mu = torch.einsum("...ij,...j->...i", R, c.mu) + t
    S = R @ c.S @ R.transpose(-1, -2)
    mu = torch.where((c.n == 0)[..., None], 0.0, mu)
    return Cluster(n=c.n, mu=mu, S=S)


def cov(c: Cluster) -> torch.Tensor:
    """Normalized covariance S/n (reference PointCluster::cov)."""
    return c.S / torch.clamp(c.n, min=1.0)[..., None, None]


def raw_moments(c: Cluster):
    """Raw (P, v, N) with P = S + n mu mu^T."""
    v = c.n[..., None] * c.mu
    P = c.S + c.n[..., None, None] * _outer(c.mu)
    return P, v, c.n
