"""Fixed-capacity voxel-grid downsampling by centroid average (port of
`voxel_downsample` in `voxelslam_tpu/ops/downsample.py`; the reference's
down_sampling_voxel, tools.hpp:201-238). Output is padded to `out_max`
rows with a validity mask."""

from __future__ import annotations

import torch

from ..core.tensors import drop_add
from . import voxel_hash as vh


def voxel_downsample(points: torch.Tensor, mask: torch.Tensor,
                     voxel_size: float, out_max: int):
    """points (N, 3), mask (N,) -> (out (out_max, 3), out_mask, counts)."""
    keys = vh.voxel_key(points, voxel_size)
    _, uvalid, inv = vh.dedup_keys(keys, mask > 0, out_max)
    U = out_max
    inv = inv.to(torch.int64)
    seg = torch.where(inv >= 0, inv, U)
    w = ((mask > 0) & (inv >= 0)).to(points.dtype)
    n = drop_add(points.new_zeros((U,)), seg, w)
    s = drop_add(points.new_zeros((U, 3)), seg, points * w[:, None])
    out = s / torch.clamp(n, min=1.0)[:, None]
    return out, uvalid & (n > 0), n
