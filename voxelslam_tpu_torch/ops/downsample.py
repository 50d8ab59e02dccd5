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
    """points (N, 3), mask (N,) -> (out (out_max, 3), out_mask, counts).
    With a leading window axis (points (Nw, N, 3), mask (Nw, N)) each
    window is downsampled on its own and every output gains the axis."""
    keys = vh.voxel_key(points, voxel_size)
    _, uvalid, inv = vh.dedup_keys(keys, mask > 0, out_max)
    lead = points.shape[:-2]
    U = uvalid.numel()                      # Nw * out_max rows in all
    seg = vh.flat_index(inv, out_max)
    w = ((mask > 0) & (inv >= 0)).to(points.dtype).reshape(-1)
    n = drop_add(points.new_zeros((U,)), seg, w)
    s = drop_add(points.new_zeros((U, 3)), seg,
                 points.reshape(-1, 3) * w[:, None])
    out = s / torch.clamp(n, min=1.0)[:, None]
    n = n.reshape(lead + (out_max,))
    return out.reshape(lead + (out_max, 3)), uvalid & (n > 0), n
