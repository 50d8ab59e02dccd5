"""Fixed-capacity voxel-grid downsampling (port of
`voxelslam_tpu/ops/downsample.py`): the centroid average (the reference's
down_sampling_voxel, tools.hpp:201-238), the real point closest to each
centroid (down_sampling_close, tools.hpp:240-302) and the centroid with
its members' mean covariance (down_sampling_pvec, voxel_map.hpp:39-81).
Outputs are padded to `out_max` rows with a validity mask."""

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


def _segments(points, mask, voxel_size, out_max):
    """Per-voxel segments of one cloud: (uvalid (U,), seg (N,) with U for
    dropped points, w (N,) point weights, n (U,), point sums (U, 3))."""
    keys = vh.voxel_key(points, voxel_size)
    _, uvalid, inv = vh.dedup_keys(keys, mask > 0, out_max)
    inv = inv.long()
    seg = torch.where(inv >= 0, inv, out_max)
    w = ((mask > 0) & (inv >= 0)).to(points.dtype)
    n = drop_add(points.new_zeros((out_max,)), seg, w)
    s = drop_add(points.new_zeros((out_max, 3)), seg, points * w[:, None])
    return uvalid, seg, w, n, s


def _segment_min(seg, val, out_max, fill):
    """Per-segment minimum of val (N,) (segment out_max dropped); `fill`
    where a segment has no member. Exact in any order."""
    out = torch.full((out_max + 1,), fill, dtype=val.dtype, device=val.device)
    return out.scatter_reduce(0, seg, val, "amin")[:out_max]


def voxel_downsample_close(points: torch.Tensor, mask: torch.Tensor,
                           voxel_size: float, out_max: int):
    """Keep the real point closest to each voxel's centroid, the lowest
    index among equally close ones (used where interpolated centroids would
    invent points, e.g. keyframe clouds). Returns (out (out_max, 3),
    out_mask, src_idx (out_max,) int32 index into `points`, -1 if empty)."""
    N = points.shape[0]
    uvalid, seg, w, n, s = _segments(points, mask, voxel_size, out_max)
    cen = s / torch.clamp(n, min=1.0)[:, None]
    d2 = torch.sum((points - cen[torch.clamp(seg, max=out_max - 1)]) ** 2,
                   dim=-1)
    inf = 3.4e38
    dmin = _segment_min(seg, torch.where(w > 0, d2, inf), out_max, inf)
    at_min = (w > 0) & (d2 <= dmin[torch.clamp(seg, max=out_max - 1)])
    big = 2147483647
    src = _segment_min(torch.where(at_min, seg, out_max),
                       torch.where(at_min, torch.arange(N, device=seg.device),
                                   big), out_max, big)
    src = torch.where(src < big, src, -1)
    valid = uvalid & (src >= 0)
    out = torch.where(valid[:, None], points[torch.clamp(src, min=0)], 0.0)
    return out, valid, src.to(torch.int32)


def voxel_downsample_pvec(points: torch.Tensor, var: torch.Tensor,
                          mask: torch.Tensor, voxel_size: float,
                          out_max: int):
    """Centroid-average positions and the running MEAN of the members' 3x3
    covariances per voxel (the reference's incremental var = (var k +
    var_new)/(k + 1), voxel_map.hpp:61-62; not the variance of the mean).
    Returns (out (out_max, 3), var_out (out_max, 3, 3), out_mask)."""
    uvalid, seg, w, n, s = _segments(points, mask, voxel_size, out_max)
    sv = drop_add(points.new_zeros((out_max, 3, 3)), seg,
                  var * w[:, None, None])
    inv_n = 1.0 / torch.clamp(n, min=1.0)
    return s * inv_n[:, None], sv * inv_n[:, None, None], uvalid & (n > 0)
