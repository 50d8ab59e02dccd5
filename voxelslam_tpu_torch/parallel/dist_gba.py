"""Per-window outputs of the global BA (port of `all_pairs_edges` and
`condense_window` of `voxelslam_tpu/parallel/dist_gba.py`; the reference
HBA_add_edge, voxelslam.cpp:2926-2985).

The JAX file also shards batches of windows over a device mesh
(`make_window_fleet`, and `multihost.py` for several hosts); one card has
no mesh, and that part waits for ROADMAP.md Queue A item 7.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.downsample import voxel_downsample


def all_pairs_edges(Rs, ps, H, W: int):
    """All-pairs relative-pose edges of one optimized window.

    Rs (W, 3, 3), ps (W, 3), H (6W, 6W). For every i < j (row-major pair
    order): the pose of j in frame i and the per-axis variance
    v6 = 1/|H[6i+k, 6j+k]|; a pair with any |H_ij| < 1e-6 is invalid (the
    reference skips it). Returns (rel_R (Np,3,3), rel_p (Np,3), v6 (Np,6),
    valid (Np,)), Np = W(W-1)/2."""
    ii, jj = (torch.as_tensor(a, dtype=torch.int64, device=Rs.device)
              for a in np.triu_indices(W, 1))
    Ri = Rs[ii]
    rel_R = Ri.transpose(-1, -2) @ Rs[jj]                  # R_i^T R_j
    rel_p = ((ps[jj] - ps[ii])[:, None, :] @ Ri)[:, 0]     # R_i^T (p_j - p_i)
    offs = torch.arange(6, device=Rs.device)
    hij = torch.abs(H[ii[:, None] * 6 + offs[None], jj[:, None] * 6 + offs[None]])
    valid = torch.all(hij >= 1e-6, dim=-1)
    v6 = 1.0 / torch.clamp(hij, min=1e-6)
    return rel_R, rel_p, v6, valid


def condense_window(clouds, masks, Rs, ps, vs: float, P_out: int):
    """Merge an optimized window's clouds (W, P, 3) into its first frame's
    coordinates and downsample at `vs` into `P_out` rows (the reference's
    submap merge, voxelslam.cpp:2954-2985). Returns (down, dmask f32)."""
    R0, p0 = Rs[0], ps[0]
    dR = R0.T[None] @ Rs                                   # R0^T R_n
    dp = (ps - p0[None]) @ R0                              # R0^T (p_n - p0)
    moved = clouds @ dR.transpose(-1, -2) + dp[:, None]
    down, dmask, _ = voxel_downsample(moved.reshape(-1, 3), masks.reshape(-1),
                                      vs, P_out)
    return down, dmask.to(torch.float32)
