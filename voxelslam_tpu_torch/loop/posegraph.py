"""SE(3) pose-graph Gauss-Newton (port of `voxelslam_tpu/loop/posegraph.py`;
it replaces the reference's GTSAM/ISAM2 bursts, voxelslam.cpp:2552-2561).

Edges are (i, j, rel_R, rel_p, W6) with full 6x6 information (the loop
pipelines' anchor graphs), or (i, j, rel_R, rel_p, info) with diagonal
information (`solve_pose_graph`, over `odometry_chain_edges` and loop
edges), and the residual

    r = [Log(rel_R^T R_i^T R_j), R_i^T (p_j - p_i) - rel_p]

and poses perturbed on the right, R <- R Exp(dx[0:3]), p <- p + dx[3:6].
The JAX package differentiates the residual with `jax.jacfwd` under a
`vmap`; here the same Jacobians are written in closed form over the edge
batch, and the normal equations are summed with one fixed-order
scatter-add of 6x6 blocks (`ops.segment_add`) instead of a chunked
one-hot matmul. The diagonal-information
functions are the full ones with W6 = diag(info).
"""

from __future__ import annotations

import torch

from ..core import so3
from ..ops.segment_add import segment_add


def edge_residual(Ri, pi, Rj, pj, rel_R, rel_p):
    """Residuals of a batch of edges: (..., 3, 3) and (..., 3) -> (..., 6)."""
    dR = rel_R.transpose(-1, -2) @ (Ri.transpose(-1, -2) @ Rj)
    dp = (Ri.transpose(-1, -2) @ (pj - pi)[..., None])[..., 0] - rel_p
    return torch.cat([so3.log(dR), dp], dim=-1)


def _edge_blocks(R, p, i_idx, j_idx, rel_R, rel_p):
    """Residuals r (E, 6) and Jacobians Ji, Jj (E, 6, 6) at dx = 0.

    With e = Log(E0), E0 = rel_R^T Ri^T Rj:
      dr_rot/dxi_rot = -Jr^-1(e) Rj^T Ri    dr_rot/dxj_rot = Jr^-1(e)
      dr_tr/dxi_rot  = hat(Ri^T (pj - pi)) dr_tr/dxi_tr   = -Ri^T
      dr_tr/dxj_tr   = Ri^T                 (all other blocks zero)."""
    i_idx = i_idx.long()
    j_idx = j_idx.long()
    Ri, pi, Rj, pj = R[i_idx], p[i_idx], R[j_idx], p[j_idx]
    r = edge_residual(Ri, pi, Rj, pj, rel_R, rel_p)
    RiT = Ri.transpose(-1, -2)
    Jinv = so3.jr_inv(r[:, 0:3])
    loc = (RiT @ (pj - pi)[..., None])[..., 0]
    z = torch.zeros_like(Ri)
    Ji = torch.cat([torch.cat([-Jinv @ Rj.transpose(-1, -2) @ Ri, z], dim=-1),
                    torch.cat([so3.hat(loc), -RiT], dim=-1)], dim=-2)
    Jj = torch.cat([torch.cat([Jinv, z], dim=-1),
                    torch.cat([z, RiT], dim=-1)], dim=-2)
    return r, Ji, Jj


def assemble_pose_system(i_idx, j_idx, r, Ji, Jj, w6, K: int):
    """Normal equations H = A^T W A (6K, 6K), g = A^T W r (6K,) and chi2
    for edges with per-row weights w6 (E, 6) (zero rows = dead edges)."""
    return assemble_pose_system_full(i_idx, j_idx, r, Ji, Jj,
                                     torch.diag_embed(w6), K)


def solve_pose_graph(R, p, i_idx, j_idx, rel_R, rel_p, info, edge_mask=None,
                     iters: int = 5, damping: float = 1e-6,
                     fix_first: bool = True):
    """Damped GN over all poses with diagonal information info (E, 6);
    edge_mask (E,) drops edges. Returns (R, p, chi2)."""
    w6 = info if edge_mask is None else info * edge_mask.to(info.dtype)[:, None]
    return solve_pose_graph_full(R, p, i_idx, j_idx, rel_R, rel_p,
                                 torch.diag_embed(w6), iters, damping,
                                 fix_first)


def assemble_pose_system_full(i_idx, j_idx, r, Ji, Jj, W6, K: int):
    """Normal equations H = A^T W A (6K, 6K), g = A^T W r (6K,) and chi2
    for edges with full 6x6 information W6 (E, 6, 6) (zero = dead edge).
    Each edge adds its four 6x6 blocks at (i,i), (i,j), (j,i), (j,j)."""
    i_idx = i_idx.long()
    j_idx = j_idx.long()
    WJi = W6 @ Ji
    WJj = W6 @ Jj
    JiT = Ji.transpose(-1, -2)
    JjT = Jj.transpose(-1, -2)
    blocks = torch.cat([JiT @ WJi, JiT @ WJj, JjT @ WJi, JjT @ WJj])
    idx = torch.cat([i_idx * K + i_idx, i_idx * K + j_idx,
                     j_idx * K + i_idx, j_idx * K + j_idx])
    Hb = segment_add(r.new_empty((K * K, 6, 6)), idx, blocks, zero=True)
    H = Hb.reshape(K, K, 6, 6).permute(0, 2, 1, 3).reshape(6 * K, 6 * K)
    Wr = (W6 @ r[..., None])[..., 0]
    gb = torch.cat([(JiT @ Wr[..., None])[..., 0],
                    (JjT @ Wr[..., None])[..., 0]])
    g = segment_add(r.new_empty((K, 6)), torch.cat([i_idx, j_idx]), gb,
                    zero=True)
    chi = torch.einsum("er,ers,es->", r, W6, r)
    return H, g.reshape(-1), chi


def solve_pose_graph_full(R, p, i_idx, j_idx, rel_R, rel_p, W6,
                          iters: int = 5, damping: float = 1e-6,
                          fix_first: bool = True):
    """Damped GN with full 6x6 per-edge information (the anchor-graph
    solve of the condensed backend). Dead or padded edges carry W6 = 0;
    padded poses (no live edges) stay where they are. Returns (R, p,
    chi2 of the last linearization)."""
    K = R.shape[0]
    n = 6 * K
    eye = torch.eye(n, dtype=R.dtype, device=R.device)
    chi = None
    for _ in range(iters):
        r, Ji, Jj = _edge_blocks(R, p, i_idx, j_idx, rel_R, rel_p)
        H, g, chi = assemble_pose_system_full(i_idx, j_idx, r, Ji, Jj, W6, K)
        if fix_first:
            H = H.clone()
            H[:6, :] = 0.0
            H[:, :6] = 0.0
            H[:6, :6] = torch.eye(6, dtype=H.dtype, device=H.device)
            g = g.clone()
            g[:6] = 0.0
        d = torch.sqrt(torch.clamp(torch.diagonal(H), min=1e-10))
        Hs = H / d[:, None] / d[None, :] + damping * eye
        # `linalg.solve` is `solve_ex` and a host read of the LU's info
        dx = (torch.linalg.solve_ex(Hs, -(g / d))[0] / d).reshape(K, 6)
        R = R @ so3.exp(dx[:, 0:3])
        p = p + dx[:, 3:6]
    return R, p, chi


def odometry_chain_edges(Rs, ps, v6):
    """Consecutive BetweenFactors of a trajectory (the reference's odometry
    chain in build_graph, voxelslam.cpp:2078-2154): (i_idx, j_idx, rel_R,
    rel_p, info) with info = 1/var of each successor's v6 (K, 6)."""
    K = Rs.shape[0]
    i_idx = torch.arange(K - 1, dtype=torch.int32, device=Rs.device)
    rel_R = Rs[:-1].transpose(-1, -2) @ Rs[1:]
    rel_p = (Rs[:-1].transpose(-1, -2) @ (ps[1:] - ps[:-1])[..., None])[..., 0]
    return i_idx, i_idx + 1, rel_R, rel_p, 1.0 / torch.clamp(v6[1:], min=1e-8)
