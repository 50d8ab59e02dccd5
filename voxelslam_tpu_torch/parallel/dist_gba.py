"""Per-window outputs of the global BA and the window fleet (port of
`voxelslam_tpu/parallel/dist_gba.py`; the reference HBA_add_edge,
voxelslam.cpp:2926-2985, whose windows the reference fans over CPU
threads).

`make_window_fleet` runs a batch of windows with a leading window axis
(Nw, ...): the window step, the all-pairs edges and the condensed submaps
of every window, batched. Under a `parallel.multihost.WinMesh` of size D
with a process group (one process a card, `torchrun`), each rank runs its
contiguous Nw/D windows with no collective during a window, then one
`all_gather` of the packed outputs gives every rank the whole batch in
window order: the counterpart of the JAX package's `shard_map` over axis
"win", whose every process holds the same outputs. This assumes the
ranks' keyframe streams agree, which the odometry's bitwise run-to-run
determinism gives when every rank runs the same packets.
"""

from __future__ import annotations

import torch

from ..ops.downsample import voxel_downsample


def all_pairs_edges(Rs, ps, H, W: int):
    """All-pairs relative-pose edges of one optimized window.

    Rs (W, 3, 3), ps (W, 3), H (6W, 6W). For every i < j (row-major pair
    order): the pose of j in frame i and the per-axis variance
    v6 = 1/|H[6i+k, 6j+k]|; a pair with any |H_ij| < 1e-6 is invalid (the
    reference skips it). Returns (rel_R (Np,3,3), rel_p (Np,3), v6 (Np,6),
    valid (Np,)), Np = W(W-1)/2; with a leading window axis on the inputs
    every output gains it."""
    # made on the device: a copy from the host cannot be captured
    ii, jj = torch.triu_indices(W, W, 1, device=Rs.device)
    Ri = Rs[..., ii, :, :]
    rel_R = Ri.transpose(-1, -2) @ Rs[..., jj, :, :]           # R_i^T R_j
    rel_p = ((ps[..., jj, :] - ps[..., ii, :])[..., None, :]
             @ Ri)[..., 0, :]                                  # R_i^T dp
    offs = torch.arange(6, device=Rs.device)
    hij = torch.abs(H[..., ii[:, None] * 6 + offs[None],
                      jj[:, None] * 6 + offs[None]])
    valid = torch.all(hij >= 1e-6, dim=-1)
    v6 = 1.0 / torch.clamp(hij, min=1e-6)
    return rel_R, rel_p, v6, valid


def condense_window(clouds, masks, Rs, ps, vs: float, P_out: int):
    """Merge an optimized window's clouds (W, P, 3) into its first frame's
    coordinates and downsample at `vs` into `P_out` rows (the reference's
    submap merge, voxelslam.cpp:2954-2985). Returns (down, dmask f32);
    with a leading window axis each window is condensed on its own."""
    R0, p0 = Rs[..., :1, :, :], ps[..., :1, :]
    dR = R0.transpose(-1, -2) @ Rs                         # R0^T R_n
    dp = (ps - p0) @ R0[..., 0, :, :]                      # R0^T (p_n - p0)
    moved = clouds @ dR.transpose(-1, -2) + dp[..., :, None, :]
    lead = clouds.shape[:-3]
    down, dmask, _ = voxel_downsample(moved.reshape(lead + (-1, 3)),
                                      masks.reshape(lead + (-1,)), vs, P_out)
    return down, dmask.to(torch.float32)


def make_window_fleet(mesh, window_step, W: int,
                      condense_vs: float | None = None,
                      point_max: int | None = None, run=None):
    """The batched (and, under a mesh with a process group, split) bottom-up
    GBA step.

    window_step: a batched window step, (clouds (Nw,W,P,3), masks (Nw,W,P),
    Rs (Nw,W,3,3), ps (Nw,W,3), wmask (Nw,W)) -> (Rs', ps', H, r0, r1)
    with the window axis (`gba.hba.HbaRunner._batch_step`).

    The returned callable takes those batched inputs and returns (Rs', ps',
    rel_R, rel_p, v6, evalid, r0, r1 [, downs, dmasks]), the edge arrays
    (Nw, W(W-1)/2, ...) and, when condense_vs/point_max are given, the
    condensed submap clouds (Nw, point_max, 3). With a mesh of size D, Nw
    must be a multiple of D; each rank computes its Nw/D windows and, when
    the mesh has a process group, one all_gather gives every rank all of
    them.

    run: `run(fn, clouds, masks, wmask, Rs', ps', H, r0, r1)` computes a
    rank's outputs of the window step's (default: `fn(...)`; the runner's
    step graph); the all_gather stays outside it."""
    do_condense = condense_vs is not None
    D = 1 if mesh is None else mesh.size
    rank = 0 if mesh is None else mesh.rank

    def outputs(clouds, masks, wmask, Rs2, ps2, H, r0, r1):
        outs = (Rs2, ps2) + all_pairs_edges(Rs2, ps2, H, W) + (r0, r1)
        if do_condense:
            outs = outs + condense_window(clouds, masks * wmask[..., None],
                                          Rs2, ps2, condense_vs, point_max)
        return outs

    def fleet(clouds, masks, Rs, ps, wmask):
        Nb = clouds.shape[0]
        if Nb % D:
            raise ValueError(f"a batch of {Nb} windows does not split over "
                             f"{D} ranks")
        lo, hi = rank * Nb // D, (rank + 1) * Nb // D
        clouds, masks, Rs, ps, wmask = (x[lo:hi] for x in (clouds, masks, Rs,
                                                           ps, wmask))
        step = window_step(clouds, masks, Rs, ps, wmask)
        outs = (run(outputs, clouds, masks, wmask, *step) if run is not None
                else outputs(clouds, masks, wmask, *step))
        if mesh is not None and mesh.group is not None:
            outs = _gather(mesh, outs)
        return outs

    return fleet


def _gather(mesh, outs):
    """Every rank's outputs (each with its Nw/D windows in front) -> the
    whole batch's, in window order: one all_gather of the packed f32
    outputs (the valid flags as 0/1)."""
    import torch.distributed as dist
    dev = outs[0].device
    packed = torch.cat([x.reshape(-1).to(torch.float32) for x in outs])
    packed = packed.to(mesh.device)
    parts = [torch.empty_like(packed) for _ in range(mesh.size)]
    dist.all_gather(parts, packed, group=mesh.group)
    allp = torch.stack(parts).to(dev)                  # (D, n)
    out, o = [], 0
    for x in outs:
        k = x.numel()
        y = allp[:, o:o + k].reshape((-1,) + tuple(x.shape[1:]))
        out.append(y.to(x.dtype))
        o += k
    return tuple(out)
