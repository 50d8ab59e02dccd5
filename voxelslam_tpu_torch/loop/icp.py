"""Point-to-plane ICP for loop verification (port of
`voxelslam_tpu/loop/icp.py`; the reference `icp_normal`,
loop_refine.hpp:47-145): Gauss-Newton over a 6-DoF relative pose, plane
fits from the 5 nearest target points, a distance gate that tightens from
`gate_coarse` to `gate_fine`, and success when min-eig(sum n n^T) >
icp_eigval and the last step is small.

The JAX package's 20-step `lax.scan` is a Python loop here. Its `vmap`
over candidates (LoopPipeline's batched verification) is a leading batch
axis: a step is one knn + plane fit over (B, N, M) and one batched 6x6
solve, for B candidates against their own targets. Nothing reads the
card from the host (the gates are host floats, the solve checks no
info), so a call can be captured as a CUDA graph (`LoopPipeline`).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import so3
from ..core.eig3 import eigvalsh3
from ..ops import knn as knn_ops


def _gate(k: int, iters: int, gate_coarse: float, gate_fine: float):
    """The JAX package's f32 gate schedule, operation for operation."""
    f = np.float32
    frac = f(k) / f(max(iters - 1, 1))
    return float(f(gate_coarse) + f(gate_fine - gate_coarse) * frac)


def _step(src, src_mask, tgt, tgt_mask, R, t, gate):
    """One Gauss-Newton step for B candidates, R (B, 3, 3), t (B, 3):
    (R2, t2, sum w n n^T (B, 3, 3), |dx| (B,))."""
    wld = src @ R.transpose(-1, -2) + t[:, None]           # (B, N, 3)
    pf = knn_ops.plane_fit_nn(wld, tgt, tgt_mask)
    nrm = pf["normal"]
    d = torch.sum(nrm * wld, dim=-1) + pf["d"]
    ok = pf["valid"] & (src_mask > 0) & (torch.abs(d) < gate)
    w = ok.to(src.dtype)
    # hat(src) R^T n per point
    jac_r = (so3.hat(src) @ (nrm @ R)[..., None])[..., 0]
    jac = torch.cat([jac_r, nrm], dim=-1)                  # (B, N, 6)
    H = torch.einsum("bn,bni,bnj->bij", w, jac, jac) + 1e-6 * torch.eye(
        6, dtype=src.dtype, device=src.device)
    g = torch.einsum("bn,bni,bn->bi", w, jac, d)
    # `linalg.solve` is `solve_ex` and a host read of the LU's info
    dx = torch.linalg.solve_ex(H, -g)[0]
    nnt = torch.einsum("bn,bni,bnj->bij", w, nrm, nrm)
    return (R @ so3.exp(dx[:, 0:3]), t + dx[:, 3:6], nnt,
            torch.sqrt(torch.sum(dx * dx, dim=-1)))


def icp_point_to_plane(src, src_mask, tgt, tgt_mask, R0, t0,
                       iters: int = 20, icp_eigval: float = 14.0,
                       gate_coarse: float = 1.0, gate_fine: float = 0.3):
    """Align src (N, 3) onto tgt (M, 3) starting from (R0, t0). With a
    leading batch axis on tgt (B, M, 3), tgt_mask (B, M), R0 (B, 3, 3)
    and t0 (B, 3) (the JAX package's vmap with in_axes
    (None, None, 0, 0, 0, 0)), the one source is aligned onto each target
    and the results carry the B axis. Returns dict(R, t, ok, eig0,
    converged) as tensors."""
    single = R0.dim() == 2
    if single:
        tgt, tgt_mask, R0, t0 = tgt[None], tgt_mask[None], R0[None], t0[None]
    R, t = R0, t0
    for k in range(iters):
        R, t, nnt, dxn = _step(src, src_mask, tgt, tgt_mask, R, t,
                               _gate(k, iters, gate_coarse, gate_fine))
    ev = eigvalsh3(nnt)
    # last-step norm; 1e-2 sits above the f32 + plane-refit jitter floor
    converged = dxn < 1e-2
    out = dict(R=R, t=t, ok=(ev[..., 0] > icp_eigval) & converged,
               eig0=ev[..., 0], converged=converged)
    return {key: v[0] for key, v in out.items()} if single else out
