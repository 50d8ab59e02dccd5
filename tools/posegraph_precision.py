#!/usr/bin/env python3
"""How precise the port's diagonal pose-graph solve is, against a float64
solve on the host: chip_smoke.py's 1,000-pose circle (odometry with a yaw
bias, 10 loop edges) through `loop/posegraph.py`'s Gauss-Newton, with the
normal equations assembled on one device and the damped linear system
solved on the same or another, in float32 or float64, with or without one
step of iterative refinement, for 5, 10 and 20 iterations.

    python3 tools/posegraph_precision.py [--poses 1000] [--device cuda]

Prints one JSON line a variant: the largest |p - p64| (m) and |R - R64|
against the host's float64 `solve_pose_graph` of 5 iterations and of the
variant's own count, and the chi2 of the last linearization; then the
seconds of each host float64 solve, and the condition number of the last
scaled system (the host's float64 eigenvalues).
"""

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from voxelslam_tpu_torch.core import so3  # noqa: E402
from voxelslam_tpu_torch.io import simulator as sim  # noqa: E402
from voxelslam_tpu_torch.loop import posegraph as pg  # noqa: E402


def circle(K):
    """chip_smoke.posegraph_part's graph, as float64 numpy."""
    th = np.linspace(0, 2 * np.pi, K)
    gt_p = np.stack([5 * np.sin(th), 5 * (1 - np.cos(th)), np.zeros(K)], -1)
    gt_R = np.stack([sim._exp(np.array([0, 0, a])) for a in th])
    bias = sim._exp(np.array([0, 0, 0.24 / K]))
    est_R, est_p = [gt_R[0]], [gt_p[0]]
    for i in range(1, K):
        est_p.append(est_p[-1] + est_R[-1] @ (gt_R[i - 1].T
                                              @ (gt_p[i] - gt_p[i - 1])))
        est_R.append(est_R[-1] @ gt_R[i - 1].T @ gt_R[i] @ bias)
    a = np.arange(10) * (K // 20)
    b = K - 1 - a
    return (np.stack(est_R), np.stack(est_p), a, b,
            np.einsum("nji,njk->nik", gt_R[a], gt_R[b]),
            np.einsum("nji,nj->ni", gt_R[a], gt_p[b] - gt_p[a]))


def graph(c, device, dt):
    est_R, est_p, a, b, lR, lp = c
    K = len(est_R)

    def dev(x, t=dt):
        return torch.as_tensor(np.asarray(x), dtype=t, device=device)
    R0, p0 = dev(est_R), dev(est_p)
    ii, jj, rR, rp, info = pg.odometry_chain_edges(
        R0, p0, dev(np.full((K, 6), 1e-4)))
    return (R0, p0, torch.cat([ii, dev(a, torch.int32)]),
            torch.cat([jj, dev(b, torch.int32)]),
            torch.cat([rR, dev(lR)]), torch.cat([rp, dev(lp)]),
            torch.cat([info, dev(np.full((10, 6), 1e6))]))


def gn(g, iters, solve_dev, solve_dt, refine, damping=1e-6):
    """`pg.solve_pose_graph` (fix_first) with the damped scaled system
    moved to solve_dev/solve_dt for its solve. Returns (R, p, chi2, Hs)."""
    R, p, ii, jj, rR, rp, info = g
    K = R.shape[0]
    W6 = torch.diag_embed(info)
    eye = torch.eye(6 * K, dtype=R.dtype, device=R.device)
    for _ in range(iters):
        r, Ji, Jj = pg._edge_blocks(R, p, ii, jj, rR, rp)
        H, gr, chi = pg.assemble_pose_system_full(ii, jj, r, Ji, Jj, W6, K)
        H = H.clone()
        H[:6, :] = 0.0
        H[:, :6] = 0.0
        H[:6, :6] = torch.eye(6, dtype=H.dtype, device=H.device)
        gr = gr.clone()
        gr[:6] = 0.0
        d = torch.sqrt(torch.clamp(torch.diagonal(H), min=1e-10))
        Hs = H / d[:, None] / d[None, :] + damping * eye
        A = Hs.to(solve_dev, solve_dt)
        rhs = (-(gr / d)).to(solve_dev, solve_dt)
        LU, piv = torch.linalg.lu_factor(A)
        x = torch.linalg.lu_solve(LU, piv, rhs[:, None])[:, 0]
        if refine:
            res = rhs - A @ x
            x = x + torch.linalg.lu_solve(LU, piv, res[:, None])[:, 0]
        dx = (x.to(R.device, R.dtype) / d).reshape(K, 6)
        R = R @ so3.exp(dx[:, 0:3])
        p = p + dx[:, 3:6]
    return R, p, float(chi), Hs


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--poses", type=int, default=1000)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    c = circle(args.poses)
    ref, ref_s = {}, {}
    for iters in (5, 10, 20):
        t0 = time.perf_counter()
        ref[iters] = pg.solve_pose_graph(*graph(c, "cpu", torch.float64),
                                         iters=iters)[:2]
        ref_s[iters] = time.perf_counter() - t0
    R64, p64 = ref[5]
    f32, f64 = torch.float32, torch.float64
    dv = args.device
    Hs = None
    for name, adev, adt, sdev, sdt, refine in (
            ("assemble and solve f32 on " + dv, dv, f32, dv, f32, False),
            ("assemble f32 on " + dv + ", solve f32 on cpu", dv, f32, "cpu",
             f32, False),
            ("assemble f32 on " + dv + ", solve f64 on " + dv, dv, f32, dv,
             f64, False),
            ("assemble and solve f32 on " + dv + ", one refinement", dv, f32,
             dv, f32, True),
            ("assemble and solve f32 on cpu", "cpu", f32, "cpu", f32, False),
            ("assemble and solve f64 on " + dv, dv, f64, dv, f64, False)):
        for iters in (5, 10, 20):
            R, p, chi, Hs_i = gn(graph(c, adev, adt), iters, sdev, sdt,
                                 refine)
            if Hs is None:
                Hs = Hs_i
            print(json.dumps(dict(
                variant=name, iters=iters, chi2=chi,
                p_vs_host_f64=float(torch.max(torch.abs(
                    p.cpu().double() - p64))),
                R_vs_host_f64=float(torch.max(torch.abs(
                    R.cpu().double() - R64))),
                p_vs_host_f64_same_iters=float(torch.max(torch.abs(
                    p.cpu().double() - ref[iters][1]))),
                R_vs_host_f64_same_iters=float(torch.max(torch.abs(
                    R.cpu().double() - ref[iters][0]))))), flush=True)
    # the library's own solve, as the port calls it
    R, p, chi = pg.solve_pose_graph(*graph(c, dv, f32))
    print(json.dumps(dict(variant="pg.solve_pose_graph f32 on " + dv,
                          iters=5, chi2=float(chi),
                          p_vs_host_f64=float(torch.max(torch.abs(
                              p.cpu().double() - p64))))), flush=True)
    print(json.dumps(dict(host_f64_seconds=ref_s)), flush=True)
    ev = torch.linalg.eigvalsh(Hs.double().cpu())
    print(json.dumps(dict(scaled_system_cond=float(ev[-1] / ev[0]),
                          eig_min=float(ev[0]), eig_max=float(ev[-1]))),
          flush=True)


if __name__ == "__main__":
    main()
