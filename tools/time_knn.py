#!/usr/bin/env python3
"""Times the port's k-nearest-neighbour selection on one GPU, at the
shapes the main path gives it, against the two designs it replaced.

Run from the repository root:  python3 tools/time_knn.py

`ops/knn.knn` takes the 5 smallest of each row of a (2048, M) distance
block, ties to the lower column (as `jax.lax.top_k`). Three ways, each
checked to give the same indices:

  keys      - in use: one `topk` over int64 keys (monotone f32 bits in the
              high word, the column in the low word); no host round trip;
  topk_sync - `topk` of k + 1 in f32, (value, column) order by two sorts,
              and a host-read test for ties at the k-th value that sends
              the tied rows through an exact second pass;
  sort      - a stable sort of every full row, the first k.

Shapes: the init-phase kd-tree LIO (4,096 queries against the 16,384-slot
init cloud, half of it valid) and the loop-verification ICP (4 candidates
of 8,192 points against 8,192-point keyframes, the batch axis of
`loop/icp.py`). Also one whole ICP call (20 steps) at B = 4 and B = 1.

Each time is the mean over R calls between two CUDA events, with a
device synchronise only at the end (a variant that reads the host
mid-call pays for it), and the host wall clock over the same calls.
Prints one JSON object and writes it to chiprun_out/time_knn.json. Needs a
GPU; exits non-zero without one.
"""

import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

R = 10


def _ties_to_lower(d2, vals, idx, k):
    import torch
    kth = vals[:, k - 1:]
    n_lt = torch.sum(vals < kth, dim=-1, keepdim=True)
    M = d2.shape[1]
    col = torch.arange(M, dtype=torch.int32, device=d2.device)
    tie_cols = torch.topk(torch.where(d2 == kth, col, M), k, dim=-1,
                          largest=False, sorted=True).values.long()
    pos = torch.arange(k, device=d2.device)[None]
    from_ties = torch.gather(tie_cols, -1, torch.clamp(pos - n_lt, min=0))
    return torch.where(pos < n_lt, idx, from_ties)


def smallest_k_topk_sync(d2, k):
    import torch
    shape = d2.shape
    d2 = d2.reshape(-1, shape[-1])
    kk = min(k + 1, d2.shape[1])
    vals, idx = torch.topk(d2, kk, dim=-1, largest=False, sorted=True)
    tied = vals[:, kk - 1] == vals[:, k - 1] if kk > k else None
    vals, idx = vals[:, :k], idx[:, :k]
    o = torch.sort(idx, dim=-1).indices
    vals, idx = torch.gather(vals, -1, o), torch.gather(idx, -1, o)
    o = torch.sort(vals, dim=-1, stable=True).indices
    vals, idx = torch.gather(vals, -1, o), torch.gather(idx, -1, o)
    if tied is not None and bool(torch.any(tied)):
        rows = torch.nonzero(tied)[:, 0]
        idx[rows] = _ties_to_lower(d2[rows], vals[rows], idx[rows], k)
        vals = torch.gather(d2, -1, idx)
    return idx.reshape(shape[:-1] + (k,)), vals.reshape(shape[:-1] + (k,))


def smallest_k_sort(d2, k):
    import torch
    srt = torch.sort(d2, dim=-1, stable=True)
    return srt.indices[..., :k], srt.values[..., :k]


def timed(fn):
    import torch
    fn()
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0 = time.perf_counter()
    a.record()
    for _ in range(R):
        fn()
    b.record()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / R
    return dict(event_ms=a.elapsed_time(b) / R, wall_ms=1e3 * wall)


def clouds(gen, n, extent, batch=None):
    import torch
    shape = (n, 3) if batch is None else (batch, n, 3)
    pts = (torch.rand(shape, generator=gen, device="cuda") - 0.5) * extent
    pts[..., 2] = torch.round(pts[..., 2])       # layered: many near ties
    return pts


def main():
    import torch
    if not torch.cuda.is_available():
        sys.exit("time_knn: no GPU")
    from voxelslam_tpu_torch.loop.icp import icp_point_to_plane
    from voxelslam_tpu_torch.ops import knn
    gen = torch.Generator(device="cuda").manual_seed(0)
    shapes = {
        "init_lio": (clouds(gen, 4096, 20.0), clouds(gen, 16384, 20.0),
                     (torch.arange(16384, device="cuda") < 8192).float()),
        "icp_b4": (clouds(gen, 8192, 20.0, 4), clouds(gen, 8192, 20.0, 4),
                   torch.ones((4, 8192), device="cuda")),
    }
    in_use = knn._smallest_k
    variants = {"keys": in_use, "topk_sync": smallest_k_topk_sync,
                "sort": smallest_k_sort}
    out = dict(nvidia_smi=os.popen(
        "nvidia-smi --query-gpu=name,power.limit --format=csv,noheader"
    ).read().strip(), torch=torch.__version__, knn={})
    try:
        for name, (q, ref, mask) in shapes.items():
            row, ref_idx = {}, None
            for vname, fn in variants.items():
                knn._smallest_k = fn
                idx, _ = knn.knn(q, ref, mask, knn.NMATCH)
                if ref_idx is None:
                    ref_idx = idx
                row[vname] = dict(timed(lambda: knn.knn(q, ref, mask,
                                                        knn.NMATCH)),
                                  same_indices=bool(torch.equal(idx,
                                                                ref_idx)))
            out["knn"][name] = row
    finally:
        knn._smallest_k = in_use
    src, tgt, tmask = shapes["icp_b4"]
    R0 = torch.eye(3, device="cuda").expand(4, 3, 3).contiguous()
    t0 = torch.zeros((4, 3), device="cuda")
    smask = torch.ones(8192, device="cuda")
    out["icp_call"] = {
        "b4": timed(lambda: icp_point_to_plane(src[0], smask, tgt, tmask,
                                               R0, t0)),
        "b1": timed(lambda: icp_point_to_plane(src[0], smask, tgt[0],
                                               tmask[0], R0[0], t0[0])),
    }
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "time_knn.json").write_text(json.dumps(out, indent=1))
    print(json.dumps(out))
    bad = [(s, v) for s, row in out["knn"].items() for v, r in row.items()
           if not r["same_indices"]]
    if bad:
        sys.exit(f"time_knn: indices differ: {bad}")


if __name__ == "__main__":
    main()
