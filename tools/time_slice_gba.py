#!/usr/bin/env python3
"""Time one tree of the port on the card, for comparing two commits in one
call: the slice (`chip_smoke.run_slice` at bench.py's configuration, 62
scans: ms a steady scan), the GBA stream over tests/test_gba.py's scene
(`chip_smoke.run_gba`, 30 keyframes of 8,192 points: ms a window) and
`core.eig3.eigh3` at (3072, 3, 3) (µs a call, synchronised; where the tree
has it, `eigh3_forward` beside it).

It imports the port and `chip_smoke` from the current directory, so run it
from the root of each tree, parent and change alternately, in one call:

    for t in parent change change parent; do
      (cd $t && rm -rf build/torch_kernels && python3 /path/to/time_slice_gba.py $t)
    done

Prints one JSON line a tree.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.getcwd())


def main():
    import torch
    import chip_smoke as cs
    from voxelslam_tpu_torch.core import eig3
    from voxelslam_tpu_torch.ops import moments as mo
    mo.build()
    mo._library()
    out = {"tree": sys.argv[1]}
    traj, packets = cs.bench_packets(cs.N_WARM + cs.N_STEADY)
    r = cs.run_slice(cs.bench_config(), traj, packets, "cuda")
    out["slice_ms_per_scan"] = 1e3 * r["steady_s"] / r["steady_scans"]
    kfs, _ = cs.scene_keyframes(cs.GBA_KF, cs.GBA_P)
    g = cs.run_gba(kfs, total=False)
    out["gba_ms_per_window"] = 1e3 * g["stream_s"] / g["n_windows"]
    A = torch.randn(3072, 3, 3, device="cuda")
    A = A @ A.transpose(-1, -2)
    for name, fn in (("eigh3", eig3.eigh3),
                     ("plain", getattr(eig3, "eigh3_forward", None))):
        if fn is None:
            continue
        for _ in range(20):
            fn(A)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(500):
            fn(A)
        torch.cuda.synchronize()
        out[f"{name}_us_per_call"] = 1e6 * (time.perf_counter() - t0) / 500
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
