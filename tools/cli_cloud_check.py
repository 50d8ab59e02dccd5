#!/usr/bin/env python3
"""Where the scan clouds that `demo` saves differ between the port and the
JAX package's command line, on the CPU.

Both CLIs run tests/test_torch_cli.py's demo (25 scans, its overrides,
`--no-loop`). For the saved scan whose point count differs most, the
voxels of `down_size` that hold an output point in one package and not in
the other are listed, with the distance of the port's input points (the
de-skewed body-frame scan, recorded at its downsample) to that voxel: a
point that sits within the two packages' pose difference of a voxel face
can fall on either side of it. Also the distance of every input point to
its nearest voxel face, for scale.

Run from the repository root (about 2 minutes):

    python tools/cli_cloud_check.py

Prints one JSON object.
"""

import json
import os
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import jax
    jax.config.update("jax_platforms", "cpu")
    import numpy as np
    import torch
    from voxelslam_tpu import cli as jcli
    from voxelslam_tpu.io import sessions as jses
    from voxelslam_tpu_torch import cli as tcli
    from voxelslam_tpu_torch.io import sessions as tses
    from voxelslam_tpu_torch.pipeline import odometry as todo
    from test_torch_cli import DEMO_OVERRIDES, run_cli
    torch.set_num_threads(1)
    size = DEMO_OVERRIDES["odom"]["down_size"]

    inputs = []                 # the port's (points, mask, out, out_mask)
    downsample = todo.voxel_downsample

    def recording(points, mask, voxel, out_max):
        out = downsample(points, mask, voxel, out_max)
        if voxel == size and points.dim() == 2:
            inputs.append(tuple(x.detach().cpu().numpy().copy()
                                for x in (points, mask, out[0], out[1])))
        return out
    todo.voxel_downsample = recording

    with tempfile.TemporaryDirectory() as d:
        cfg = os.path.join(d, "cfg.json")
        with open(cfg, "w") as f:
            json.dump(DEMO_OVERRIDES, f)
        for tag, mod, extra in (("t", tcli, ["--device", "cpu"]),
                                ("j", jcli, [])):
            rc, _ = run_cli(mod, [
                "demo", "--scans", "25", "--preset", "default", "--config",
                cfg, "--no-loop", "--save-dir", os.path.join(d, tag + "maps"),
                "--session-name", "demo0"] + extra)
            assert rc == 0
        tb = tses.load_session(os.path.join(d, "tmaps", "demo0"))
        jb = jses.load_session(os.path.join(d, "jmaps", "demo0"))

    counts = [(len(a.cloud), len(b.cloud)) for a, b in zip(tb, jb)]
    k = int(np.argmax([abs(a - b) for a, b in counts]))
    A, B = tb[k].cloud, jb[k].cloud

    def keyset(X):
        return {tuple(int(v) for v in x)
                for x in np.floor(X / size).astype(np.int64)}

    pts, msk, out, om = next(r for r in inputs if r[3].sum() == len(A)
                             and np.allclose(np.sort(r[2][r[3] > 0], 0),
                                             np.sort(A, 0), atol=1e-6))
    live = pts[msk > 0]
    frac = live / size - np.floor(live / size)
    face = np.minimum(frac, 1 - frac).min(1) * size
    keys = np.floor(live / size).astype(np.int64)

    def voxel_report(key):
        lo = np.array(key) * size
        inside = np.all(keys == np.array(key), 1)
        gap = np.maximum(0, np.maximum(lo - live, live - (lo + size)))
        return dict(voxel=list(key), port_points_inside=int(inside.sum()),
                    port_points_to_face_m=[float(x) for x in face[inside]],
                    nearest_port_point_m=float(np.sqrt(
                        (gap ** 2).sum(1)).min()))

    KA, KB = keyset(A), keyset(B)
    print(json.dumps(dict(
        down_size=size, points_per_scan=[list(c) for c in counts],
        scans_differing=sum(a != b for a, b in counts),
        scan=k, port_points=len(A), jax_points=len(B),
        pose_diff_m=float(np.abs(tb[k].p - jb[k].p).max()),
        input_points=len(live),
        input_to_face_m=dict(median=float(np.median(face)),
                             p01=float(np.percentile(face, 1)),
                             min=float(face.min())),
        port_only=[voxel_report(x) for x in sorted(KA - KB)],
        jax_only=[voxel_report(x) for x in sorted(KB - KA)])))


if __name__ == "__main__":
    main()
