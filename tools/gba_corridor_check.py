#!/usr/bin/env python3
"""The global BA of both packages on the keyframes of `chip_smoke.py`
phase `gba_window`, on the CPU: per window the rounds, the residuals r0
and r1, and the mean error of consecutive relative positions against the
generator's truth, before and after.

Run from the repository root (each a few minutes on 4 cores):

    python tools/gba_corridor_check.py --scene corridor --points 8192 --keyframes 30
    python tools/gba_corridor_check.py --scene scene --points 8192 --keyframes 30

`corridor` is bench_gba.py's generator, `scene` tests/test_gba.py's (see
`chip_smoke.corridor_keyframes` and `scene_keyframes`). Both runners run
at `SlamSystem`'s widths with `GBAConfig()`, the JAX one on one device.
Prints one JSON object.
"""

import argparse
import dataclasses
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(runner, kfs, truth, error):
    outs = [runner.add_keyframe(k) for k in kfs] + [runner.flush()]
    wins = [o for o in outs if o is not None and o.get("r0") is not None]
    return dict(r0=[w["r0"] for w in wins], r1=[w["r1"] for w in wins],
                err_out_m=error([(e.ord_a, e.ord_b, e.t)
                                 for e in runner.edges1], truth))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scene", choices=("corridor", "scene"),
                    default="corridor")
    ap.add_argument("--points", type=int, default=2048)
    ap.add_argument("--keyframes", type=int, default=15)
    args = ap.parse_args()

    import jax
    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from voxelslam_tpu.config import SlamConfig as JConfig
    from voxelslam_tpu.gba import HbaRunner as JRunner
    from voxelslam_tpu.pipeline.loop import Keyframe as JKeyframe
    from voxelslam_tpu_torch.config import SlamConfig
    from voxelslam_tpu_torch.gba import HbaRunner

    make = (cs.corridor_keyframes if args.scene == "corridor"
            else cs.scene_keyframes)
    kfs, truth = make(args.keyframes, args.points)
    err_in = cs.consecutive_error(
        [(a.scan_id, b.scan_id, a.R0.T @ (b.p0 - a.p0))
         for a, b in zip(kfs[:-1], kfs[1:])], truth)
    port = HbaRunner(SlamConfig(), device="cpu")
    res = dict(scene=args.scene, points=args.points,
               keyframes=args.keyframes, err_in_m=err_in,
               jax=_run(JRunner(JConfig()),
                        [JKeyframe(**dataclasses.asdict(k)) for k in kfs],
                        truth, cs.consecutive_error),
               port=_run(port, kfs, truth, cs.consecutive_error))
    res["port"]["rounds"] = [w["rounds"] for w in port.window_log]
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
