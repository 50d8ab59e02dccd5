"""The JAX package on the CPU over the elevator scenario of
tests/test_elevator.py at bench.py's widths (the configuration
`chip_smoke.py` phase `system` runs the port at). Prints one JSON line:
resets, failed inits, the last session, loop edges, correction scans and
the position error at each.

    python tools/jax_elevator_check.py                    # ~8 min on a CPU
    python tools/jax_elevator_check.py --trace jax.json   # also the trace
                                # of tools/elevator_trace.py, for
                                # tools/torch_elevator_check.py --against
    python tools/jax_elevator_check.py --stop 267 --save-at 256 s.npz
        # also saves what a reset carries into the next session (gravity,
        # gyro bias, gravity scale, session) after scan 256, for
        # tools/torch_elevator_check.py --resume; --resume s.npz here
        # restarts the JAX package from it (--perturb as in that tool)
    python tools/jax_elevator_check.py --replay match_*.npz
        # for each match that tools/torch_elevator_check.py --dump wrote:
        # the JAX package's votes, RANSAC overlap, ICP verdict and min
        # eigenvalue on the port's keyframe clouds and descriptors
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from voxelslam_tpu import config as cm  # noqa: E402
from voxelslam_tpu.io import simulator as sim  # noqa: E402
from voxelslam_tpu.loop import btc  # noqa: E402
from voxelslam_tpu.loop.icp import icp_point_to_plane  # noqa: E402
from voxelslam_tpu.pipeline import loop as jloop  # noqa: E402
from voxelslam_tpu.pipeline.system import SlamSystem  # noqa: E402
import elevator_trace as et  # noqa: E402


def run(trace_path, stop, resume=None, perturb=0.0, save_at=None,
        save_path=None):
    cfg = et.system_config(cm)
    packets, gt = et.elevator_packets(sim, stop)
    sysm = SlamSystem(cfg, enable_loop=True, enable_gba=False)
    tr = et.Tracer(np.asarray)
    tr.install(jloop.LoopPipeline, btc.DescriptorDB,
               [(sysm.loop, "_jit_icp"), (sysm.loop, "_jit_icp_b")])
    start = 0
    if resume:
        start = tr.k = et.resume(sysm, resume, jnp.asarray, perturb)
    t0 = time.time()
    for k in range(start, len(packets)):
        out = sysm.process_scan(*packets[k])
        tr.scan(sysm, out, gt[k])
        if k == save_at:
            od = sysm.odom
            assert od.win_count == 0 and not od.init_done, "not at a reset"
            np.savez(save_path, k=k, session=od.session,
                     gravity=np.asarray(od._gravity), bg0=np.asarray(od._bg0),
                     scale_gravity=od._scale_gravity)
    res = tr.result(sysm)
    tr.uninstall()
    if trace_path:
        et.save(trace_path, res)
    print(json.dumps(dict(et.summary(res), secs=time.time() - t0,
                          corrections=sysm.corrections,
                          n_kf=[len(k) for k in sysm.loop.keyframes])))


def replay(paths):
    """The JAX package's verdict on a match the port accepted."""
    cfg = et.system_config(cm)
    bcfg = btc.BtcConfig.profile(cfg.loop.is_high_fly)
    for path in paths:
        z = np.load(path)
        q = {k[2:]: z[k] for k in z.files if k.startswith("q_")}
        c = {k[2:]: z[k] for k in z.files if k.startswith("c_")}
        frame = int(z["frame"])
        db = btc.DescriptorDB(bcfg)
        db.add(frame, c)
        hits = db.search(q, skip_near=-1)
        hit = next((h for h in hits if h[0] == frame), None)
        ver = None if hit is None else db.verify(q, frame, hit[2])
        # JAX's own extraction of the port's current keyframe cloud
        dj = {k: np.asarray(v) for k, v in jax.jit(
            btc.extract, static_argnums=(2,))(
            jnp.asarray(z["src"]), jnp.asarray(z["src_mask"]),
            bcfg).items()}
        icp = jax.jit(lambda R0, t0: icp_point_to_plane(
            jnp.asarray(z["src"]), jnp.asarray(z["src_mask"]),
            jnp.asarray(z["tgt"]), jnp.asarray(z["tgt_mask"]), R0, t0,
            icp_eigval=cfg.loop.icp_eigval))

        def verdict(R0, t0):
            o = icp(jnp.asarray(R0, jnp.float32), jnp.asarray(t0, jnp.float32))
            return dict(ok=bool(o["ok"]), eig0=float(o["eig0"]),
                        converged=bool(o["converged"]),
                        t=np.asarray(o["t"], np.float64).tolist())
        print(json.dumps(dict(
            match=os.path.basename(path),
            port=dict(votes=int(z["votes"]),
                      overlap=float(z["ver_overlap"]),
                      icp_t=z["icp_t"].tolist()),
            jax_votes=None if hit is None else hit[1],
            jax_overlap=None if ver is None else float(ver["overlap"]),
            jax_icp_from_port_ransac=verdict(z["ver_R"], z["ver_t"]),
            jax_icp_from_jax_ransac=(None if ver is None
                                     else verdict(ver["R"], ver["t"])),
            jax_extract_same_tri_valid=bool(np.array_equal(
                dj["tri_valid"], q["tri_valid"])),
            jax_extract_same_binary=bool(np.array_equal(
                dj["binary"], q["binary"])))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--trace", help="write the trace of the run here")
    ap.add_argument("--stop", type=int, help="run only the first N scans")
    ap.add_argument("--save-at", nargs=2, metavar=("SCAN", "PATH"),
                    help="after this scan (a reset) save the carried state")
    ap.add_argument("--resume", help="carried state after a reset (.npz)")
    ap.add_argument("--perturb", type=float, default=0.0,
                    help="added to the resumed gravity's x (m/s^2)")
    ap.add_argument("--replay", nargs="+", help="match .npz files")
    a = ap.parse_args()
    if a.replay:
        replay(a.replay)
    else:
        run(a.trace, a.stop, a.resume, a.perturb,
            *((int(a.save_at[0]), a.save_at[1]) if a.save_at else ()))


if __name__ == "__main__":
    main()
