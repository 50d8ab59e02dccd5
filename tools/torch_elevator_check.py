"""The PyTorch port over the elevator scenario of tests/test_elevator.py at
bench.py's widths (what `chip_smoke.py` phase `system` runs), with the
trace of tools/elevator_trace.py. Prints one JSON line: the run's summary
and, with --against, where it parts from another trace (the JAX
package's, from tools/jax_elevator_check.py --trace).

    python tools/torch_elevator_check.py --device cpu --trace torch.json \\
        --against jax.json          # the port on the CPU beside JAX
    python tools/torch_elevator_check.py --device cuda \\
        --trace chiprun_out/elevator_cuda.json --dump chiprun_out/matches
        # on the GPU (deterministic algorithms on, as chip_smoke.py runs
        # it); --dump writes each accepted cross-session match's inputs
        # for tools/jax_elevator_check.py --replay
    python tools/torch_elevator_check.py --device cpu --resume s.npz \\
        --stop 267 --against jax.json
        # starts after the reset that tools/jax_elevator_check.py --save-at
        # saved, from the JAX package's carried state; only the odometry
        # resumes (no earlier keyframes), so the comparison reads phases,
        # sessions and corrections; --perturb 1e-5 shifts the carried
        # gravity, to see how far the init's outcome moves with it
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import torch  # noqa: E402
from voxelslam_tpu_torch import config as cm  # noqa: E402
from voxelslam_tpu_torch.io import simulator as sim  # noqa: E402
from voxelslam_tpu_torch.loop import btc  # noqa: E402
from voxelslam_tpu_torch.pipeline import loop as tloop  # noqa: E402
from voxelslam_tpu_torch.pipeline.system import SlamSystem  # noqa: E402
import elevator_trace as et  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--trace", help="write the trace of the run here")
    ap.add_argument("--against", help="a trace to compare the run with")
    ap.add_argument("--dump", help="directory for accepted-match inputs")
    ap.add_argument("--stop", type=int, help="run only the first N scans")
    ap.add_argument("--resume", help="carried state after a reset (.npz)")
    ap.add_argument("--perturb", type=float, default=0.0,
                    help="added to the resumed gravity's x (m/s^2)")
    a = ap.parse_args()
    torch.set_num_threads(min(8, torch.get_num_threads()))
    torch.use_deterministic_algorithms(True)
    if a.dump:
        os.makedirs(a.dump, exist_ok=True)
    packets, gt = et.elevator_packets(sim, a.stop)
    sysm = SlamSystem(et.system_config(cm), enable_loop=True,
                      enable_gba=False, device=a.device)
    tr = et.Tracer(lambda x: x.detach().cpu().numpy(), a.dump)
    tr.install(tloop.LoopPipeline, btc.DescriptorDB,
               [(tloop, "icp_point_to_plane")])
    start = 0
    if a.resume:
        start = tr.k = et.resume(
            sysm, a.resume, lambda x: torch.as_tensor(
                x, dtype=torch.float32, device=sysm.odom.device), a.perturb)
    t0 = time.time()
    for k in range(start, len(packets)):
        out = sysm.process_scan(*packets[k])
        tr.scan(sysm, out, gt[k])
    res = tr.result(sysm)
    tr.uninstall()
    if a.trace:
        et.save(a.trace, res)
    line = dict(et.summary(res), secs=time.time() - t0, device=a.device,
                n_kf=[len(k) for k in sysm.loop.keyframes])
    if a.against:
        line["against"] = et.compare(
            res, et.load(a.against),
            keys=("phase", "session", "corr") if a.resume else et.SCAN_KEYS)
    print(json.dumps(line))


if __name__ == "__main__":
    main()
