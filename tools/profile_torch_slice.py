#!/usr/bin/env python3
"""Where the time of the PyTorch port's steady scan step goes, on one GPU.

Run from the repository root:  python3 tools/profile_torch_slice.py

Drives `SlamPipeline.process_scan` of `voxelslam_tpu_torch` at bench.py's
configuration and scene (the same as chip_smoke.py) through init and a
warm-up, then measures the steady scans three ways:

  1. wall clock per scan (synchronised), no instrumentation;
  2. per stage of `_steady_megastep`: each stage function wrapped in
     synchronise + host clock (the sum exceeds 1. by the added syncs);
  3. torch.profiler over a few steady scans: device busy share (sum of
     kernel time over wall time; one stream, so kernels do not overlap),
     kernel launches and host<->device copies per scan, and the kernels
     that take the most device time.

Prints one JSON object and writes it to chiprun_out/profile_slice.json.
Needs a GPU; exits non-zero without one.
"""

import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

N_WARM, N_STEADY, N_PROF = 22, 24, 8


def main():
    import torch
    if not torch.cuda.is_available():
        sys.exit("profile_torch_slice: needs a GPU")
    import chip_smoke as cs
    from voxelslam_tpu_torch.pipeline import SlamPipeline
    from voxelslam_tpu_torch.pipeline import odometry as odo

    torch.use_deterministic_algorithms(True)
    cfg = cs.bench_config()
    traj, packets = cs.bench_packets(N_WARM + N_STEADY + N_PROF)
    pipe = SlamPipeline(cfg, collect_clouds=False)
    K = cfg.odom.batch_scans
    for pkt in packets[:N_WARM]:
        pipe.process_scan(*pkt)
    assert pipe.init_done

    # 1. + 2.: half the steady scans plain, half with stage clocks
    half = N_STEADY // 2
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for pkt in packets[N_WARM:N_WARM + half]:
        pipe.process_scan(*pkt)
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t0) / half

    stages = {}
    targets = [(odo.ekf, "propagate"), (odo.ekf, "deskew"),
               (odo, "voxel_downsample"), (odo.pre, "integrate"),
               (odo.iekf, "iekf_update"), (odo.vm, "insert_scan_fused"),
               (odo.vm, "refresh_planes"), (odo.vm, "harvest_t"),
               (odo.opt, "lm_li"), (odo.vm, "marginalize")]
    saved = [(mod, name, getattr(mod, name)) for mod, name in targets]

    def clocked(name, fn):
        def run(*a, **kw):
            torch.cuda.synchronize()
            s = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            stages[name] = stages.get(name, 0.0) + time.perf_counter() - s
            return out
        return run

    for mod, name, fn in saved:
        setattr(mod, name, clocked(name, fn))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for pkt in packets[N_WARM + half:N_WARM + N_STEADY]:
        pipe.process_scan(*pkt)
    torch.cuda.synchronize()
    clocked_ms = 1e3 * (time.perf_counter() - t0) / (N_STEADY - half)
    for mod, name, fn in saved:
        setattr(mod, name, fn)
    n_clocked = N_STEADY - half

    # 3. profiler over N_PROF steady scans (a whole number of batches)
    from torch.profiler import profile, ProfilerActivity
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for pkt in packets[N_WARM + N_STEADY:]:
            pipe.process_scan(*pkt)
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    pipe.flush()

    kernels, runtime = [], {}
    for e in prof.key_averages():
        dev = getattr(e, "self_device_time_total", None)
        if dev is None:
            dev = getattr(e, "self_cuda_time_total", 0)
        if str(e.device_type).endswith("CUDA"):
            kernels.append((e.key, e.count, dev))
        elif e.key.startswith("cuda") or e.key.startswith("cudnn"):
            runtime[e.key] = e.count
    kernels.sort(key=lambda k: -k[2])
    busy_us = sum(k[2] for k in kernels)
    smi = cs.subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                             "--format=csv,noheader"], capture_output=True,
                            text=True, timeout=60).stdout.strip()
    res = {
        "card": smi, "kind": torch.cuda.get_device_name(0),
        "config": "bench.py", "batch_scans": K,
        "steady_ms_per_scan": plain_ms,
        "clocked_ms_per_scan": clocked_ms,
        "stage_ms_per_scan": {k: 1e3 * v / n_clocked
                              for k, v in sorted(stages.items(),
                                                 key=lambda kv: -kv[1])},
        "profiled_scans": N_PROF,
        "profiled_ms_per_scan": 1e3 * prof_wall / N_PROF,
        "device_busy_ms_per_scan": busy_us / 1e3 / N_PROF,
        "device_busy_share": busy_us / 1e6 / prof_wall,
        "kernel_launches_per_scan": sum(k[1] for k in kernels) / N_PROF,
        "runtime_calls_per_scan": {k: v / N_PROF for k, v in sorted(
            runtime.items(), key=lambda kv: -kv[1])[:12]},
        "top_kernels": [{"name": k[0][:120], "calls_per_scan": k[1] / N_PROF,
                         "device_ms_per_scan": k[2] / 1e3 / N_PROF}
                        for k in kernels[:15]],
    }
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "profile_slice.json").write_text(json.dumps(res, indent=1))
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
