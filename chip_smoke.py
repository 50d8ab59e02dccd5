#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`voxelslam_tpu_torch`) on one GPU.

Run from the repository root:  python3 chip_smoke.py

Phases, each printing one JSON line:
  1. device   - nvidia-smi name and power limit, torch device name;
  2. build    - nvcc builds the moments kernel from csrc/ (sm_90a);
  3. kernel   - the kernel against its plain version at the bench shapes
                (uniform and adversarial slots), bitwise repeatability,
                times (CUDA events, median) and the HBM bound;
  4. slice    - SlamPipeline.process_scan at bench.py's configuration and
                scene (22 warm-up + 40 steady scans, then flush): init
                succeeds, no reset, finite poses, ATE < 0.10 m, one kernel
                launch per steady scan, and a second run bitwise equal;
  5. kernels  - one line listing every kernel with its numbers;
  6. the last line: {"ok": true, "device": {...}}.

Any failed phase exits non-zero. Nothing runs on the CPU when no GPU is
found, and nothing falls back to a kernel's plain version.
"""

import json
import os
import subprocess
import sys
import time

# cuBLAS needs a fixed workspace to be deterministic (checked by
# torch.use_deterministic_algorithms); set before CUDA initializes
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

HBM_BYTES_PER_S = 3.35e12       # H100 SXM HBM3 (data sheet)
KERNEL_TOL = 1e-5               # max abs error / max |sum|
ATE_LIMIT = 0.10                # m (JAX e2e bound, tests/test_pipeline_e2e.py)
N_WARM, N_STEADY = 22, 40       # bench.py's warm-up and segment length
N_TIMED = 30                    # launches per timing median


def emit(phase, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def bench_config():
    from voxelslam_tpu_torch.config import (SlamConfig, MapConfig,
                                            OdometryConfig, LocalBAConfig)
    return SlamConfig(
        map=MapConfig(capacities=(1 << 13, 1 << 15, 1 << 16),
                      unique_max=(4096, 4096, 8192), evict_load=0.55),
        odom=OdometryConfig(point_max=4096, imu_max=64, batch_scans=4),
        lba=LocalBAConfig(factor_max=1024))


def bench_packets(n_scans, n_az=160, n_el=24):
    """bench.py's scene: box room, 200 Hz IMU, seed = scan index."""
    import numpy as np
    from voxelslam_tpu_torch.io import simulator as sim
    traj = sim.make_trajectory(duration=0.2 + 0.1 * (n_scans + 2), speed=1.2,
                               wobble=0.25, yaw_rate=0.3, ramp=1.2)
    normals, dsp = sim.box_room(half_extent=(14.0, 12.0, 3.5),
                                center=(4.0, 0.0, 1.0))
    packets, t = [], 0.1
    for k in range(n_scans):
        scan = sim.lidar_scan(traj, t, t + 0.1, normals, dsp, n_az=n_az,
                              n_el=n_el, noise=0.01, seed=k)
        hit = scan["hit"]
        ts = np.arange(t - 0.01, t + 0.1 + 1e-6, 1.0 / 200.0)
        imu = np.array([np.concatenate(traj.imu_at(ti)) for ti in ts])
        packets.append((scan["points"][hit], scan["offsets"][hit], ts,
                        imu[:, 0:3], imu[:, 3:6], t, t + 0.1))
        t += 0.1
    return traj, packets


def time_ms(fn, n=N_TIMED):
    """Median device time of fn() over n launches (CUDA events)."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def kernel_inputs(caps, P, adversarial, seed):
    import torch
    g = torch.Generator().manual_seed(seed)
    L = len(caps)
    slots = torch.stack([torch.randint(0, c, (P,), generator=g) for c in caps])
    upds = torch.randn((L, P, 16), generator=g)
    upds[:, :, 15] = 0.0
    if adversarial:
        hot = torch.rand((L, P), generator=g) < 0.9
        four = torch.randint(0, 4, (L, P), generator=g)
        slots = torch.where(hot, four, slots)
        invalid = torch.rand((L, P), generator=g) < 0.1
        upds[invalid] = 0.0
    return slots.to(torch.int32).cuda().contiguous(), upds.cuda().contiguous()


def check_kernel(slots, upds, caps):
    """Kernel vs plain version on the card: (max_abs_err, scale,
    bitwise_repeat, bitwise_vs_cpu)."""
    import torch
    from voxelslam_tpu_torch.ops import moments as mo
    out = mo.accumulate(slots, upds, caps)
    out2 = mo.accumulate(slots, upds, caps)
    ref = mo.accumulate_ref(slots, upds, caps)
    cpu = mo.accumulate_ref(slots.cpu(), upds.cpu(), caps)
    torch.cuda.synchronize()
    err = max(float((a - b).abs().max()) for a, b in zip(out, ref))
    scale = max(float(b.abs().max()) for b in ref)
    repeat = all(torch.equal(a, b) for a, b in zip(out, out2))
    vs_cpu = all(torch.equal(a.cpu(), b) for a, b in zip(out, cpu))
    return err, scale, repeat, vs_cpu


def time_kernel(slots, upds, caps):
    """(kernel ms, plain ms, library ms, bound ms) on these inputs."""
    import torch
    from voxelslam_tpu_torch.ops import moments as mo
    L, P = slots.shape
    out = torch.empty((sum(caps), mo.CH), device=slots.device)
    offs = torch.tensor([sum(caps[:l]) for l in range(L)],
                        device=slots.device)[:, None]
    gslots = (slots.long() + offs).reshape(-1)
    flat = upds.reshape(-1, mo.CH)
    n0 = mo.counter.launches
    ms = time_ms(lambda: mo.launch(slots, upds, caps, out))
    mo.counter.launches = n0          # timing launches are not the main path
    plain = time_ms(lambda: mo.accumulate_ref(slots, upds, caps))
    library = time_ms(lambda: torch.zeros(
        (sum(caps), mo.CH), device=slots.device).index_add_(0, gslots, flat))
    nbytes = L * P * 4 + L * P * mo.CH * 4 + sum(caps) * mo.CH * 4
    return ms, plain, library, nbytes / HBM_BYTES_PER_S * 1e3


def run_slice(cfg, traj, packets, device, capture=None):
    """Drive SlamPipeline.process_scan over the packets; returns a dict of
    results. `capture` receives the last moments-kernel inputs."""
    import numpy as np
    import torch
    from voxelslam_tpu_torch.pipeline import SlamPipeline
    from voxelslam_tpu_torch.ops import moments as mo
    from voxelslam_tpu_torch.utils.metrics import ate_rmse
    import voxelslam_tpu_torch.map.voxel_map as vm

    if capture is not None:
        real = mo.accumulate

        def spy(slots, upds, caps):
            capture[:] = [slots.clone(), upds.clone(), tuple(caps)]
            return real(slots, upds, caps)
        vm.mo.accumulate = spy
    try:
        pipe = SlamPipeline(cfg, collect_clouds=False, device=device)
        phases, n_steady = [], 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        mo.counter.reset()
        t_steady = None
        for k, pkt in enumerate(packets):
            if k == N_WARM:
                torch.cuda.synchronize()
                t_steady = time.perf_counter()
            n_steady += int(pipe.init_done)
            phases.append(pipe.process_scan(*pkt).get("phase"))
        torch.cuda.synchronize()
        steady_s = time.perf_counter() - t_steady
        pipe.flush()
        launches = mo.counter.launches
    finally:
        if capture is not None:
            vm.mo.accumulate = real
    poses = pipe.scan_poses
    est = np.stack([sp.p for sp in poses])
    rot = np.stack([sp.R for sp in poses])
    gt = np.stack([traj.state_at(sp.t)[1] for sp in poses])
    return dict(
        phases=phases, init_done=pipe.init_done, n_steady=n_steady,
        launches=launches, poses=len(poses), est=est, rot=rot,
        finite=bool(np.isfinite(est).all() and np.isfinite(rot).all()),
        ate=float(ate_rmse(est, gt)), steady_scans=len(packets) - N_WARM,
        steady_s=steady_s, peak_bytes=torch.cuda.max_memory_allocated())


def main():
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a GPU")
    try:
        import voxelslam_tpu_torch  # noqa: F401
        from voxelslam_tpu_torch.ops import moments as mo
    except ImportError as e:
        fail(f"cannot import the port (run from the repository root): {e}")

    # 1. device
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    smi_line = smi.stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    print(smi_line, flush=True)
    emit("device", nvidia_smi=smi_line, torch_name=kind,
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda)

    # 2. build
    t0 = time.perf_counter()
    lib = mo.build()
    mo._library()
    emit("build", seconds=round(time.perf_counter() - t0, 3), library=lib.name)

    # 3. kernel vs plain version at the bench shapes
    cfg = bench_config()
    caps, P = tuple(cfg.map.capacities), cfg.odom.point_max
    kern = {}
    for name, adv, seed in (("uniform", False, 0), ("adversarial", True, 1)):
        slots, upds = kernel_inputs(caps, P, adv, seed)
        err, scale, repeat, vs_cpu = check_kernel(slots, upds, caps)
        ok = err <= KERNEL_TOL * max(scale, 1.0) and repeat
        ms, plain, library, bound = time_kernel(slots, upds, caps)
        emit("kernel", input=name, L=len(caps), P=P, caps=caps,
             max_abs_err=err, max_abs_sum=scale, tol=KERNEL_TOL,
             bitwise_repeat=repeat, bitwise_vs_cpu_index_add=vs_cpu,
             ms=ms, plain_ms=plain, library_ms=library, bound_ms=bound,
             ok=ok)
        if not ok:
            fail(f"moments kernel disagrees with accumulate_ref ({name})")
        kern[name] = (err, ms, plain, library, bound)
    mo.counter.reset()

    # 4. the slice: bench.py configuration and scene, twice
    torch.use_deterministic_algorithms(True)
    traj, packets = bench_packets(N_WARM + N_STEADY)
    capture = []
    runs = [run_slice(cfg, traj, packets, "cuda", capture)]
    runs.append(run_slice(cfg, traj, packets, "cuda"))
    r = runs[0]
    identical = (np.array_equal(r["est"], runs[1]["est"])
                 and np.array_equal(r["rot"], runs[1]["rot"]))
    bad = [p for p in r["phases"] if p in ("reset", "init_failed")]
    checks = {
        "init_done": r["init_done"], "no_reset": not bad,
        "finite": r["finite"], "ate_below_limit": r["ate"] < ATE_LIMIT,
        "one_launch_per_steady_scan": r["launches"] == r["n_steady"] > 0,
        "two_runs_bitwise_equal": identical,
    }
    emit("slice", config="bench.py", scans=len(packets),
         steady_scans=r["steady_scans"], emitted_poses=r["poses"],
         ate_m=r["ate"], ate_limit_m=ATE_LIMIT,
         steady_scans_per_s=r["steady_scans"] / r["steady_s"],
         ms_per_scan=1e3 * r["steady_s"] / r["steady_scans"],
         run2_ms_per_scan=1e3 * runs[1]["steady_s"] / r["steady_scans"],
         peak_mem_bytes=r["peak_bytes"], kernel_launches=r["launches"],
         steady_calls=r["n_steady"], checks=checks)
    if not all(checks.values()):
        fail(f"slice checks failed: {checks}")

    # the kernel at the main path's own inputs (last steady scan)
    torch.use_deterministic_algorithms(False)
    slots, upds, caps_r = capture
    err, scale, repeat, _ = check_kernel(slots, upds, caps_r)
    if not (err <= KERNEL_TOL * max(scale, 1.0) and repeat):
        fail("moments kernel disagrees with accumulate_ref on main-path input")
    ms, plain, library, bound = time_kernel(slots, upds, caps_r)

    # 5. kernels line
    print(json.dumps({"kernels": [{
        "name": "accumulate", "route": "cuda",
        "source": "voxelslam_tpu_torch/csrc/moments.cu",
        "replaces": "voxelslam_tpu/ops/moments.py:103",
        "launches": r["launches"], "max_abs_err": max(
            err, kern["uniform"][0], kern["adversarial"][0]),
        "ms": ms, "plain_ms": plain, "bound_ms": bound, "bound_by": "bytes",
        "library_ms": library}]}), flush=True)

    # 6. last line
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
