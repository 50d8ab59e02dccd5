#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`voxelslam_tpu_torch`) on one GPU.

Run from the repository root:  python3 chip_smoke.py

Phases, each printing one JSON line:
  1. device   - nvidia-smi name and power limit, torch device name;
  2. build    - nvcc builds the moments kernel from csrc/ (sm_90a) while
                g++ builds the native descriptor store (csrc/btcdb.cpp);
  3. kernel   - the kernel against its plain version at the bench shapes
                (uniform and adversarial slots) and at the default
                config's shapes: within tolerance, bitwise repeatable and
                bitwise equal to the CPU's sequential index_add_ (each a
                check that fails the run); warm- and cold-L2 times with
                the queue full (see `time_ms`) and the HBM bound;
  4. slice    - SlamPipeline.process_scan at bench.py's configuration and
                scene (22 warm-up + 40 steady scans, then flush): init
                succeeds, no reset, finite poses, ATE < 0.10 m, one kernel
                launch per steady scan, and a second run bitwise equal;
     then the same checks and times on the main path's own inputs
     (the last steady scan's), with their slot statistics per level;
  5. system   - SlamSystem.process_scan with loop closure on, at bench.py's
                widths, over the elevator scenario of tests/test_elevator.py
                (434 scans: a room loop, out onto an open floor and back):
                a divergence reset, a later session, a cross-session loop
                edge to session 0, a correction with the position error
                under 2.5 m at it, finite poses, one kernel launch per
                steady scan, the native store behind every descriptor DB,
                and a second run bitwise equal (poses, loop edges,
                correction scans) up to 10 scans past the first
                correction; scans/s, ms per steady scan and the
                synchronised host time of each loop stage per keyframe;
  6. kernels  - one line listing every kernel with its numbers;
  7. the last line: {"ok": true, "device": {...}}.

Any failed phase exits non-zero. Nothing runs on the CPU when no GPU is
found, and nothing falls back to a kernel's plain version.
"""

import contextlib
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
N_TIMED = 100                   # calls per timed CUDA graph
N_REPEAT = 5                    # graph replays per timing median
FLUSH_BYTES = 128 << 20         # written between calls for cold-L2 times
DEFAULT_SHAPES = ((1 << 15, 1 << 16, 1 << 17), 8192)   # MapConfig/OdometryConfig
SYS_ERR_LIMIT = 2.5             # m at a correction (tests/test_elevator.py)
SYS_TAIL = 10                   # scans the second system run goes past the
                                # first correction


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


def _elevator():
    """tools/elevator_trace.py: the scenario and configuration of phase
    `system`, shared with the trace tools of both packages."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "tools"))
    import elevator_trace
    return elevator_trace


def system_config():
    """bench.py's widths with the loop threshold of tests/test_elevator.py
    and the default ground BTC profile (LoopPipeline's own)."""
    from voxelslam_tpu_torch import config
    return _elevator().system_config(config)


def elevator_packets():
    """The scenario of tests/test_elevator.py:70-130: a bounded room with
    pillars on an infinite floor; one circle in the room, out the +x side,
    a U-turn on the open floor, back in and a settling circle; 160x20
    beams, 0.012 m noise, 25 m range, seed = scan index. Returns (packets,
    ground-truth positions at mid-scan)."""
    from voxelslam_tpu_torch.io import simulator
    return _elevator().elevator_packets(simulator)


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


def time_ms(fn):
    """Device ms per fn() call, with the queue full.

    N_TIMED calls of fn are captured once in a CUDA graph. Each timing enqueues
    a sleep kernel, the start event, one replay of the graph and the end
    event: while the card sleeps, the host has enqueued everything, so the
    events see the calls run back to back and not Python's enqueue (a
    check raises if the host was still enqueueing when the sleep ended).
    Returns the median over N_REPEAT replays of (end - start) / N_TIMED."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                                  # warm-up off the capture
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(N_TIMED):
            fn()
    torch.cuda.synchronize()
    sleep_cycles = 2_000_000                  # about 1 ms at 1.98 GHz
    times = []
    while len(times) < N_REPEAT:
        e0, a, b = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        e0.record()
        torch.cuda._sleep(sleep_cycles)
        t0 = time.perf_counter()
        a.record()
        graph.replay()
        b.record()
        host_ms = 1e3 * (time.perf_counter() - t0)
        b.synchronize()
        if host_ms >= e0.elapsed_time(a):     # the queue ran dry
            sleep_cycles *= 2
            if sleep_cycles > 2_000_000_000:
                raise RuntimeError("cannot fill the queue ahead of the card")
            continue
        times.append(a.elapsed_time(b) / N_TIMED)
    del graph
    times.sort()
    return times[len(times) // 2]


def cold_ms(fn, flush):
    """Device ms per fn() with a cold L2: N_TIMED x (write the FLUSH_BYTES
    buffer, then fn) minus N_TIMED x (write the buffer), both timed as
    `time_ms` times."""
    def both():
        flush.zero_()
        fn()
    return time_ms(both) - time_ms(flush.zero_)


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
    repeat = all(torch.equal(bits(a), bits(b)) for a, b in zip(out, out2))
    vs_cpu = all(torch.equal(bits(a), bits(b)) for a, b in zip(out, cpu))
    return err, scale, repeat, vs_cpu


def bits(x):
    """A float32 tensor's bits on the CPU (+0.0 and -0.0 differ)."""
    import torch
    return x.cpu().contiguous().view(torch.int32)


def slot_stats(slots, upds, caps):
    """Per level: how the inputs fall on the table's rows. Zero rows are
    points whose 16 values are all +-0.0 (the kernel skips them);
    `max_per_row` counts the other in-range points on the busiest row,
    `max_per_row_all` counts every in-range point."""
    import torch
    stats = []
    for l, c in enumerate(caps):
        s = slots[l].long().cpu()
        inr = (s >= 0) & (s < c)
        zero = (upds[l].cpu() == 0).all(dim=1)
        keep = inr & ~zero
        cnt = torch.bincount(s[keep], minlength=c)
        cnt_all = torch.bincount(s[inr], minlength=c)
        stats.append(dict(
            C=c, P=int(s.numel()), distinct_rows=int((cnt > 0).sum()),
            max_per_row=int(cnt.max()), max_per_row_all=int(cnt_all.max()),
            zero_rows=int(zero.sum()), out_of_range=int((~inr).sum())))
    return stats


def time_kernel(slots, upds, caps, flush):
    """Kernel, cold-L2 kernel, plain and library ms, and the bytes bound
    in ms, on these inputs."""
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
    cold = cold_ms(lambda: mo.launch(slots, upds, caps, out), flush)
    mo.counter.launches = n0          # timing launches are not the main path
    plain = time_ms(lambda: mo.accumulate_ref(slots, upds, caps))
    library = time_ms(lambda: torch.zeros(
        (sum(caps), mo.CH), device=slots.device).index_add_(0, gslots, flat))
    nbytes = L * P * 4 + L * P * mo.CH * 4 + sum(caps) * mo.CH * 4
    return dict(ms=ms, cold_ms=cold, plain_ms=plain, library_ms=library,
                bound_ms=nbytes / HBM_BYTES_PER_S * 1e3)


def kernel_phase(name, slots, upds, caps, flush, **extra):
    """Check and time the kernel on one input; fail the run on any
    disagreement. Returns (max_abs_err, times)."""
    err, scale, repeat, vs_cpu = check_kernel(slots, upds, caps)
    within = err <= KERNEL_TOL * max(scale, 1.0)
    tm = time_kernel(slots, upds, caps, flush)
    emit("kernel", input=name, L=len(caps), P=slots.shape[1], caps=caps,
         max_abs_err=err, max_abs_sum=scale, tol=KERNEL_TOL,
         bitwise_repeat=repeat, bitwise_vs_cpu_index_add=vs_cpu, **tm,
         bound_share=tm["bound_ms"] / tm["ms"], **extra,
         ok=within and repeat and vs_cpu)
    if not within:
        fail(f"moments kernel disagrees with accumulate_ref ({name})")
    if not repeat:
        fail(f"moments kernel is not bitwise repeatable ({name})")
    if not vs_cpu:
        fail(f"moments kernel is not bitwise equal to the CPU's "
             f"index_add_ ({name})")
    return err, tm


@contextlib.contextmanager
def capturing(capture):
    """While active, `capture` holds the inputs (slots, upds, caps) of the
    last `moments.accumulate` call, the map insert's."""
    from voxelslam_tpu_torch.ops import moments as mo
    real = mo.accumulate

    def spy(slots, upds, caps):
        capture[:] = [slots.clone(), upds.clone(), tuple(caps)]
        return real(slots, upds, caps)
    mo.accumulate = spy
    try:
        yield capture
    finally:
        mo.accumulate = real


def run_slice(cfg, traj, packets, device, capture=None):
    """Drive SlamPipeline.process_scan over the packets; returns a dict of
    results. `capture` receives the last moments-kernel inputs."""
    import numpy as np
    import torch
    from voxelslam_tpu_torch.pipeline import SlamPipeline
    from voxelslam_tpu_torch.ops import moments as mo
    from voxelslam_tpu_torch.utils.metrics import ate_rmse

    with (capturing(capture) if capture is not None
          else contextlib.nullcontext()):
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


LOOP_STAGES = ("merge", "extract", "db_search", "verify", "icp", "optimize",
               "apply_correction", "keyframe_reload")


@contextlib.contextmanager
def stage_timers(times):
    """While active, every call of a loop stage is clocked on the host with
    a device synchronise before and after; times[stage] lists seconds."""
    import torch
    from voxelslam_tpu_torch.loop import btc
    from voxelslam_tpu_torch.pipeline import loop, odometry
    targets = [(loop.LoopPipeline, "_merge_keyframe", "merge"),
               (loop, "btc_extract", "extract"),
               (btc.DescriptorDB, "search", "db_search"),
               (btc.DescriptorDB, "verify", "verify"),
               (loop, "icp_point_to_plane", "icp"),
               (loop.LoopPipeline, "_optimize", "optimize"),
               (odometry.SlamPipeline, "apply_correction", "apply_correction"),
               (odometry.SlamPipeline, "insert_keyframe_fixed",
                "keyframe_reload")]
    saved = [(obj, name, getattr(obj, name)) for obj, name, _ in targets]

    def timed(fn, key):
        def call(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            times.setdefault(key, []).append(time.perf_counter() - t0)
            return out
        return call
    for (obj, name, key), (_, _, fn) in zip(targets, saved):
        setattr(obj, name, timed(fn, key))
    try:
        yield times
    finally:
        for obj, name, fn in saved:
            setattr(obj, name, fn)


def _snapshot(sysm, xs, corr_ks):
    """What the bitwise comparison of two system runs reads, after a scan:
    every per-scan odometry position so far, the emitted poses (as the
    loop pipeline has written them back), the loop edges and the scans
    that applied a correction."""
    import numpy as np
    poses = sysm.odom.scan_poses
    return dict(
        n=len(xs), x=np.stack(xs),
        rot=np.array([sp.R for sp in poses]).reshape(-1, 3, 3),
        pos=np.array([sp.p for sp in poses]).reshape(-1, 3),
        edges=[(e.id_a, e.id_b, e.ord_a, e.ord_b, e.R.tobytes(),
                e.t.tobytes()) for e in sysm.loop.lp_edges],
        corr_ks=list(corr_ks))


def run_system(cfg, packets, gt, stop=None, tail=None, times=None):
    """Drive SlamSystem.process_scan (loop closure on, no GBA) over the
    packets, or the first `stop` of them; with `times`, clock the loop
    stages and every call. The returned `snap` is taken after the last
    scan, or `tail` scans past the first correction when `tail` is set."""
    import numpy as np
    import torch
    from voxelslam_tpu_torch.ops import moments as mo
    from voxelslam_tpu_torch.pipeline.system import SlamSystem

    n = len(packets) if stop is None else stop
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with (stage_timers(times) if times is not None
          else contextlib.nullcontext()):
        sysm = SlamSystem(cfg, enable_loop=True, enable_gba=False,
                          device="cuda")
        lp = sysm.loop
        mo.counter.reset()
        phases, errs, xs, call_s, kf_scan, corr_ks = [], [], [], [], [], []
        n_steady, snap, snap_at = 0, None, None
        t_run = time.perf_counter()
        for k in range(n):
            n_kf = sum(len(s) for s in lp.keyframes)
            n_steady += int(sysm.odom.init_done)
            t0 = time.perf_counter()
            out = sysm.process_scan(*packets[k])
            torch.cuda.synchronize()
            call_s.append(time.perf_counter() - t0)
            corr = bool(out.get("loop_correction"))
            if corr:
                corr_ks.append(k)
            kf_scan.append(corr or sum(len(s) for s in lp.keyframes) > n_kf)
            phases.append(out.get("phase"))
            xs.append(sysm.odom.x.p.cpu().numpy())
            errs.append(float(np.linalg.norm(xs[-1] - gt[k])))
            if corr and tail is not None and snap_at is None:
                snap_at = k + 1 + tail
            if k + 1 == snap_at:
                snap = _snapshot(sysm, xs, corr_ks)
        run_s = time.perf_counter() - t_run
        launches = mo.counter.launches
    poses = sysm.odom.scan_poses
    steady = [s for s, ph, kf in zip(call_s, phases, kf_scan)
              if ph == "odom" and not kf]
    keyed = [s for s, kf in zip(call_s, kf_scan) if kf]
    # IMU init, init window, dynamic init (done or failed), resets
    other = [s for s, ph, kf in zip(call_s, phases, kf_scan)
             if ph != "odom" and not kf]
    finite = bool(np.isfinite(np.stack(xs)).all() and all(
        np.isfinite(sp.R).all() and np.isfinite(sp.p).all() for sp in poses))
    return dict(
        n=n, phases=phases, session=sysm.odom.session,
        edges=[(e.id_a, e.id_b, e.ord_a, e.ord_b) for e in lp.lp_edges],
        corrections=sysm.corrections, corr_ks=corr_ks, errs=errs,
        launches=launches, n_steady=n_steady, finite=finite,
        native_dbs=all(db._nat is not None for db in lp.dbs),
        snap=snap if snap is not None else _snapshot(sysm, xs, corr_ks),
        n_keyframes=sum(len(s) for s in lp.keyframes),
        keyframes_per_session=[len(s) for s in lp.keyframes],
        run_s=run_s, steady_ms=1e3 * float(np.mean(steady)) if steady else None,
        steady_ms_median=(1e3 * float(np.median(steady)) if steady
                          else None),
        keyframe_scan_ms=1e3 * float(np.mean(keyed)) if keyed else None,
        other_scan_ms=1e3 * float(np.mean(other)) if other else None,
        n_other=len(other),
        n_steady_timed=len(steady), n_keyframe_scans=len(keyed),
        peak_bytes=torch.cuda.max_memory_allocated())


def same_snapshot(a, b):
    """Bitwise equality of two runs' snapshots (see `_snapshot`)."""
    import numpy as np
    return (a["n"] == b["n"] and np.array_equal(a["x"], b["x"])
            and np.array_equal(a["rot"], b["rot"])
            and np.array_equal(a["pos"], b["pos"])
            and a["edges"] == b["edges"] and a["corr_ks"] == b["corr_ks"])


def system_phase(smi_line):
    """Phase 5: the full system with loop closure over the elevator
    scenario, twice; fails the run on any check."""
    import torch
    torch.use_deterministic_algorithms(True)
    cfg = system_config()
    t0 = time.perf_counter()
    packets, gt = elevator_packets()
    gen_s = time.perf_counter() - t0
    times = {}
    r = run_system(cfg, packets, gt, tail=SYS_TAIL, times=times)
    r2 = run_system(cfg, packets, gt, stop=r["snap"]["n"])
    torch.use_deterministic_algorithms(False)
    identical = same_snapshot(r["snap"], r2["snap"])
    names = r["phases"]
    cross0 = [e for e in r["edges"] if e[0] != e[1] and 0 in (e[0], e[1])]
    err_at = [r["errs"][k] for k in r["corr_ks"]]
    checks = {
        "reset": "reset" in names, "later_session": r["session"] >= 1,
        "cross_session_edge_to_session_0": bool(cross0),
        "correction": r["corrections"] >= 1 and bool(r["corr_ks"]),
        "error_at_correction_below_limit": bool(err_at)
        and min(err_at) < SYS_ERR_LIMIT,
        "finite": r["finite"], "native_descriptor_store": r["native_dbs"],
        "one_launch_per_steady_scan": r["launches"] == r["n_steady"] > 0,
        "second_run_bitwise_equal": identical,
    }
    n_kf = max(r["n_keyframes"], 1)
    stage = {}
    for k in LOOP_STAGES:
        ts = times.get(k, [])
        stage[k] = dict(calls=len(ts), total_s=float(sum(ts)),
                        ms_per_keyframe=1e3 * float(sum(ts)) / n_kf,
                        first_ms=1e3 * ts[0] if ts else None,
                        max_ms=1e3 * max(ts) if ts else None)
    emit("system", config="bench.py widths, LoopConfig(jud_default=0.45)",
         scenario="tests/test_elevator.py organic degrade-reset-relocalize",
         nvidia_smi=smi_line, scans=r["n"], packet_gen_s=gen_s,
         scans_per_s=r["n"] / r["run_s"], run_s=r["run_s"],
         ms_per_steady_scan=r["steady_ms"],
         ms_per_steady_scan_median=r["steady_ms_median"],
         steady_scans_timed=r["n_steady_timed"],
         ms_per_keyframe_scan=r["keyframe_scan_ms"],
         keyframe_scans=r["n_keyframe_scans"], keyframes=r["n_keyframes"],
         ms_per_init_or_reset_scan=r["other_scan_ms"],
         init_or_reset_scans=r["n_other"],
         keyframes_per_session=r["keyframes_per_session"],
         candidates_verified=stage["verify"]["calls"],
         icp_calls=stage["icp"]["calls"],
         corrections=r["corrections"],
         correction_scans=r["corr_ks"], error_at_corrections_m=err_at,
         error_limit_m=SYS_ERR_LIMIT, loop_edges=r["edges"],
         events=[(k, p) for k, p in enumerate(names) if p != "odom"],
         resets=names.count("reset"),
         init_failed=names.count("init_failed"), final_session=r["session"],
         kernel_launches=r["launches"], steady_calls=r["n_steady"],
         peak_mem_bytes=r["peak_bytes"], stages=stage,
         second_run_scans=r2["n"], run2_s=r2["run_s"], checks=checks)
    if not all(checks.values()):
        fail(f"system checks failed: {checks}")


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

    # 2. build: nvcc and g++ side by side
    from concurrent.futures import ThreadPoolExecutor
    from voxelslam_tpu_torch import native
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        builds = [pool.submit(mo.build), pool.submit(native.build)]
        lib, store = [f.result() for f in builds]
    mo._library()
    native.library()
    emit("build", seconds=round(time.perf_counter() - t0, 3), library=lib.name,
         descriptor_store=store.name)

    # 3. kernel vs plain version at the bench and default shapes
    cfg = bench_config()
    caps, P = tuple(cfg.map.capacities), cfg.odom.point_max
    flush = torch.empty(FLUSH_BYTES // 4, device="cuda")
    errs = []
    for name, shapes, adv, seed in (
            ("uniform", (caps, P), False, 0),
            ("adversarial", (caps, P), True, 1),
            ("default_config", DEFAULT_SHAPES, False, 2)):
        slots, upds = kernel_inputs(*shapes, adv, seed)
        errs.append(kernel_phase(name, slots, upds, shapes[0], flush)[0])
    del flush, slots, upds            # not part of the slice's peak memory
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
    flush = torch.empty(FLUSH_BYTES // 4, device="cuda")
    err, tm = kernel_phase("main_path", slots, upds, caps_r, flush,
                           slot_stats=slot_stats(slots, upds, caps_r))
    errs.append(err)
    del flush, slots, upds

    # 5. the full system with loop closure
    system_phase(smi_line)

    # 6. kernels line
    print(json.dumps({"kernels": [{
        "name": "accumulate", "route": "cuda",
        "source": "voxelslam_tpu_torch/csrc/moments.cu",
        "replaces": "voxelslam_tpu/ops/moments.py:103",
        "launches": r["launches"], "max_abs_err": max(errs),
        "ms": tm["ms"], "plain_ms": tm["plain_ms"],
        "bound_ms": tm["bound_ms"], "bound_by": "bytes",
        "library_ms": tm["library_ms"], "cold_ms": tm["cold_ms"],
        "bound_share": tm["bound_ms"] / tm["ms"]}]}), flush=True)

    # 7. last line
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
