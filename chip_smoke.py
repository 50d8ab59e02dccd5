#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`voxelslam_tpu_torch`) on one GPU.

Run from the repository root:  python3 chip_smoke.py

Phases, each printing one JSON line:
  1. device   - nvidia-smi name and power limit, torch device name;
  2. build    - nvcc builds the moments kernel from csrc/ (sm_90a) while
                g++ builds the native descriptor store (csrc/btcdb.cpp)
                and the scan ingest and loader (csrc/ingest.cpp,
                csrc/loader.cpp);
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
                and a second run bitwise equal (poses, loop edges, GBA
                edges and submaps, correction scans) until 10 scans past
                the first correction; scans/s, ms per steady scan and the
                synchronised host time of each loop stage per keyframe;
     with GBA on in both runs (`enable_gba=True`): the first run ends
     with finish() (bottom-up flush, total BA, top-down solve): windows,
     edges, submaps, the seconds of the total BA and the top-down solve,
     and the position error of the scans of every session linked to
     session 0, before and after finish(); poses finite, top-down ran;
  6. sessions - save() of the first system run's last session and its
                reload through SlamSystem(previous_maps=[...]): floor(
                scans / win_size) keyframes, a reloaded keyframe's BTC
                query finds a candidate, alidarState.txt reads back;
  7. slice_mg2 - phase 4's packets with lba.mgsize = 2 (a BA burst every
                second scan, refill scans between): ATE < 0.10 m, one
                kernel launch per steady or refill scan, a second run
                bitwise equal;
  8. gba_window - HbaRunner at SlamSystem's widths (8,192-point
                keyframes, GBAConfig defaults), streamed, flushed, then
                the total BA, over 30 keyframes of tests/test_gba.py's
                scene (as a user runs it) and twice over 20 of
                bench_gba.py's synthetic corridor (under deterministic
                algorithms): ms per window, rounds, host reads, peak
                memory of each; kernel launches, host syncs and device
                busy time of one profiled window of each; on the scene
                every window lowers its residual and the relative-pose
                error falls below half its input (see `gba_phase` for why
                not on the corridor); the corridor runs bitwise equal;
     then the scene's windows batched (HbaRunner(mesh=global_win_mesh(1),
     fleet_batch=1, 2, 4)): ms per window, rounds and host reads per
     batch, peak memory, launches and device busy share of one profiled
     batch; under deterministic algorithms, edges and submaps within
     tests/test_dist_gba.py's tolerances of the single-window run's; the
     corridor at fleet_batch 2 twice bitwise equal, and once through a
     1-rank NCCL process group (the gather on the card) bitwise equal to
     those;
  9. cli      - `python -m voxelslam_tpu_torch run DIR --preset hesai --gba
                --save-dir S --export-map m.ply --export-traj t.tum`, called
                in-process as cli.main, over a recorded Hesai dataset
                written from phase slice's scene (150 scans, 32 beams, the
                points in the LiDAR frame through the preset's extrinsic)
                at the hesai preset's full width: rc 0, ATE < 0.10 m from
                the TUM file, one kernel launch per steady scan, the
                session reloads, the PLY parses, the native loader's
                packets equal the inline path's; scans/s, the ms a scan
                waited on the loader, host decode ms a scan; then `export`
                of the saved session and `info hesai`;
  10. checkpoint - SlamSystem on phase cli's packets, saved with a GBA
                window in flight, continued 10 scans; restored on the card
                it continues bitwise equal, restored on the CPU within
                5e-3; save and load seconds, the file's bytes;
  11. timing  - the wall seconds of the phases (device, build, kernel and
                slice together as `to_system`);
  12. kernels - one line listing every kernel with its numbers;
  13. the last line: {"ok": true, "device": {...}}.

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
GBA_KF, GBA_P = 30, 8192        # phase gba_window: keyframes, points each
CORRIDOR_KF = 20                # phase gba_window: the corridor's keyframes
FLEET_BATCHES = (1, 2, 4)       # phase gba_window: windows a batched call
# phase cli: 150 scans at 10 Hz of a 32-beam spinning LiDAR (the
# PandarXT-32's channels); 240 azimuths give 7,680 rays a scan, which the
# hesai preset's 0.1 m downsample keeps nearly whole, under point_max 8192
CLI_SCANS, CLI_AZ, CLI_EL = 150, 240, 32
CKPT_TAIL = 10                  # scans each system continues past the save
POSE_TOL = 5e-3                 # m and rotation entries, CPU against the card
                                # (tests/test_torch_system.py)
OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "chiprun_out")


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
        phases, n_steady, refills = [], 0, 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        mo.counter.reset()
        t_steady = None
        for k, pkt in enumerate(packets):
            if k == N_WARM:
                torch.cuda.synchronize()
                t_steady = time.perf_counter()
            n_steady += int(pipe.init_done)
            out = pipe.process_scan(*pkt)
            phases.append(out.get("phase"))
            refills += int(bool(out.get("accum")))
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
        refills=refills, launches=launches, poses=len(poses), est=est, rot=rot,
        finite=bool(np.isfinite(est).all() and np.isfinite(rot).all()),
        ate=float(ate_rmse(est, gt)), steady_scans=len(packets) - N_WARM,
        steady_s=steady_s, peak_bytes=torch.cuda.max_memory_allocated())


def slice_mg2_phase(cfg, traj, packets):
    """Phase slice_mg2: the slice's packets with lba.mgsize = 2, twice.
    Returns the first run's kernel launches."""
    import dataclasses
    import numpy as np
    import torch
    cfg2 = dataclasses.replace(cfg, lba=dataclasses.replace(cfg.lba,
                                                            mgsize=2))
    torch.use_deterministic_algorithms(True)
    runs = [run_slice(cfg2, traj, packets, "cuda") for _ in range(2)]
    torch.use_deterministic_algorithms(False)
    r = runs[0]
    bad = [p for p in r["phases"] if p in ("reset", "init_failed")]
    checks = {
        "init_done": r["init_done"], "no_reset": not bad,
        "finite": r["finite"], "ate_below_limit": r["ate"] < ATE_LIMIT,
        "refill_scans": r["refills"] > 0,
        "one_launch_per_steady_or_refill_scan":
            r["launches"] == r["n_steady"] > 0,
        "two_runs_bitwise_equal": bool(
            np.array_equal(r["est"], runs[1]["est"])
            and np.array_equal(r["rot"], runs[1]["rot"])),
    }
    emit("slice_mg2", config="bench.py, lba.mgsize=2", scans=len(packets),
         steady_scans=r["steady_scans"], refill_scans=r["refills"],
         emitted_poses=r["poses"], ate_m=r["ate"], ate_limit_m=ATE_LIMIT,
         ms_per_scan=1e3 * r["steady_s"] / r["steady_scans"],
         run2_ms_per_scan=1e3 * runs[1]["steady_s"] / r["steady_scans"],
         peak_mem_bytes=r["peak_bytes"], kernel_launches=r["launches"],
         steady_calls=r["n_steady"], checks=checks)
    if not all(checks.values()):
        fail(f"slice_mg2 checks failed: {checks}")
    return r["launches"]


def corridor_keyframes(n, P, seed=0):
    """bench_gba.py's synthetic corridor keyframes, copied (bench_gba.py
    imports the JAX package): two side walls and a floor, true poses
    R = I, p = (0.8 i, 0, 1.2), the stored p0 off by 0.03 m noise.
    Returns (keyframes, true (R, p) per keyframe)."""
    import numpy as np
    from voxelslam_tpu_torch.pipeline.loop import Keyframe
    rng = np.random.default_rng(seed)
    n_wall = P // 3
    base = np.concatenate([
        np.stack([rng.uniform(-15, 15, n_wall), np.full(n_wall, 4.0),
                  rng.uniform(0, 3, n_wall)], -1),
        np.stack([rng.uniform(-15, 15, n_wall), np.full(n_wall, -4.0),
                  rng.uniform(0, 3, n_wall)], -1),
        np.stack([rng.uniform(-15, 15, P - 2 * n_wall),
                  rng.uniform(-4, 4, P - 2 * n_wall),
                  np.zeros(P - 2 * n_wall)], -1),
    ]).astype(np.float32)
    kfs, truth = [], []
    for i in range(n):
        p0 = np.array([0.8 * i, 0.0, 1.2])
        body = (base - p0 + rng.normal(0, 0.01, base.shape)).astype(
            np.float32)
        kfs.append(Keyframe(
            kf_index=i, scan_id=i, session=0, R0=np.eye(3),
            p0=p0 + rng.normal(0, 0.03, 3), cloud=body,
            mask=np.ones(P, np.float32), jour=float(i)))
        truth.append((np.eye(3), p0))
    return kfs, truth


def scene_keyframes(n, P, seed=3, perturb=0.02):
    """tests/test_gba.py's keyframes: the simulator's scene sampled at 10
    points/m^2, keyframes along a line with a turning yaw, each cloud the
    scene within 18 m seen from the true pose, the stored poses (after the
    first) perturbed by `perturb` rad and 4 * `perturb` m. Returns
    (keyframes, true (R, p) per keyframe)."""
    import numpy as np
    from voxelslam_tpu_torch.io import simulator as sim
    from voxelslam_tpu_torch.pipeline.loop import Keyframe
    rng = np.random.default_rng(seed)
    world = sim.sample_scene(sim.make_scene(), per_m2=10.0, seed=seed,
                             noise=0.01)
    kfs, truth = [], []
    for i in range(n):
        yaw = 0.08 * i
        R0 = np.array([[np.cos(yaw), -np.sin(yaw), 0],
                       [np.sin(yaw), np.cos(yaw), 0], [0, 0, 1.0]])
        p0 = np.array([0.6 * i, 0.25 * i, 1.0])
        near = world[np.linalg.norm(world - p0, axis=1) < 18.0]
        sub = near[rng.permutation(len(near))[:P]]
        cloud = np.zeros((P, 3), np.float32)
        mask = np.zeros((P,), np.float32)
        cloud[:len(sub)] = (sub - p0) @ R0
        mask[:len(sub)] = 1.0
        Rk, pk = R0, p0
        if i > 0:
            Rk = R0 @ sim._exp(rng.normal(0, perturb, 3))
            pk = p0 + rng.normal(0, perturb * 4, 3)
        kfs.append(Keyframe(kf_index=i, scan_id=i, session=0, R0=Rk, p0=pk,
                            cloud=cloud, mask=mask, jour=float(i)))
        truth.append((R0, p0))
    return kfs, truth


def run_gba(kfs, mesh=None, fleet_batch=None, total=True):
    """Stream the keyframes through an HbaRunner at SlamSystem's widths
    (its defaults; with a mesh, windows batched `fleet_batch` at a time),
    flush, then (with `total`) the total BA; synchronised clocks.
    `n_steps` counts the window steps (batches with a mesh) of the
    stream, `n_windows` its windows."""
    import torch
    from voxelslam_tpu_torch.config import SlamConfig
    from voxelslam_tpu_torch.gba import HbaRunner
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    runner = HbaRunner(SlamConfig(), mesh=mesh, fleet_batch=fleet_batch,
                       device="cuda")
    outs, call_ms = [], []
    t0 = time.perf_counter()
    for kf in kfs + [None]:
        t1 = time.perf_counter()
        out = runner.add_keyframe(kf) if kf is not None else runner.flush()
        torch.cuda.synchronize()
        if out is not None:
            outs.append(out)
            call_ms.append(1e3 * (time.perf_counter() - t1))
    stream_s = time.perf_counter() - t0
    n_steps, stream_syncs = len(runner.window_log), runner.host_syncs
    n_windows = len(runner.submaps)
    t0 = time.perf_counter()
    total = runner.total_ba() if total else None
    torch.cuda.synchronize()
    return dict(runner=runner, outs=outs, call_ms=call_ms, stream_s=stream_s,
                n_steps=n_steps, n_windows=n_windows,
                stream_syncs=stream_syncs, total=total,
                total_s=time.perf_counter() - t0,
                peak_bytes=torch.cuda.max_memory_allocated())


def window_step(runner, windows):
    """A callable that runs one window step and reads it at once: without
    a mesh, the window BA of windows[0] (`_run_window`); with one, the
    batch of `windows` through the batched step (`_batch_step`) and one
    read of its outputs."""
    import numpy as np
    if runner.mesh is None:
        return lambda: runner._run_window(windows[0], len(windows[0]))
    inp = (np.stack([[k.cloud for k in w] for w in windows]),
           np.stack([[k.mask for k in w] for w in windows]),
           np.stack([[k.R0 for k in w] for w in windows]),
           np.stack([[k.p0 for k in w] for w in windows]),
           np.ones((len(windows), len(windows[0])), np.float32))
    return lambda: runner._fetch(*runner._batch_step(
        *(runner._t(a) for a in inp), 1024))


def profile_window(runner, step):
    """One more window step (`window_step`), twice: under the CUDA sync
    debug mode, which warns at every call that makes the host wait for the
    card (the explicit reads included), and under torch.profiler: kernels
    launched, device busy time, wall time. Each run reports its rounds
    (`sync_rounds`, `rounds`) and windows (`windows`)."""
    import warnings
    import torch
    from torch.profiler import profile, ProfilerActivity
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            step()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    sync_rounds = runner.window_log[-1]["rounds"]
    root = os.path.dirname(os.path.abspath(__file__))
    sources = {}
    for w in caught:
        if "synchroniz" in str(w.message):
            at = f"{os.path.relpath(w.filename, root)}:{w.lineno}"
            sources[at] = sources.get(at, 0) + 1
    torch.cuda.synchronize()
    # device activity alone: with the host's ops recorded too, a
    # profiled batch's trace took over half a minute to process
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches, busy_us = 0, 0.0
    for e in prof.key_averages():
        if str(e.device_type).endswith("CUDA"):
            launches += e.count
            dev = getattr(e, "self_device_time_total", None)
            busy_us += dev if dev is not None else getattr(
                e, "self_cuda_time_total", 0)
    rounds = runner.window_log[-1]["rounds"]
    return dict(windows=runner.window_log[-1].get("Nw", 1), rounds=rounds,
                sync_rounds=sync_rounds,
                host_syncs=sum(sources.values()),
                sync_sources=dict(sorted(sources.items(),
                                         key=lambda kv: -kv[1])[:12]),
                explicit_reads=runner.window_log[-1]["syncs"] + 1,
                kernel_launches=launches, launches_per_round=launches / rounds,
                profiled_ms=1e3 * wall, device_busy_ms=busy_us / 1e3,
                device_busy_share=busy_us / 1e6 / wall)


def gba_snapshot(runner):
    """What the bitwise comparison of two GBA runs reads: every edge and
    submap."""
    return ([(e.id_a, e.id_b, e.ord_a, e.ord_b, e.R.tobytes(), e.t.tobytes(),
              e.v6.tobytes()) for e in runner.edges1 + runner.edges2],
            [(s.scan_id, s.R0.tobytes(), s.p0.tobytes(), s.cloud.tobytes(),
              s.mask.tobytes()) for s in runner.submaps])


def consecutive_error(pairs, truth):
    """Mean |relative position - truth| over (ord_a, ord_b, R_a^T dp) of
    consecutive keyframes; truth holds the true (R, p) of each."""
    import numpy as np
    return float(np.mean([
        np.linalg.norm(t - truth[a][0].T @ (truth[b][1] - truth[a][1]))
        for a, b, t in pairs if b == a + 1]))


def gba_summary(r, kfs, truth):
    """What phase gba_window reports of one run_gba result, and its
    checks."""
    import numpy as np
    runner = r["runner"]
    g = runner.cfg.gba
    n_win = r["n_windows"]
    log = runner.window_log[:r["n_steps"]]
    wins = [o for o in r["outs"] if o.get("r0") is not None]
    tot = r["total"]
    e_in = consecutive_error([(a.scan_id, b.scan_id, a.R0.T @ (b.p0 - a.p0))
                              for a, b in zip(kfs[:-1], kfs[1:])], truth)
    e_out = consecutive_error([(e.ord_a, e.ord_b, e.t)
                               for e in runner.edges1], truth)
    edges = runner.edges1 + runner.edges2
    out = dict(
        keyframes=len(kfs), windows=n_win,
        ms_per_window=1e3 * r["stream_s"] / n_win, call_ms=r["call_ms"],
        rounds=[w["rounds"] for w in log], phases=[w["phases"] for w in log],
        explicit_host_reads_per_window=r["stream_syncs"] / n_win,
        window_r0=[w["r0"] for w in wins], window_r1=[w["r1"] for w in wins],
        edges1=len(runner.edges1), edges2=len(runner.edges2),
        submaps=len(runner.submaps), total_ba=tot, total_ba_s=r["total_s"],
        total_ba_rounds=runner.window_log[r["n_steps"]]["rounds"],
        rel_err_in_m=e_in, rel_err_out_m=e_out,
        peak_mem_bytes=r["peak_bytes"])
    checks = dict(
        windows=n_win == (len(kfs) - g.win_size) // g.stride + 1
        == len(wins) == len(runner.submaps),
        finite=all(np.isfinite(e.t).all() and np.isfinite(e.R).all()
                   for e in edges),
        r1_below_r0_every_window=all(w["r1"] < w["r0"] for w in wins)
        and tot is not None and tot["r1"] < tot["r0"],
        rel_pose_error_below_half_input=e_out < 0.5 * e_in)
    return out, checks


def fleet_diff(a, b):
    """The largest differences between two runners' bottom-up edges and
    submaps, and whether they hold tests/test_dist_gba.py:55-62's
    tolerances (edge R 2e-4, t 2e-3, v6 rtol 0.3; submap first position
    2e-3, occupied cells within 32), pair for pair in order."""
    import numpy as np
    same = ([(e.id_a, e.id_b, e.ord_a, e.ord_b) for e in a.edges1]
            == [(e.id_a, e.id_b, e.ord_a, e.ord_b) for e in b.edges1]
            and [m.scan_id for m in a.submaps] == [m.scan_id
                                                   for m in b.submaps])
    if not (same and a.edges1 and a.submaps):
        return dict(same_records=False, within_tolerance=False)
    dR = max(float(np.abs(e.R - f.R).max()) for e, f in zip(a.edges1,
                                                           b.edges1))
    dt = max(float(np.abs(e.t - f.t).max()) for e, f in zip(a.edges1,
                                                           b.edges1))
    v6 = max(float((np.abs(e.v6 - f.v6) / np.abs(f.v6)).max())
             for e, f in zip(a.edges1, b.edges1))
    dp = max(float(np.abs(m.p0 - n.p0).max()) for m, n in zip(a.submaps,
                                                             b.submaps))
    dm = max(abs(float(m.mask.sum()) - float(n.mask.sum()))
             for m, n in zip(a.submaps, b.submaps))
    return dict(same_records=True, edges=len(a.edges1),
                submaps=len(a.submaps), max_dR=dR, max_dt_m=dt,
                max_v6_rel=v6, max_submap_dp0_m=dp, max_submap_cells=dm,
                submap_clouds_bitwise_equal=all(
                    np.array_equal(m.cloud, n.cloud)
                    and np.array_equal(m.mask, n.mask)
                    for m, n in zip(a.submaps, b.submaps)),
                within_tolerance=bool(dR <= 2e-4 and dt <= 2e-3
                                      and v6 <= 0.3 and dp <= 2e-3
                                      and dm < 32))


def fleet_summary(r):
    """What phase gba_window reports of one batched run_gba result."""
    runner = r["runner"]
    log = runner.window_log[:r["n_steps"]]
    return dict(
        fleet_batch=runner._fleet_batch, windows=r["n_windows"],
        batches=len(log), windows_per_batch=[w["Nw"] for w in log],
        ms_per_window=1e3 * r["stream_s"] / r["n_windows"],
        call_ms=r["call_ms"], rounds_per_batch=[w["rounds"] for w in log],
        explicit_host_reads_per_batch=r["stream_syncs"] / len(log),
        peak_mem_bytes=r["peak_bytes"])


def nccl_fleet(kfs, fleet_batch):
    """The fleet through a 1-rank NCCL process group (127.0.0.1, a free
    port), so the gather runs on the card: NCCL cannot put two ranks on
    one card, so the one rank runs every window. Returns (the run_gba
    result, the group's description); the group is torn down and the
    environment restored."""
    import socket
    import torch.distributed as dist
    from voxelslam_tpu_torch.parallel import multihost as mh
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = dict(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), RANK="0",
               WORLD_SIZE="1", LOCAL_RANK="0")
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        mh.ensure_distributed()
        mesh = mh.global_win_mesh(min_devices=1)
        group = dict(backend=dist.get_backend(), mesh_size=mesh.size,
                     device=str(mesh.device), has_group=mesh.group is not None)
        r = run_gba(kfs, mesh, fleet_batch, total=False)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return r, group


def gba_phase(smi_line):
    """Phase gba_window: tests/test_gba.py's keyframes through the global
    BA as a user runs it (times, one profiled window, accuracy), then
    bench_gba.py's corridor keyframes twice under deterministic algorithms
    (times, one profiled window, bitwise equality); then the scene's
    windows batched at fleet_batch 1, 2 and 4 on the one-card mesh as a
    user runs them (times, one profiled batch each), and again under
    deterministic algorithms, where their edges and submaps are held to
    the single-window run's; the corridor at fleet_batch 2 twice under
    deterministic algorithms (bitwise) and once more through a 1-rank
    NCCL group (bitwise equal to those); fails the run on any check.

    The batched runs are held to the single-window run under
    deterministic algorithms only: as a user runs it, the map's scatter
    adds on the card sum in no fixed order, and a near-zero Hessian entry
    (v6 = 1/|H_ij|) then parts between any two runs, batched or not, by
    more than tests/test_dist_gba.py's rtol of 0.3 (reported, unchecked,
    as `against_single_window_as_a_user_runs_it`).

    The corridor has no structure along its axis (x), so a keyframe's x is
    fixed by nothing there: the window BA of the JAX package on these very
    keyframes (on the CPU, `tools/gba_corridor_check.py`) drifts by metres
    in x and ends above its first residual. Its residuals and errors are
    reported, and the accuracy checks of tests/test_gba.py:85 are held on
    that test's own scene."""
    import torch
    from voxelslam_tpu_torch.parallel.multihost import global_win_mesh
    steps, t_step = {}, [time.perf_counter()]

    def lap(name):                  # wall seconds of the phase's steps
        now = time.perf_counter()
        steps[name] = steps.get(name, 0.0) + now - t_step[0]
        t_step[0] = now
    scene, s_truth = scene_keyframes(GBA_KF, GBA_P)
    corridor, c_truth = corridor_keyframes(CORRIDOR_KF, GBA_P)
    lap("keyframes")
    sc = run_gba(scene)
    lap("scene")
    g = sc["runner"].cfg.gba
    W = g.win_size
    s_prof = profile_window(sc["runner"], window_step(sc["runner"],
                                                      [scene[:W]]))
    lap("profiles")
    torch.use_deterministic_algorithms(True)
    det = [run_gba(corridor), run_gba(corridor)]
    lap("corridor")
    c_prof = profile_window(det[0]["runner"], window_step(det[0]["runner"],
                                                          [corridor[:W]]))
    torch.use_deterministic_algorithms(False)
    lap("profiles")
    # the scene's windows batched on the one-card mesh, as a user runs
    # them, then under deterministic algorithms against the single window
    mesh = global_win_mesh(min_devices=1)
    wins = [scene[i:i + W] for i in range(0, len(scene) - W + 1, g.stride)]
    fleet = {}
    for fb in FLEET_BATCHES:
        fr = run_gba(scene, mesh, fb, total=False)
        lap("fleet")
        fleet[str(fb)] = dict(
            fleet_summary(fr), batch_profile=profile_window(
                fr["runner"], window_step(fr["runner"], wins[:fb])),
            against_single_window_as_a_user_runs_it=fleet_diff(
                fr["runner"], sc["runner"]))
        del fr
        lap("profiles")
    torch.use_deterministic_algorithms(True)
    s_det = run_gba(scene)
    for fb in FLEET_BATCHES:
        fr = run_gba(scene, mesh, fb, total=False)
        fleet[str(fb)]["deterministic"] = dict(
            ms_per_window=1e3 * fr["stream_s"] / fr["n_windows"],
            rounds_per_batch=[w["rounds"] for w in
                              fr["runner"].window_log[:fr["n_steps"]]],
            against_single_window=fleet_diff(fr["runner"], s_det["runner"]))
        del fr
    lap("fleet_deterministic")
    cdet = [run_gba(corridor, mesh, 2, total=False),
            run_gba(corridor, mesh, 2, total=False)]
    lap("corridor_fleet")
    nccl, group = nccl_fleet(corridor, 2)
    torch.use_deterministic_algorithms(False)
    lap("nccl")
    s_out, s_checks = gba_summary(sc, scene, s_truth)
    c_out, c_checks = gba_summary(det[0], corridor, c_truth)
    checks = {
        "scene_windows": s_checks["windows"], "scene_finite": s_checks["finite"],
        "scene_r1_below_r0_every_window":
            s_checks["r1_below_r0_every_window"],
        "scene_rel_pose_error_below_half_input":
            s_checks["rel_pose_error_below_half_input"],
        "corridor_windows": c_checks["windows"],
        "corridor_finite": c_checks["finite"],
        "corridor_two_runs_bitwise_equal":
            gba_snapshot(det[0]["runner"]) == gba_snapshot(det[1]["runner"]),
        "corridor_fleet_batch_2_two_runs_bitwise_equal":
            gba_snapshot(cdet[0]["runner"])
            == gba_snapshot(cdet[1]["runner"]),
        "nccl_one_rank_group": group["backend"] == "nccl"
        and group["has_group"] and group["mesh_size"] == 1,
        "nccl_fleet_bitwise_equal_to_fleet_batch_2":
            gba_snapshot(nccl["runner"]) == gba_snapshot(cdet[0]["runner"]),
    }
    for fb, f in fleet.items():
        checks[f"scene_fleet_batch_{fb}_windows"] = (
            f["windows"] == s_out["windows"])
        checks[f"scene_fleet_batch_{fb}_matches_single_window"] = (
            f["deterministic"]["against_single_window"]["within_tolerance"])
    emit("gba_window", nvidia_smi=smi_line,
         config="SlamSystem's HbaRunner widths: kf_point_max 8192, capacity "
                "8192, unique_max 4096, factor_max 1024 (total BA 2048), "
                "GBAConfig()", points=GBA_P,
         scene=dict(s_out, source="tests/test_gba.py make_keyframes",
                    deterministic_algorithms=False, window_profile=s_prof),
         corridor=dict(c_out, source="bench_gba.py make_keyframes",
                       deterministic_algorithms=True,
                       run2_ms_per_window=1e3 * det[1]["stream_s"]
                       / det[1]["n_windows"], window_profile=c_prof,
                       fleet_batch_2_ms_per_window=[
                           1e3 * r["stream_s"] / r["n_windows"]
                           for r in cdet + [nccl]],
                       unchecked={k: c_checks[k] for k in (
                           "r1_below_r0_every_window",
                           "rel_pose_error_below_half_input")}),
         fleet=dict(fleet, mesh="global_win_mesh(min_devices=1): one card, "
                    "no process group", windows_from="the scene's stream",
                    single_window_deterministic_ms_per_window=1e3
                    * s_det["stream_s"] / s_det["n_windows"]),
         nccl=group, step_seconds=steps, checks=checks)
    if not all(checks.values()):
        fail(f"gba_window checks failed: {checks}")


LOOP_STAGES = ("merge", "extract", "db_search", "verify", "icp", "optimize",
               "apply_correction", "keyframe_reload", "gba_window",
               "total_ba", "top_down")


@contextlib.contextmanager
def stage_timers(times):
    """While active, every call of a loop stage is clocked on the host with
    a device synchronise before and after; times[stage] lists seconds."""
    import torch
    from voxelslam_tpu_torch.gba import hba
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
                "keyframe_reload"),
               (hba.HbaRunner, "_window_step", "gba_window"),
               (hba.HbaRunner, "total_ba", "total_ba"),
               (hba.HbaRunner, "top_down", "top_down")]
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
    loop pipeline has written them back), the loop edges, the GBA's edges
    and submaps so far and the scans that applied a correction."""
    import numpy as np
    poses = sysm.odom.scan_poses
    return dict(
        n=len(xs), x=np.stack(xs),
        rot=np.array([sp.R for sp in poses]).reshape(-1, 3, 3),
        pos=np.array([sp.p for sp in poses]).reshape(-1, 3),
        edges=[(e.id_a, e.id_b, e.ord_a, e.ord_b, e.R.tobytes(),
                e.t.tobytes()) for e in sysm.loop.lp_edges],
        gba=gba_snapshot(sysm.gba), corr_ks=list(corr_ks))


def run_system(cfg, packets, gt, stop=None, tail=None, times=None,
               traj=None, savepath=None):
    """Drive SlamSystem.process_scan (loop closure and GBA on) over the
    packets, or the first `stop` of them; with `times`, clock the loop
    stages and every call. The returned `snap` is taken after the last
    scan, or `tail` scans past the first correction when `tail` is set.
    With `traj` (the ground truth) the run ends with finish(), and the
    position errors of the scans of the sessions linked to session 0 are
    taken before and after it."""
    import numpy as np
    import torch
    from voxelslam_tpu_torch.ops import moments as mo
    from voxelslam_tpu_torch.pipeline.system import SlamSystem

    n = len(packets) if stop is None else stop
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with (stage_timers(times) if times is not None
          else contextlib.nullcontext()):
        sysm = SlamSystem(cfg, enable_loop=True, enable_gba=True,
                          savepath=savepath, device="cuda")
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
        if snap is None:
            snap = _snapshot(sysm, xs, corr_ks)
        fin = finish_system(sysm, traj) if traj is not None else None
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
        snap=snap,
        n_keyframes=sum(len(s) for s in lp.keyframes),
        keyframes_per_session=[len(s) for s in lp.keyframes],
        run_s=run_s, steady_ms=1e3 * float(np.mean(steady)) if steady else None,
        steady_ms_median=(1e3 * float(np.median(steady)) if steady
                          else None),
        keyframe_scan_ms=1e3 * float(np.mean(keyed)) if keyed else None,
        other_scan_ms=1e3 * float(np.mean(other)) if other else None,
        n_other=len(other),
        n_steady_timed=len(steady), n_keyframe_scans=len(keyed),
        peak_bytes=torch.cuda.max_memory_allocated(), finish=fin,
        sysm=sysm if traj is not None else None,
        gba=dict(windows=len(sysm.gba.window_log),
                 rounds=[w["rounds"] for w in sysm.gba.window_log],
                 edges1=len(sysm.gba.edges1), edges2=len(sysm.gba.edges2),
                 submaps=len(sysm.gba.submaps),
                 host_reads=sysm.gba.host_syncs))


def finish_system(sysm, traj):
    """finish() with synchronised clocks, and the position error against
    the ground truth of every scan of the sessions linked to session 0,
    emitted before finish(), before and after it (top-down writes the
    same ScanPose objects back)."""
    import numpy as np
    import torch
    lp = sysm.loop
    linked = _elevator().linked_to_0(lp.lp_edges)
    sps = [sp for s in linked for sp in lp.scan_poses[s]]
    truth = np.stack([traj.state_at(sp.t)[1] for sp in sps])
    before = np.linalg.norm(np.stack([sp.p for sp in sps]) - truth, axis=1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sysm.finish()
    torch.cuda.synchronize()
    finish_s = time.perf_counter() - t0
    after = np.linalg.norm(np.stack([sp.p for sp in sps]) - truth, axis=1)
    return dict(finish_s=finish_s, linked_sessions=linked, scans=len(sps),
                err_before_mean_m=float(before.mean()),
                err_before_max_m=float(before.max()),
                err_after_mean_m=float(after.mean()),
                err_after_max_m=float(after.max()))


def same_snapshot(a, b):
    """Bitwise equality of two runs' snapshots (see `_snapshot`)."""
    import numpy as np
    return (a["n"] == b["n"] and np.array_equal(a["x"], b["x"])
            and np.array_equal(a["rot"], b["rot"])
            and np.array_equal(a["pos"], b["pos"])
            and a["edges"] == b["edges"] and a["gba"] == b["gba"]
            and a["corr_ks"] == b["corr_ks"])


def sessions_phase(sysm, cfg):
    """Phase sessions: save() the system's last session under a temporary
    savepath inside build/, reload it into a new system; fails the run on
    any check."""
    import numpy as np
    import torch
    from voxelslam_tpu_torch.io import sessions as ses
    from voxelslam_tpu_torch.loop import btc
    from voxelslam_tpu_torch.pipeline.system import SlamSystem
    name = "elevator_last"
    sps = sysm.loop.scan_poses[sysm.loop.cur_session]
    t0 = time.perf_counter()
    sysm.save(name)
    save_s = time.perf_counter() - t0
    back = ses.read_lidarstate(os.path.join(sysm.savepath, name,
                                            "alidarState.txt"))
    # the file's precision: 6 decimals of t, 7 of p and of the quaternion;
    # the quaternion is of the rotation nearest the stored R, a product of
    # f32 rotations that is off SO(3) by up to about 1e-5
    drift = {k: max((float(np.abs(np.asarray(getattr(a, k))
                                - np.asarray(getattr(b, k))).max())
                     for a, b in zip(back, sps)), default=0.0)
             for k in ("t", "p", "R")}
    reads_back = (len(back) == len(sps) and drift["t"] <= 1e-6
                  and drift["p"] <= 1e-6 and drift["R"] <= 5e-5)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    re = SlamSystem(cfg, enable_loop=True, previous_maps=[name],
                    savepath=sysm.savepath, device="cuda")
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    kfs = re.loop.keyframes[0]
    W = cfg.lba.win_size
    cands = []
    if kfs:
        kf = kfs[0]
        dev = re.loop.device
        desc = btc.extract(torch.as_tensor(kf.cloud, device=dev),
                           torch.as_tensor(kf.mask, device=dev),
                           re.loop.btc_cfg)
        cands = re.loop.dbs[0].search(
            {k: v.cpu().numpy() for k, v in desc.items()}, skip_near=-1,
            current_frame=1 << 30)
    checks = {
        "keyframes_floor_scans_over_win": len(kfs) == len(sps) // W >= 1,
        "reloaded_keyframe_btc_candidate": bool(cands),
        "alidarstate_reads_back": reads_back,
        "live_session_after_reload": re.loop.cur_session == 1
        and re.session_names == [name, "live1"],
    }
    emit("sessions", session=sysm.loop.cur_session, scans=len(sps),
         keyframes=len(kfs), db_frames=len(re.loop.dbs[0].frames),
         candidates=len(cands), save_s=save_s, reload_s=load_s,
         readback_max_dev=drift, checks=checks)
    if not all(checks.values()):
        fail(f"sessions checks failed: {checks}")


def system_phase(smi_line):
    """Phase 5: the full system with loop closure and GBA over the
    elevator scenario, twice, and phase 6 on the first run; fails the run
    on any check."""
    import tempfile
    import torch
    from voxelslam_tpu_torch.io import simulator
    torch.use_deterministic_algorithms(True)
    cfg = system_config()
    t0 = time.perf_counter()
    packets, gt = elevator_packets()
    traj = _elevator().elevator_trajectory(simulator)
    gen_s = time.perf_counter() - t0
    times = {}
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build, exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="smoke_sessions_",
                                     dir=build) as savepath:
        r = run_system(cfg, packets, gt, tail=SYS_TAIL, times=times,
                       traj=traj, savepath=savepath)
        sessions_phase(r.pop("sysm"), cfg)
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
        "top_down_ran": len(times.get("top_down", [])) == 1,
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
         gba=r["gba"], finish=r["finish"], second_run_scans=r2["n"],
         run2_s=r2["run_s"], run2_gba=r2["gba"], checks=checks)
    if not all(checks.values()):
        fail(f"system checks failed: {checks}")
    return r["launches"]


def write_hesai_dataset(d, n_scans, n_az, n_el):
    """Phase slice's box room and trajectory as a recorded dataset in the
    layout of `voxelslam_tpu_torch.cli` (scans at 10 Hz from t = 0.1 s):
    a 200 Hz `imu.txt`, `scans.txt`, and one structured .npy a scan with
    the Hesai fields x y z (f4), intensity (f4), absolute timestamp (f8)
    and ring (u2). The simulator's points are in the IMU frame; they are
    written in the LiDAR frame through the hesai preset's extrinsic,
    p_lidar = R_ext^T (p_imu - t_ext). Returns (trajectory, hit rays per
    scan)."""
    import numpy as np
    from voxelslam_tpu_torch.config import preset
    from voxelslam_tpu_torch.io import simulator as sim
    cfg = preset("hesai")
    R_ext = np.asarray(cfg.extrinsic_R, np.float64).reshape(3, 3)
    t_ext = np.asarray(cfg.extrinsic_t, np.float64)
    traj = sim.make_trajectory(duration=0.2 + 0.1 * (n_scans + 2), speed=1.2,
                               wobble=0.25, yaw_rate=0.3, ramp=1.2)
    normals, dsp = sim.box_room(half_extent=(14.0, 12.0, 3.5),
                                center=(4.0, 0.0, 1.0))
    dt = np.dtype([("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
                   ("intensity", "<f4"), ("timestamp", "<f8"),
                   ("ring", "<u2")])
    rng = np.random.default_rng(0)
    os.makedirs(d, exist_ok=True)
    rows, hits = [], []
    for k in range(n_scans):
        t = 0.1 + 0.1 * k
        scan = sim.lidar_scan(traj, t, t + 0.1, normals, dsp, n_az=n_az,
                              n_el=n_el, noise=0.01, seed=k)
        hit = scan["hit"]
        rec = np.zeros(int(hit.sum()), dt)
        pts = (scan["points"][hit] - t_ext) @ R_ext
        rec["x"], rec["y"], rec["z"] = pts.T
        rec["intensity"] = rng.uniform(0, 255, len(rec))
        rec["timestamp"] = t + scan["offsets"][hit]
        rec["ring"] = (np.arange(n_az * n_el) % n_el)[hit]
        name = f"scan_{k:06d}.npy"
        np.save(os.path.join(d, name), rec)
        rows.append(f"{t:.9f} {t + 0.1:.9f} {name}\n")
        hits.append(len(rec))
    with open(os.path.join(d, "scans.txt"), "w") as f:
        f.writelines(rows)
    ts = np.arange(0.0, 0.1 * (n_scans + 1) + 0.05, 1.0 / 200.0)
    imu = np.array([np.concatenate([[ti], *traj.imu_at(ti)]) for ti in ts])
    np.savetxt(os.path.join(d, "imu.txt"), imu, fmt="%.17g")
    return traj, hits


def same_packets(a, b):
    """iter_dataset packets equal (the native loader gives no intensity)."""
    import numpy as np
    return len(a) == len(b) > 0 and all(
        np.array_equal(p["scan"][k], q["scan"][k])
        for p, q in zip(a, b) for k in ("points", "offsets", "t_beg", "t_end")
    ) and all(np.array_equal(p[k], q[k]) for p, q in zip(a, b)
              for k in ("imu_ts", "imu_gyr", "imu_acc"))


@contextlib.contextmanager
def cli_probes(rec):
    """While active, every `ScanLoader.__next__` call records how long the
    consumer waited in `rec["waits"]`, and every `SlamSystem.process_scan`
    is clocked (device synchronised after it) into `rec["call_s"]`, with
    its phase, whether it made a keyframe, the system, the steady calls
    and the moments launches so far kept in `rec`."""
    import torch
    from voxelslam_tpu_torch import native
    from voxelslam_tpu_torch.ops import moments as mo
    from voxelslam_tpu_torch.pipeline.system import SlamSystem
    real_next, real_scan = native.ScanLoader.__next__, SlamSystem.process_scan

    def timed_next(self):
        t0 = time.perf_counter()
        try:
            return real_next(self)
        finally:
            rec["waits"].append(time.perf_counter() - t0)

    def counted_scan(self, *a):
        if "t0" not in rec:
            torch.cuda.synchronize()
            rec["t0"] = time.perf_counter()
        rec["system"] = self
        rec["n_steady"] += int(self.odom.init_done)
        n_kf = sum(len(k) for k in self.loop.keyframes)
        t0 = time.perf_counter()
        out = real_scan(self, *a)
        torch.cuda.synchronize()
        rec["t1"] = time.perf_counter()
        rec["call_s"].append(rec["t1"] - t0)
        rec["keyframe"].append(sum(len(k) for k in self.loop.keyframes)
                               > n_kf)
        rec["launches"] = mo.counter.launches
        rec["phases"].append(out.get("phase"))
        return out
    rec.update(waits=[], n_steady=0, phases=[], call_s=[], keyframe=[])
    native.ScanLoader.__next__ = timed_next
    SlamSystem.process_scan = counted_scan
    try:
        yield rec
    finally:
        native.ScanLoader.__next__ = real_next
        SlamSystem.process_scan = real_scan


def ply_vertices(path):
    """The vertex count a binary xyz PLY's header states, if its size
    matches it; else None."""
    with open(path, "rb") as f:
        data = f.read()
    head, sep, body = data.partition(b"end_header\n")
    n = [int(ln.split()[-1]) for ln in head.split(b"\n")
         if ln.startswith(b"element vertex")]
    ok = (sep and head.startswith(b"ply\n") and len(n) == 1
          and len(body) == 12 * n[0])
    return n[0] if ok else None


def cli_phase(smi_line):
    """Phase cli: `cli.main(["run", ...])` over a recorded Hesai dataset at
    the hesai preset's full width, loop closure and GBA on, on the card;
    then `export` and `info hesai`. Fails the run on any check. Returns
    (the moments launches of the run, the run's packets, its config)."""
    import tempfile
    import numpy as np
    import torch
    from voxelslam_tpu_torch import cli
    from voxelslam_tpu_torch.config import preset
    from voxelslam_tpu_torch.io import sessions as ses
    from voxelslam_tpu_torch.ops import moments as mo
    from voxelslam_tpu_torch.ops.downsample import voxel_downsample
    from voxelslam_tpu_torch.utils.metrics import ate_rmse
    cfg = preset("hesai")
    os.makedirs(OUT, exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="cli_", dir=OUT) as d:
        ds = os.path.join(d, "dataset")
        t0 = time.perf_counter()
        traj, hits = write_hesai_dataset(ds, CLI_SCANS, CLI_AZ, CLI_EL)
        write_s = time.perf_counter() - t0
        # host only: the native loader against the inline path
        t0 = time.perf_counter()
        nat = list(cli.iter_dataset(ds, "hesai"))
        native_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        inline = list(cli.iter_dataset(ds, "hesai", use_native=False))
        inline_s = time.perf_counter() - t0
        save, tum, ply = (os.path.join(d, n) for n in
                          ("maps", "run.tum", "map.ply"))
        argv = ["run", ds, "--preset", "hesai", "--gba", "--save-dir", save,
                "--export-map", ply, "--export-traj", tum]
        lines, rec = [], {}
        mo.counter.reset()
        with cli_probes(rec):
            rc = cli.main(argv, log=lines.append)
        sysm, n = rec["system"], len(rec["phases"])
        kinds = {"steady": [], "keyframe": [], "init": []}
        for s_, ph, kf in zip(rec["call_s"], rec["phases"], rec["keyframe"]):
            kinds["keyframe" if kf else "steady" if ph == "odom"
                  else "init"].append(1e3 * s_)
        down = [int(voxel_downsample(
            torch.as_tensor(p["scan"]["points"], device=sysm.device),
            torch.ones(len(p["scan"]["points"]), device=sysm.device),
            cfg.odom.down_size, 1 << 14)[1].sum()) for p in nat]
        rows = np.loadtxt(tum, ndmin=2)
        gt = np.stack([traj.state_at(t)[1] for t in rows[:, 0]])
        ate = float(ate_rmse(rows[:, 1:4], gt))
        sid = sysm.loop.cur_session
        back = ses.load_session(os.path.join(save, sysm.session_names[-1]))
        n_ply = ply_vertices(ply)
        exp_lines = []
        tum2, ply2 = os.path.join(d, "export.tum"), os.path.join(d, "e.ply")
        rc_export = cli.main(["export", os.path.join(save,
                                                     sysm.session_names[-1]),
                              "--export-traj", tum2, "--export-map", ply2],
                             log=exp_lines.append)
        info = []
        rc_info = cli.main(["info", "hesai"], log=info.append)
        info_cfg = json.loads("\n".join(info))
        checks = {
            "rc_0": rc == 0, "ate_below_limit": ate < ATE_LIMIT,
            "one_launch_per_steady_or_refill_scan":
                rec["launches"] == rec["n_steady"] > 0,
            "session_reloads": len(back) == len(sysm.loop.scan_poses[sid])
            > 0,
            "ply_header_parses": bool(n_ply),
            "native_loader_equals_inline_path": same_packets(nat, inline),
            "scans_all_processed": n == len(nat) == CLI_SCANS,
            "export_rc_0_and_trajectory_rows": rc_export == 0
            and len(np.loadtxt(tum2, ndmin=2)) == len(back)
            and bool(ply_vertices(ply2)),
            "info_hesai": rc_info == 0 and info_cfg["lidar_type"] == "hesai",
        }
        emit("cli", nvidia_smi=smi_line, argv=argv[2:],
             config="hesai preset, SlamConfig default widths",
             scans=n, steady_calls=rec["n_steady"],
             phases=[(k, p) for k, p in enumerate(rec["phases"])
                     if p != "odom"],
             raw_points_per_scan=[min(hits), max(hits)],
             decoded_points_per_scan=[min(len(p["scan"]["points"])
                                          for p in nat),
                                      max(len(p["scan"]["points"])
                                          for p in nat)],
             downsampled_points_per_scan=[min(down), max(down)],
             point_max=cfg.odom.point_max, dataset_write_s=write_s,
             scans_per_s=n / (rec["t1"] - rec["t0"]),
             run_s=rec["t1"] - rec["t0"],
             ms_per_scan={k: dict(n=len(v), mean=float(np.mean(v)),
                                  median=float(np.median(v)))
                          for k, v in kinds.items() if v},
             loader_wait_ms_per_scan=1e3 * float(np.mean(rec["waits"])),
             loader_wait_ms_max=1e3 * float(np.max(rec["waits"])),
             loader_alone_ms_per_scan=1e3 * native_s / len(nat),
             host_decode_ms_per_scan=1e3 * inline_s / len(inline),
             keyframes=sum(len(k) for k in sysm.loop.keyframes),
             gba_windows=len(sysm.gba.window_log),
             corrections=sysm.corrections, final_session=sid,
             ate_m=ate, ate_limit_m=ATE_LIMIT, kernel_launches=rec["launches"],
             ply_vertices=n_ply, session_scans=len(back), log=lines,
             export_log=exp_lines, checks=checks)
    if not all(checks.values()):
        fail(f"cli checks failed: {checks}")
    packets = [(p["scan"]["points"], p["scan"]["offsets"], p["imu_ts"],
                p["imu_gyr"], p["imu_acc"], p["scan"]["t_beg"],
                p["scan"]["t_end"]) for p in nat]
    return rec["launches"], packets, cfg


def _continue(sysm, packets):
    """process_scan over the packets; (positions, rotations) after each,
    and the number of steady calls."""
    import numpy as np
    ps, Rs, n_steady = [], [], 0
    for pkt in packets:
        n_steady += int(sysm.odom.init_done)
        sysm.process_scan(*pkt)
        ps.append(sysm.odom.x.p.cpu().numpy())
        Rs.append(sysm.odom.x.R.cpu().numpy())
    return np.stack(ps), np.stack(Rs), n_steady


def _gba_state(sysm):
    return (len(sysm.gba.window_log), len(sysm.gba.edges1),
            len(sysm.gba.submaps), sysm.corrections, len(sysm.scan_poses))


def checkpoint_phase(packets, cfg):
    """Phase checkpoint: SlamSystem on phase cli's packets at its config
    (loop closure and GBA on, deterministic algorithms), saved at the
    first scan after a keyframe that dispatched a GBA window, continued
    CKPT_TAIL scans; a fresh system on the card loads the file and
    continues the same scans bitwise equal, and one on the CPU within
    POSE_TOL. Fails the run on any check. Returns the moments launches."""
    import tempfile
    import numpy as np
    import torch
    from voxelslam_tpu_torch.ops import moments as mo
    from voxelslam_tpu_torch.pipeline.system import SlamSystem
    torch.use_deterministic_algorithms(True)
    sys1 = SlamSystem(cfg, enable_loop=True, enable_gba=True, device="cuda")
    mo.counter.reset()
    n_steady, k, dispatched = 0, 0, False
    while k + CKPT_TAIL < len(packets):
        windows = len(sys1.gba.window_log)
        n_steady += int(sys1.odom.init_done)
        sys1.process_scan(*packets[k])
        k += 1
        if dispatched:
            break
        dispatched = len(sys1.gba.window_log) > windows
    if not dispatched:
        fail("checkpoint: no GBA window dispatched before the tail")
    in_flight = dict(
        save_after_scan=k, gba_window_in_flight=sys1.gba._inflight_step
        is not None, gba_condense_in_flight=sys1.gba._inflight_cond
        is not None, keyframe_scans_accumulated=len(sys1.loop._bl_local),
        odom_pending_emission=sys1.odom._pending is not None,
        odom_scan_queue=len(sys1.odom._scan_queue),
        odom_win_count=sys1.odom.win_count)
    os.makedirs(OUT, exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="ckpt_", dir=OUT) as d:
        path = os.path.join(d, "live.ckpt")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sys1.save_checkpoint(path)
        save_s = time.perf_counter() - t0
        nbytes = os.path.getsize(path)
        tail = packets[k:k + CKPT_TAIL]
        *ref, n1 = _continue(sys1, tail)
        launches = mo.counter.launches
        sys2 = SlamSystem(cfg, enable_loop=True, enable_gba=True,
                          device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sys2.load_checkpoint(path)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        mo.counter.reset()
        *got, n2 = _continue(sys2, tail)
        launches2 = mo.counter.launches
        cpu = SlamSystem(cfg, enable_loop=True, enable_gba=True, device="cpu")
        t0 = time.perf_counter()
        cpu.load_checkpoint(path)
        cpu_load_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        *on_cpu, _ = _continue(cpu, tail)
        cpu_s = time.perf_counter() - t0
    torch.use_deterministic_algorithms(False)
    cpu_dev = [float(np.abs(a - b).max()) for a, b in zip(on_cpu, ref)]
    checks = {
        "window_in_flight_at_save": in_flight["gba_window_in_flight"],
        "restored_bitwise_equal": bool(np.array_equal(ref[0], got[0])
                                       and np.array_equal(ref[1], got[1])),
        "same_windows_edges_submaps_corrections":
            _gba_state(sys1) == _gba_state(sys2),
        "cpu_restore_within_pose_tol": max(cpu_dev) <= POSE_TOL,
        "one_launch_per_steady_scan": launches == n_steady + n1 > 0
        and launches2 == n2 == n1,
    }
    emit("checkpoint", config="phase cli's packets and config, "
         "deterministic algorithms", in_flight=in_flight, tail=CKPT_TAIL,
         save_s=save_s, load_s=load_s, file_bytes=nbytes,
         cpu_load_s=cpu_load_s, cpu_tail_s=cpu_s,
         cpu_max_dev=dict(p=cpu_dev[0], R=cpu_dev[1]), pose_tol=POSE_TOL,
         windows_edges_submaps_corrections_poses=_gba_state(sys1),
         kernel_launches=launches + launches2,
         steady_calls=n_steady + n1 + n2, checks=checks)
    if not all(checks.values()):
        fail(f"checkpoint checks failed: {checks}")
    return launches + launches2


def main():
    import numpy as np
    import torch
    t_start = time.perf_counter()
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

    # 2. build: nvcc and two g++ side by side
    from concurrent.futures import ThreadPoolExecutor
    from voxelslam_tpu_torch import native
    t0 = time.perf_counter()
    with ThreadPoolExecutor(3) as pool:
        builds = [pool.submit(mo.build), pool.submit(native.build, "btcdb"),
                  pool.submit(native.build, "ingest")]
        lib, store, ingest = [f.result() for f in builds]
    mo._library()
    native.library("btcdb")
    native.library("ingest")
    emit("build", seconds=round(time.perf_counter() - t0, 3), library=lib.name,
         descriptor_store=store.name, ingest_loader=ingest.name)

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

    # the main path's runs, each counted from 0: the slice, mgsize = 2,
    # the full system (GBA launches no moments kernel), the command line
    # and the checkpoint's runs
    seconds = {"to_system": time.perf_counter() - t_start}
    t0 = time.perf_counter()
    launches = {"slice": r["launches"], "system": system_phase(smi_line)}
    seconds["system_and_sessions"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    launches["slice_mg2"] = slice_mg2_phase(cfg, traj, packets)
    seconds["slice_mg2"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    gba_phase(smi_line)
    seconds["gba_window"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    launches["cli"], cli_packets, cli_cfg = cli_phase(smi_line)
    seconds["cli"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    launches["checkpoint"] = checkpoint_phase(cli_packets, cli_cfg)
    seconds["checkpoint"] = time.perf_counter() - t0
    seconds["total"] = time.perf_counter() - t_start
    emit("timing", seconds=seconds)

    # kernels line
    print(json.dumps({"kernels": [{
        "name": "accumulate", "route": "cuda",
        "source": "voxelslam_tpu_torch/csrc/moments.cu",
        "replaces": "voxelslam_tpu/ops/moments.py:103",
        "launches": sum(launches.values()), "launches_by_path": launches,
        "max_abs_err": max(errs),
        "ms": tm["ms"], "plain_ms": tm["plain_ms"],
        "bound_ms": tm["bound_ms"], "bound_by": "bytes",
        "library_ms": tm["library_ms"], "cold_ms": tm["cold_ms"],
        "bound_share": tm["bound_ms"] / tm["ms"]}]}), flush=True)

    # last line
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
