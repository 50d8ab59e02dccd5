#!/usr/bin/env python3
"""Where the time of the PyTorch port's steady scan step goes, on one GPU,
graphed (`SlamPipeline(step_graphs=True)`, the default: one CUDA graph
replay a dispatch) and eager (`step_graphs=False`) side by side.

Run from the repository root:  python3 tools/profile_torch_slice.py

Drives `SlamPipeline.process_scan` of `voxelslam_tpu_torch` at bench.py's
configuration and scene (the same as chip_smoke.py) through init and a
warm-up, once each way, then measures the steady scans:

  1. wall clock per scan (synchronised), no instrumentation, both ways;
  2. eager, per stage of `_steady_megastep`: each stage function wrapped
     in synchronise + host clock (the sum exceeds 1. by the added syncs);
  3. torch.profiler over a few steady scans, both ways: device busy share
     (sum of kernel time over wall time; one stream, so kernels do not
     overlap), kernel launches, host calls into the CUDA runtime that
     launch work (kernels, graphs, copies) per scan, the kernels that take
     the most device time; eager, with each stage a profiler range, the
     device time of each stage's kernels: a graph replays those same
     kernels, so that is the graphed scan's per-stage picture;
  4. graphed: the device time of one replay of the step graph (CUDA
     events), and the graph's capture seconds.

Then, on the moments kernel (`csrc/moments.cu`) alone:

  5. its device time per call in the eager trace of 3., beside its time by
     CUDA events (chip_smoke.time_ms: warm L2, queue full; and
     chip_smoke.cold_ms: L2 flushed between calls) on the inputs of a
     steady scan's insert, captured in one more dispatch after 3.

Prints one JSON object and writes it to chiprun_out/profile_slice.json.
Needs a GPU; exits non-zero without one.
"""

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
N_WARM, N_STEADY, N_PROF = 22, 24, 8


def moments_kernel(kernels, capture):
    """4.: the kernel's profiled device time per call against its event
    times on the captured inputs (microseconds)."""
    import torch
    import chip_smoke as cs
    from voxelslam_tpu_torch.ops import moments as mo
    slots, upds, caps = capture
    mine = [k for k in kernels if "accumulate_kernel" in k[0]]
    calls = sum(k[1] for k in mine)
    out = torch.empty((sum(caps), mo.CH), device=slots.device)
    flush = torch.empty(cs.FLUSH_BYTES // 4, device=slots.device)
    run = lambda: mo.launch(slots, upds, caps, out)   # noqa: E731
    return {
        "profiled_calls": calls,
        "profiler_us_per_call": sum(k[2] for k in mine) / max(calls, 1),
        "event_us_warm": 1e3 * cs.time_ms(run),
        "event_us_cold": 1e3 * cs.cold_ms(run, flush),
        "slot_stats": cs.slot_stats(slots, upds, caps),
    }


STAGES = [("ekf", "propagate"), ("ekf", "deskew"),
          ("odo", "voxel_downsample"), ("pre", "integrate"),
          ("iekf", "iekf_update"), ("vm", "insert_scan_fused"),
          ("vm", "refresh_planes"), ("vm", "harvest_t"), ("opt", "lm_li"),
          ("vm", "marginalize")]


def _patched(wrap):
    """Replace each stage function of the steady step by wrap(name, fn);
    returns the list to restore."""
    from voxelslam_tpu_torch.pipeline import odometry as odo
    mods = {"ekf": odo.ekf, "odo": odo, "pre": odo.pre, "iekf": odo.iekf,
            "vm": odo.vm, "opt": odo.opt}
    saved = [(mods[m], name, getattr(mods[m], name)) for m, name in STAGES]
    for mod, name, fn in saved:
        setattr(mod, name, wrap(name, fn))
    return saved


def _restore(saved):
    for mod, name, fn in saved:
        setattr(mod, name, fn)


def _plain_ms(pipe, packets):
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for pkt in packets:
        pipe.process_scan(*pkt)
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / len(packets)


def _profile(pipe, packets, ranges=False):
    """3.: `chip_smoke.profile_scans` over the packets (a whole number of
    batches); with `ranges`, each stage a profiler range."""
    import chip_smoke as cs
    from torch.profiler import record_function

    def ranged(name, fn):
        def run(*a, **kw):
            with record_function(f"stage:{name}"):
                return fn(*a, **kw)
        return run
    saved = _patched(ranged) if ranges else []
    try:
        summary, kernels = cs.profile_scans(pipe, packets)
    finally:
        _restore(saved)
    return kernels, summary


def main():
    import torch
    if not torch.cuda.is_available():
        sys.exit("profile_torch_slice: needs a GPU")
    import chip_smoke as cs
    from voxelslam_tpu_torch.pipeline import SlamPipeline

    cfg = cs.bench_config()
    K = cfg.odom.batch_scans                   # scans a dispatch
    traj, packets = cs.bench_packets(N_WARM + N_STEADY + N_PROF + K)
    steady = packets[N_WARM:N_WARM + N_STEADY]
    prof_pk = packets[N_WARM + N_STEADY:-K]
    res = {"config": "bench.py", "batch_scans": K,
           "deterministic_algorithms": False}

    # graphed (the default), before any stage function is patched
    pipe = SlamPipeline(cfg, collect_clouds=False)
    for pkt in packets[:N_WARM]:
        pipe.process_scan(*pkt)
    assert pipe.init_done
    g = {"steady_ms_per_scan": _plain_ms(pipe, steady)}
    g.update(_profile(pipe, prof_pk)[1])
    graph = pipe._graphs["steady_k"]
    g["replay_device_ms"] = cs.replay_ms(graph.graph)
    g["capture_s"] = graph.capture_s
    res["graphed"] = g
    del pipe, graph

    # eager: 1., 2. (stage clocks), 3. with stage ranges
    pipe = SlamPipeline(cfg, collect_clouds=False, step_graphs=False)
    for pkt in packets[:N_WARM]:
        pipe.process_scan(*pkt)
    half = N_STEADY // 2
    e = {"steady_ms_per_scan": _plain_ms(pipe, steady[:half])}
    stages = {}

    def clocked(name, fn):
        def run(*a, **kw):
            torch.cuda.synchronize()
            s = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            stages[name] = stages.get(name, 0.0) + time.perf_counter() - s
            return out
        return run
    saved = _patched(clocked)
    e["clocked_ms_per_scan"] = _plain_ms(pipe, steady[half:])
    _restore(saved)
    n_clocked = N_STEADY - half
    e["stage_ms_per_scan"] = {k: 1e3 * v / n_clocked for k, v in sorted(
        stages.items(), key=lambda kv: -kv[1])}
    kernels, prof = _profile(pipe, prof_pk, ranges=True)
    e.update(prof)
    res["eager"] = e
    capture = []
    with cs.capturing(capture):                # one more dispatch
        for pkt in packets[-K:]:
            pipe.process_scan(*pkt)
    pipe.flush()

    res["moments_kernel"] = moments_kernel(kernels, capture)
    res["card"] = cs.subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    res["kind"] = torch.cuda.get_device_name(0)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "profile_slice.json").write_text(json.dumps(res, indent=1))
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
