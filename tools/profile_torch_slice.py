#!/usr/bin/env python3
"""Where the time of the PyTorch port's steady scan step goes, on one GPU,
graphed (`SlamPipeline(step_graphs=True)`, the default: one CUDA graph
replay a dispatch) and eager (`step_graphs=False`) side by side.

Run from the repository root:  python3 tools/profile_torch_slice.py

Drives `SlamPipeline.process_scan` of `voxelslam_tpu_torch` at bench.py's
configuration and scene (the same as chip_smoke.py) through init and a
warm-up, then measures the steady scans:

  1. wall clock per scan (synchronised), no instrumentation: graphed with
     telemetry off, graphed with telemetry on (`utils.telemetry`, enabled
     before the pipeline is built), eager;
  2. graphed, from the program's telemetry over the same scans: the
     device ms of each stage of the steady step (the stage marks the
     "steady_k" graph captured, summed over its K unrolled steps) beside
     the replays' event-timed device ms (the marks must sum to it), the
     host's spans a scan (`odom`, `odom.pack`, `odom.emit`,
     `odom.readback`, `graph:steady_k`), and the program's counters over
     those scans (points dropped past `point_max` and `unique_max`,
     voxels the hash could not place, the emission's window and hold,
     the kernels' launches and bytes);
  3. torch.profiler over a few steady scans, graphed (telemetry on) and
     eager: device busy share (sum of kernel time over wall time; one
     stream, so kernels do not overlap), kernel launches, host calls into
     the CUDA runtime that launch work (kernels, graphs, copies) per scan,
     the kernels that take the most device time; graphed, csrc/
     segment_add.cu's share of its bytes roofline: the bytes its calls
     need (the telemetry counter `kernel.segment_add.bytes`) over the HBM
     peak, over its kernels' profiled time, and every kernel name that
     holds `sum_kernel` or `partition_kernel` (only segment_add.cu's may);
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
import re
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
N_WARM, N_STEADY, N_PROF = 22, 24, 8
HBM_BYTES_PER_S = 3.35e12       # H100 SXM, NVIDIA's data sheet, 700 W
# csrc/segment_add.cu's kernels as the profiler names them (templates in
# the file's anonymous namespace)
SEGMENT_ADD = re.compile(
    r"^(void )?(\(anonymous namespace\)::)?(sum_kernel|partition_kernel)<")
HOST_SPANS = ("odom", "odom.pack", "odom.emit", "odom.readback",
              "graph:steady_k")


def moments_kernel(kernels, capture):
    """5.: the kernel's profiled device time per call against its event
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


def segment_add_roofline(kernels, nbytes):
    """3.: the share of its bytes roofline csrc/segment_add.cu's kernels
    reach in a profile whose calls needed `nbytes`, and the kernel names
    that could be taken for them."""
    mine = [k for k in kernels if SEGMENT_ADD.match(k[0])]
    us = sum(k[2] for k in mine)
    return {
        "kernels": sorted({k[0][:160] for k in mine}),
        "lookalikes": sorted({k[0][:160] for k in kernels
                              if ("sum_kernel" in k[0]
                                  or "partition_kernel" in k[0])
                              and not SEGMENT_ADD.match(k[0])}),
        "calls": sum(k[1] for k in mine), "device_us": us, "bytes": nbytes,
        "roofline_pct": (100.0 * nbytes / HBM_BYTES_PER_S / (us * 1e-6)
                         if us else None),
    }


def _plain_ms(pipe, packets):
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for pkt in packets:
        pipe.process_scan(*pkt)
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / len(packets)


def _warm(cfg, packets, **kw):
    from voxelslam_tpu_torch.pipeline import SlamPipeline
    pipe = SlamPipeline(cfg, collect_clouds=False, **kw)
    for pkt in packets[:N_WARM]:
        pipe.process_scan(*pkt)
    assert pipe.init_done
    return pipe


def program_split(snap, n_scans):
    """2.: the steady graph's stage marks and event pairs, and the host's
    spans, a scan; the counters over the scans."""
    g = snap["graphs"]["steady_k"]
    stages = {k: v / n_scans for k, v in g["stages"].items()}
    device = g["device_ms"] / n_scans
    return {
        "replays": g["replays"], "sampled": g["sampled"],
        "unsampled": g["unsampled"],
        "stage_device_ms_per_scan": stages,
        "stages_sum_ms_per_scan": sum(stages.values()),
        "replay_device_ms_per_scan": device,
        "host_ms_per_scan": {k: {"total": snap["spans"][k]["total_ms"]
                                 / n_scans,
                                 "self": snap["spans"][k]["self_ms"]
                                 / n_scans}
                             for k in HOST_SPANS if k in snap["spans"]},
        "counters": dict(snap["counters"]),
    }


def main():
    import torch
    if not torch.cuda.is_available():
        sys.exit("profile_torch_slice: needs a GPU")
    import chip_smoke as cs
    from voxelslam_tpu_torch.utils import telemetry

    cfg = cs.bench_config()
    K = cfg.odom.batch_scans                   # scans a dispatch
    traj, packets = cs.bench_packets(N_WARM + N_STEADY + N_PROF + K)
    steady = packets[N_WARM:N_WARM + N_STEADY]
    prof_pk = packets[N_WARM + N_STEADY:-K]
    res = {"config": "bench.py", "batch_scans": K,
           "deterministic_algorithms": False}

    # graphed, telemetry off: 1.
    pipe = _warm(cfg, packets)
    res["graphed_off"] = {"steady_ms_per_scan": _plain_ms(pipe, steady)}
    del pipe

    # graphed, telemetry on from before the build: 1., 2., 3., 4.
    telemetry.enable()
    pipe = _warm(cfg, packets)
    telemetry.reset()
    g = {"steady_ms_per_scan": _plain_ms(pipe, steady)}
    g.update(program_split(telemetry.snapshot(), N_STEADY))
    telemetry.reset()
    summary, kernels = cs.profile_scans(pipe, prof_pk)
    g.update(summary)
    g["segment_add"] = segment_add_roofline(
        kernels, telemetry.snapshot()["counters"].get(
            "kernel.segment_add.bytes", 0))
    telemetry.disable()
    graph = pipe._graphs["steady_k"]
    g["replay_device_ms"] = cs.replay_ms(graph.graph)
    g["capture_s"] = graph.capture_s
    res["graphed"] = g
    del pipe, graph

    # eager: 1., 3.
    pipe = _warm(cfg, packets, step_graphs=False)
    e = {"steady_ms_per_scan": _plain_ms(pipe, steady)}
    kernels, prof = cs.profile_scans(pipe, prof_pk)[::-1]
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
