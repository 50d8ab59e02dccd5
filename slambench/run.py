"""Run one cell of `BENCHMARK.json` once on one card.

    python -m slambench.run --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

from the root of a checkout. Set-up makes the cell's scans and IMU from
the seed on the card (`slambench.sim`), builds `SlamSystem` with the
cell's configuration and warms it up on the stream's first scans; the
window then hands scans to `SlamSystem.process_scan` for `--seconds`
(`slambench.drive`). With `--trace 1` the window also runs under the
profiler and the stage clocks (`slambench.trace`) and the run reports the
cell's per-layer metrics; with `--trace 0` its end-to-end metrics.

A configuration that names prior sessions has them written from the seed
first (`slambench.sessions`), outside `setup_s`.

After the window the output check (`slambench.check`) holds what the
timed path produced (emitted poses, loop and GBA edges, the map's window
clusters after sampled steps, sampled loop verifications) to the plain
reference (`slambench/reference/`) and the generator's ground truth, each
compared number to its limit (`slambench/limits/<cell>.json`, and the
configuration's stated accuracy). The run prints those numbers beside
their limits as its last lines on standard error and, under "checks", as
the last key of its result: one JSON object, the last line of standard
output.

It exits with another code than 0, and prints no result, where there is
no CUDA card (or fewer than the cell asks for) and where JAX or the JAX
package is loaded once the window has closed. `--device cpu` skips the
look for a card, for the CPU tests only; `--control tf32` runs the
program with TF32 matmuls, the lower precision the check must refuse.
"""

import time

_T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

from .cell import ROOT, load_cell, metric_reader  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "voxelslam_tpu")
CACHE = ROOT / "build" / "slambench"


def parse(argv=None):
    p = argparse.ArgumentParser(prog="python -m slambench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--device", default="cuda", help=argparse.SUPPRESS)
    p.add_argument("--control", choices=("none", "tf32"), default="none",
                   help=argparse.SUPPRESS)
    p.add_argument("--fault", default=None, help=argparse.SUPPRESS)
    p.add_argument("--shrink", default=None, help=argparse.SUPPRESS)
    p.add_argument("--root", default=str(ROOT), help=argparse.SUPPRESS)
    return p.parse_args(argv)


def loaded_forbidden() -> list:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not readable"


def device_of(args, cell):
    """The card, or the CPU for the tests; exits 2 without a card."""
    import torch
    if args.device == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        print("slambench: no CUDA card (torch.cuda.is_available() is "
              "false); the benchmark does not run on the CPU",
              file=sys.stderr)
        sys.exit(2)
    if torch.cuda.device_count() < cell.chips:
        print(f"slambench: the cell asks for {cell.chips} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        sys.exit(2)
    return torch.device("cuda", 0)


def truth(run, stream, s: int, i: int):
    """The true (R, p) at the end of the loop pipeline's scan i of
    session s, or None: a prior session's from its writer, the live
    stream's by the scan's time; in the prior sessions' frame F where the
    cell has them."""
    pri = run.priors
    if pri is not None and s < len(pri.names):
        return pri.truth(s, i)
    if (s, i) not in run.scan_t:
        return None
    j = int(round((run.scan_t[(s, i)] - run.t_first) / run.period))
    if not 0 <= j < len(stream):
        return None
    R, p = stream.gt_R[j], stream.gt_p[j]
    return (R, p) if pri is None else pri.to_frame(R, p)


def main(argv=None) -> int:
    args = parse(argv)
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = str(CACHE / sub)
    cell = load_cell(args.workload, args.root)
    if args.shrink:
        from . import shrink
        shrink.apply(cell, args.shrink)
    import torch
    dev = device_of(args, cell)
    import voxelslam_tpu_torch  # noqa: F401  (sets strict float32)
    from . import check, drive, trace
    if args.control == "tf32":
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
    if dev.type == "cuda":
        print(json.dumps({"device": torch.cuda.get_device_name(0),
                          "count": torch.cuda.device_count(),
                          "smi": power_limit(),
                          "torch": torch.__version__,
                          "cuda": torch.version.cuda}), flush=True)
    recorder = check.Recorder(cell, args.seed, dev, fault=args.fault)
    tracer = trace.Tracer(cell, dev) if args.trace else None
    run, sysm, stream = drive.run(cell, args.seed, args.seconds, dev,
                                  _T_START, tracer=tracer, recorder=recorder)
    run.trace = tracer
    if run.laps:
        print(json.dumps({"laps": run.laps}), flush=True)
    print(json.dumps({
        "points_handed_in": run.points_in, "points_padded": run.points_kept,
        "mean_rays_with_return": run.rays, "stream_scans": run.stream_scans,
        "window_scans": len(run.window_scans),
        "map_occupancy": run.occupancy, "calls": run.phases,
        "setup_parts": run.setup_parts, "call_ms": run.call_ms,
        "prior_sessions": run.prior_sizes or None,
        "map_drops": run.map_drops,
        "captures_in_window": run.captures_in_window,
        "feeder_late_ms": (None if not run.lateness else {
            "median": 1e3 * sorted(run.lateness)[len(run.lateness) // 2],
            "max": 1e3 * max(run.lateness)})}), flush=True)

    wanted = cell.per_layer if args.trace else cell.end_to_end
    metrics = {}
    for m in wanted:
        v = metric_reader(m["name"], args.root)(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": (torch.cuda.get_device_name(0) if dev.type == "cuda"
                       else "cpu"),
              "count": 1, "memory_peak_bytes": run.peak_bytes}
    breakdown = None
    if tracer is not None:
        device["busy_s"] = tracer.busy_s
        device["window_s"] = tracer.window_s
        breakdown = tracer.breakdown()

    # the output check, once the window has closed and the peak is read
    parts = {"edges": run.edges, "n_loops": run.n_loops,
             "truth": lambda s_, i: truth(run, stream, s_, i)}
    del sysm
    recorder.uninstall()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
    missing = sorted(set(run.due) - set(run.emit_at))
    t_check = time.perf_counter()
    checks = recorder.compare(run, stream, parts)
    t_check = time.perf_counter() - t_check
    unchecked = recorder.plan_missed(run)
    if unchecked:
        # what the window never reached was never checked
        print(f"slambench: the window lacked {unchecked}, which the check "
              "draws or the traffic expects", file=sys.stderr)
    checks["plan_missed"] = {"value": len(unchecked), "limit": 0}
    checks["poses_missing"] = {"value": len(missing), "limit": 0}
    correct = all(c["value"] <= c["limit"] for c in checks.values())

    bad = loaded_forbidden()
    if bad:
        print(f"slambench: the run loaded {bad}; the benchmark measures the "
              "port alone", file=sys.stderr)
        return 3
    print(json.dumps({
        "check_s": t_check, "events": run.events,
        "map": getattr(recorder, "map_seen", None),
        "poses": getattr(recorder, "pose_errs", None),
        "relocalized": None if run.priors is None else dict(
            joined_scan=run.joined_scan,
            **(getattr(recorder, "reloc_errs", None) or {})),
        "edges": getattr(recorder, "edge_errs", None),
        "verify": getattr(recorder, "verify_seen", None),
        "run_s": time.perf_counter() - _T_START}), flush=True)
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    out = {"correct": bool(correct),
           "attempted": len(run.window_scans),
           "failed": len(missing), "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
