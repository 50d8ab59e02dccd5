"""The traced run (`--trace 1`): stage clocks over the whole window and
the profiler over its first `trace_s` seconds.

Stage clocks (the pattern of the port's `chip_smoke.stage_timers`, copied
here): each method below is wrapped on its class and clocked on the host
with a device synchronise before and after, while the window is open;
each call is also a `span:<stage>` range in the profile, so an idle gap
on the card can be named by what the host was doing.

    verify            loop/btc.DescriptorDB.verify (host numpy RANSAC)
    keyframe          pipeline/loop.LoopPipeline._keyframe ("keyframe")
    icp               pipeline/loop.LoopPipeline._icp_chunk (("icp", B))
    pose_graph        pipeline/loop.LoopPipeline._solve_pose_graph
    apply_correction  pipeline/odometry.SlamPipeline.apply_correction
    keyframe_reload   pipeline/odometry.SlamPipeline.insert_keyframe_fixed
    gba_window        gba/hba.HbaRunner._window_step
    steady            pipeline/odometry.SlamPipeline._run of "steady" /
                      "steady_k" (its scans counted; the valid rows of the
                      scans' downsampled clouds read back, for the moments
                      kernel's bytes)

The profile (`torch.profiler`, host and card) is reduced here: the device
busy time is the union of the intervals of the card's operations (kernels,
copies, fills), not their sum, which counts two streams' overlap twice;
host launches are the host's calls into the CUDA runtime that start work
on the card; kernels are counted by name.
"""

from __future__ import annotations

import time

import numpy as np

from . import peaks

LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaGraphLaunch",
                "cuGraphLaunch", "cudaMemcpyAsync", "cudaMemsetAsync",
                "cudaLaunchKernelExC", "cuLaunchKernelEx", "cudaMemcpy",
                "cudaMemset")
STAGES = (
    ("voxelslam_tpu_torch.loop.btc", "DescriptorDB", "verify", "verify"),
    ("voxelslam_tpu_torch.pipeline.loop", "LoopPipeline", "_keyframe",
     "keyframe"),
    ("voxelslam_tpu_torch.pipeline.loop", "LoopPipeline", "_icp_chunk",
     "icp"),
    ("voxelslam_tpu_torch.pipeline.loop", "LoopPipeline",
     "_solve_pose_graph", "pose_graph"),
    ("voxelslam_tpu_torch.pipeline.odometry", "SlamPipeline",
     "apply_correction", "apply_correction"),
    ("voxelslam_tpu_torch.pipeline.odometry", "SlamPipeline",
     "insert_keyframe_fixed", "keyframe_reload"),
    ("voxelslam_tpu_torch.gba.hba", "HbaRunner", "_window_step",
     "gba_window"),
)
STEADY = ("steady", "steady_k")


def union_length(intervals) -> float:
    """Total length covered by (start, end) intervals."""
    total, end = 0.0, -np.inf
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def idle_gaps(intervals, lo, hi) -> list:
    """The gaps in [lo, hi] that no interval covers, as (start, end)."""
    gaps, cur = [], lo
    for s, e in sorted(intervals):
        if s > cur:
            gaps.append((cur, min(s, hi)))
        cur = max(cur, e)
        if cur >= hi:
            break
    if cur < hi:
        gaps.append((cur, hi))
    return [(a, b) for a, b in gaps if b > a]


def _ns(e, what):
    for attr, scale in ((f"{what}_ns", 1), (f"{what}_us", 1000)):
        f = getattr(e, attr, None)
        if f is not None:
            return f() * scale
    raise AttributeError(what)


def reduce_events(events):
    """From the profiler's events: device intervals (ns), kernel count and
    device ns by name, host launch count, and the host's span ranges."""
    dev, host_spans, by_name = [], [], {}
    kernels = launches = 0
    for e in events:
        name = e.name()
        s = _ns(e, "start")
        d = _ns(e, "duration")
        on_card = str(e.device_type()).endswith("CUDA")
        if name.startswith("span:"):
            # a range is also drawn on the card's timeline as an
            # annotation: no operation
            if not on_card:
                host_spans.append((s, s + d, name[5:]))
            continue
        if on_card:
            dev.append((s, s + d))
            by_name[name] = by_name.get(name, 0) + d
            low = name.lower()
            if not (low.startswith("memcpy") or low.startswith("memset")):
                kernels += 1
        elif name.startswith(LAUNCH_CALLS):
            launches += 1
    return dev, by_name, kernels, launches, host_spans


class Tracer:
    def __init__(self, cell, device):
        self.cell = cell
        self.device = device
        self.trace_s = float(cell.traffic.get("trace_s", 10.0))
        self.levels = len(cell.slam_config().map.capacities)
        self.spans = {}          # stage -> [seconds]
        self.steady_scans = 0
        self.keyframes = 0
        self.active = False
        self.profiling = False
        self.prof = None
        self.scans_profiled = 0
        self.valid_rows = []     # per steady scan in the profile
        self.busy_s = 0.0
        self.window_s = 0.0
        self.summary = {}
        self._saved = []
        self._install()

    # -- clocks -------------------------------------------------------------

    def _sync(self):
        import torch
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _clock(self, stage, fn):
        import torch
        tr = self

        def call(*a, **kw):
            if not tr.active:
                return fn(*a, **kw)
            tr._sync()
            t0 = time.perf_counter()
            with torch.profiler.record_function("span:" + stage):
                out = fn(*a, **kw)
                tr._sync()
            tr.spans.setdefault(stage, []).append(time.perf_counter() - t0)
            return out
        return call

    def _install(self):
        import importlib
        import torch
        for mod, cls, meth, stage in STAGES:
            obj = getattr(importlib.import_module(mod), cls)
            fn = getattr(obj, meth)
            self._saved.append((obj, meth, fn))
            setattr(obj, meth, self._clock(stage, fn))
        from voxelslam_tpu_torch.pipeline import odometry
        run = odometry.SlamPipeline._run
        self._saved.append((odometry.SlamPipeline, "_run", run))
        tr = self

        def steady_run(self_, name, fn, carry, inputs):
            if not tr.active or name not in STEADY:
                return run(self_, name, fn, carry, inputs)
            tr._sync()
            t0 = time.perf_counter()
            with torch.profiler.record_function("span:steady"):
                out = run(self_, name, fn, carry, inputs)
                tr._sync()
            tr.spans.setdefault("steady", []).append(time.perf_counter() - t0)
            k = 1 if name == "steady" else int(np.shape(inputs[2])[0])
            tr.steady_scans += k
            if tr.profiling:
                dmask = out[1][1] if name == "steady" else out[1][2]
                n = int(dmask.reshape(k, -1).sum().item())
                tr.valid_rows.append(n)
            return out
        odometry.SlamPipeline._run = steady_run

    # -- the window ---------------------------------------------------------

    def open_window(self, sysm):
        from torch.profiler import ProfilerActivity, profile
        lp = sysm.loop
        self._kf0 = sum(len(s) for s in lp.keyframes) if lp else 0
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self._sync()
        self.prof.__enter__()
        self.profiling = True
        self.active = True
        self._t_prof = time.perf_counter()
        self._t_prof_ns = time.perf_counter_ns()

    def tick(self, k):
        if self.profiling:
            self.scans_profiled += 1
            if time.perf_counter() - self._t_prof >= self.trace_s:
                self._stop_profile()

    def _stop_profile(self):
        self._sync()
        self.window_s = time.perf_counter() - self._t_prof
        self.profiling = False
        self.prof.__exit__(None, None, None)

    def close_window(self, sysm):
        if self.profiling:
            self._stop_profile()
        self.active = False
        lp = sysm.loop
        self.keyframes = (sum(len(s) for s in lp.keyframes) - self._kf0
                          if lp else 0)
        for obj, meth, fn in reversed(self._saved):
            setattr(obj, meth, fn)
        self._reduce()

    def _reduce(self):
        res = getattr(self.prof.profiler, "kineto_results", None)
        events = res.events() if res is not None else []
        dev, by_name, kernels, launches, spans = reduce_events(events)
        busy_ns = union_length(dev)
        self.busy_s = busy_ns / 1e9
        if dev:
            lo = min(s for s, _ in dev)
            hi = max(e for _, e in dev)
            lo = min([lo] + [s for s, _, _ in spans])
        else:
            lo = hi = 0
        gaps = idle_gaps(dev, lo, hi)
        named = []
        for a, b in gaps:
            mid = 0.5 * (a + b)
            cover = [(e - s, n) for s, e, n in spans if s <= mid <= e]
            named.append((min(cover)[1] if cover else "host",
                          (b - a) / 1e9))
        named.sort(key=lambda x: -x[1])
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        moments_ns = sum(v for k, v in by_name.items()
                         if peaks.MOMENTS_KERNEL in k)
        self.summary = dict(
            kernels=kernels, launches=launches, scans=self.scans_profiled,
            device_ops=[[k[:120], v / 1e9] for k, v in top],
            idle_gaps=[[n, s] for n, s in named[:10]],
            moments_s=moments_ns / 1e9,
            moments_bytes=sum(peaks.moments_bytes(n, self.levels)
                              for n in self.valid_rows))
        self.prof = None

    def breakdown(self):
        if not self.summary:
            return None
        return {"device_ops": self.summary["device_ops"],
                "idle_gaps": self.summary["idle_gaps"]}
