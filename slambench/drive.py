"""Set-up and the measured window of one run: the stream made on the card,
the system built and warmed up, then the scans handed to
`SlamSystem.process_scan` in a closed loop (offline replay: the next scan
as soon as the last returns, over a fixed range of scans that `--seconds`
sizes, whatever the program's speed) or an open one (a live sensor: a
scan every 1 / rate_hz seconds, due at the end of its sweep, whatever the
program does).

Where the configuration names prior sessions (`previous_maps`), set-up
first writes them from the seed into a fresh temporary directory
(`slambench.sessions`), which the system gets as its `savepath` and
which is removed after the run. A deployment finds such files already on
disk, so the writing is timed apart (`setup_parts["prior_sessions"]`) and
left out of `setup_s`; their loading, inside `SlamSystem`, stays in it.

What the run saw goes into a `Run` record, which the metric readers
(`slambench/metrics/`) and the output check read.
"""

from __future__ import annotations

import dataclasses
import shutil
import tempfile
import time

import numpy as np

from . import sessions, sim


@dataclasses.dataclass
class Run:
    cell: str
    seed: int
    seconds: float
    mode: str
    setup_s: float = 0.0
    window_s: float = 0.0
    window_scans: list = dataclasses.field(default_factory=list)
    emitted_in_window: int = 0
    due: dict = dataclasses.field(default_factory=dict)       # k -> wall s
    emit_at: dict = dataclasses.field(default_factory=dict)   # k -> wall s
    emit_call: dict = dataclasses.field(default_factory=dict)  # k -> call k
    lateness: list = dataclasses.field(default_factory=list)
    peak_bytes: int = 0
    points_in: int = 0
    points_kept: int = 0
    laps: list = dataclasses.field(default_factory=list)
    phases: dict = dataclasses.field(default_factory=dict)
    captures_in_window: list = dataclasses.field(default_factory=list)
    trace: object = None
    stream_scans: int = 0
    rays: float = 0.0
    occupancy: list = dataclasses.field(default_factory=list)
    emitted_pose: dict = dataclasses.field(default_factory=dict)  # k->(R, p)
    t_first: float = 0.0     # scan 0's end: a pose's time -> its scan
    period: float = 0.1
    setup_parts: dict = dataclasses.field(default_factory=dict)
    call_ms: list = dataclasses.field(default_factory=list)
    events: dict = dataclasses.field(default_factory=dict)    # in window
    edges: list = dataclasses.field(default_factory=list)     # LoopEdges
    n_loops: int = 0
    scan_t: dict = dataclasses.field(default_factory=dict)    # (s, i) -> t
    emit_index: dict = dataclasses.field(default_factory=dict)  # k -> its
    # place among the odometry's poses, in the window
    priors: object = None    # sessions.Priors, where the cell has them
    prior_sizes: dict = dataclasses.field(default_factory=dict)
    joined_scan: int | None = None   # the call whose correction joined F
    prior_final: list = dataclasses.field(default_factory=list)  # their
    # positions where the loop pipeline holds them at the window's close
    map_drops: dict = dataclasses.field(default_factory=dict)  # the calls'
    # voxels the hash could not place and evictions, in the window and
    # outside it; the window's calls that report drops, [call - warm-up,
    # voxels]


def window_scans(traffic: dict, seconds: float) -> int:
    """The closed loop's window: whole groups of `window_group_scans`
    scans, as many as `window_rate_hz` gives in `seconds` (at least one).
    The range is fixed before the run, so the window's mix of scan kinds
    does not depend on how fast the program runs."""
    group = int(traffic.get("window_group_scans", 1))
    n = round(seconds * float(traffic["window_rate_hz"]) / group)
    return group * max(1, int(n))


class Counters:
    """Counts taken in every run by wrapping the program's methods on their
    classes (cheap: no device sync): `DescriptorDB.verify` calls, the
    points handed to `_pad_points` against those it keeps, and the step
    graphs captured (`StepGraph._warm_and_capture`) with their keys; and
    the seconds of `io.sessions.load_previous_sessions`, in set-up."""

    def __init__(self):
        self.verify = 0
        self.points_in = 0
        self.points_kept = 0
        self.captures = []
        self.load_s = 0.0
        self._saved = []

    def install(self, device):
        from voxelslam_tpu_torch.io import sessions as ses
        from voxelslam_tpu_torch.loop import btc
        from voxelslam_tpu_torch.pipeline import graphs, odometry
        c = self

        def wrap(obj, name, make):
            fn = getattr(obj, name)
            self._saved.append((obj, name, fn))
            setattr(obj, name, make(fn))

        def verify(fn):
            def call(*a, **kw):
                c.verify += 1
                return fn(*a, **kw)
            return call

        def pad(fn):
            def call(self_, pts, offsets=None):
                out = fn(self_, pts, offsets)
                c.points_in += len(pts)
                c.points_kept += int(np.count_nonzero(out[2]))
                return out
            return call

        def capture(fn):
            def call(self_):
                c.captures.append(getattr(getattr(self_, "fn", None),
                                          "__name__", "?"))
                return fn(self_)
            return call

        def load(fn):
            def call(*a, **kw):
                t0 = time.perf_counter()
                out = fn(*a, **kw)
                _sync(device)
                c.load_s += time.perf_counter() - t0
                return out
            return call
        wrap(btc.DescriptorDB, "verify", verify)
        wrap(ses, "load_previous_sessions", load)
        wrap(odometry.SlamPipeline, "_pad_points", pad)
        wrap(graphs.StepGraph, "_warm_and_capture", capture)

    def uninstall(self):
        for obj, name, fn in reversed(self._saved):
            setattr(obj, name, fn)
        self._saved = []


def _sync(device):
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def lap_counts(sysm, counters) -> dict:
    lp, g = sysm.loop, sysm.gba
    return dict(
        keyframes=sum(len(s) for s in lp.keyframes) if lp else 0,
        verified=counters.verify,
        loops=len(lp.lp_edges) if lp else 0,
        corrections=sysm.corrections,
        gba_windows=len(g.window_log) if g is not None else 0,
        sessions=sysm.odom.session + 1)


def prewarm_icp(sysm):
    """Capture both of the loop pipeline's ICP graphs, ("icp", 1) and
    ("icp", 4), before the window: which of them the warm-up scans reach
    depends on how many candidates passed, and a capture inside the
    window is compile time measured as work. One call each through
    `LoopPipeline._icp_chunk`, the newest keyframe against the four
    before it (of any session) from the identity; the graphs keep no
    state between calls and nothing of the result is used."""
    kfs = [kf for s in sysm.loop.keyframes for kf in s]
    if len(kfs) < 5:
        raise RuntimeError("the warm-up made fewer than 5 keyframes")
    guess = {"R": np.eye(3), "t": np.zeros(3)}
    for n in (1, 4):
        chunk = [(kf.kf_index, guess) for kf in kfs[-1 - n:-1]]
        sysm.loop._icp_chunk(kfs[-1], chunk, kfs[-1 - n:-1])


PREWARM = {"icp": prewarm_icp}


def make_stream(cell, cfg, seed, seconds, device):
    tr = cell.traffic
    if tr["mode"] == "open":
        n = tr["warm_scans"] + int(round(seconds * tr["rate_hz"])) \
            + tr.get("tail_scans", 60)
    else:
        n = tr["warm_scans"] + window_scans(tr, seconds) \
            + tr.get("tail_scans", 10)
    stream = sim.make_stream(cell.sensor(cfg), tr, seed, device, n_scans=n)
    if len(stream) < n:
        raise RuntimeError(f"the trajectory gives {len(stream)} scans, the "
                           f"cell needs {n}")
    return stream


def run(cell, seed: int, seconds: float, device, t_start: float,
        recorder, tracer=None) -> tuple[Run, object, object]:
    """Set-up and the window. `tracer` (trace.Tracer) opens its profile
    and clocks on the window; `recorder` (check.Recorder, required) keeps
    each pose as the odometry handed it out, which is what the run
    records as emitted, and the sampled dispatches of the window for the
    output check. Returns (the Run, the system, the stream)."""
    import torch

    tr = cell.traffic
    cfg = cell.slam_config()
    t_pri = time.perf_counter()
    system = dict(cell.config["system"])
    priors, savepath = None, None
    try:
        if sessions.named(cell) or tr.get("prior_sessions"):
            savepath = tempfile.mkdtemp(prefix="slambench-sessions-")
            priors = sessions.write(cell, cfg, seed, device, savepath)
            system["savepath"] = savepath
            _sync(device)
        t_gen = time.perf_counter()
        stream = make_stream(cell, cfg, seed, seconds, device)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            torch.cuda.empty_cache()
            # the generator's and the writer's buffers are the
            # benchmark's, not the program's
            torch.cuda.reset_peak_memory_stats(device)
        return _run(cell, seed, seconds, device, t_start, tracer, recorder,
                    cfg, system, stream, priors, t_pri, t_gen)
    finally:
        if savepath is not None:
            shutil.rmtree(savepath, ignore_errors=True)


def _run(cell, seed, seconds, device, t_start, tracer, recorder, cfg,
         system, stream, priors, t_pri, t_gen):
    """`run` once the prior sessions are written and the stream made."""
    import torch
    from voxelslam_tpu_torch.pipeline.system import SlamSystem

    tr = cell.traffic
    r = Run(cell=cell.name, seed=seed, seconds=seconds, mode=tr["mode"],
            stream_scans=len(stream), rays=float(np.mean(stream.rays)))
    r.setup_parts = {"imports": t_pri - t_start,
                     "stream": time.perf_counter() - t_gen}
    if priors is not None:
        r.priors = priors
        r.setup_parts["prior_sessions"] = t_gen - t_pri
        r.prior_sizes = dict(
            sessions=len(priors.names), scans=[len(p) for p in priors.gt_p],
            points=int(sum(int(c.sum()) for c in priors.points)),
            bytes=priors.bytes, edges=len(priors.edges))
    counters = Counters()
    counters.install(device)
    try:
        sysm = SlamSystem(cfg, device=device, **system)
        if priors is not None:
            r.prior_sizes["load_s"] = counters.load_s
        period = float(cell.config["sensor"]["period_s"])
        t_first = float(stream.t_end[0])
        r.t_first, r.period = t_first, period
        seen = [0]
        lap = tr.get("lap_scans")
        last_lap = [lap_counts(sysm, counters)]

        def call(k, in_window):
            t_call = time.perf_counter()
            out = sysm.process_scan(*stream.packet(k))
            now = time.perf_counter()
            kind = ("correction" if out.get("loop_correction") else
                    out.get("phase", "?"))
            key = ("window:" if in_window else "setup:") + kind
            n_s = r.phases.setdefault(key, [0, 0.0])
            n_s[0] += 1
            n_s[1] += now - t_call
            drops = r.map_drops.setdefault(
                "window" if in_window else "outside",
                {"hash_dropped": 0, "evictions": 0, "calls": []})
            hd = int(out.get("hash_dropped", 0))
            drops["hash_dropped"] += hd
            drops["evictions"] += int(bool(out.get("evicted")))
            if in_window and hd:
                drops["calls"].append([k - tr["warm_scans"], hd])
            if in_window:
                r.call_ms.append(round(1e3 * (now - t_call), 1))
            ps = sysm.odom.scan_poses
            for e, sp in enumerate(ps[seen[0]:], seen[0]):
                j = int(round((float(sp.t) - t_first) / period))
                if j not in r.emit_at:
                    r.emit_at[j] = now
                    r.emit_call[j] = k
                    if in_window:
                        # the pose as the odometry handed it out, before
                        # a correction in this call moved it
                        r.emitted_pose[j] = recorder.handed[e]
                        r.emit_index[j] = e
            if r.joined_scan is None and recorder.joined_at is not None:
                r.joined_scan = k
            n_new = len(ps) - seen[0]
            seen[0] = len(ps)
            if lap and (k + 1) % lap == 0:
                cur = lap_counts(sysm, counters)
                r.laps.append(dict(lap=(k + 1) // lap, **{
                    key: cur[key] - last_lap[0][key] for key in cur
                    if key != "sessions"}, sessions=cur["sessions"]))
                last_lap[0] = cur
            return n_new

        r.setup_parts["system"] = time.perf_counter() - t_gen \
            - r.setup_parts["stream"]
        t_warm = time.perf_counter()
        warm = tr["warm_scans"]
        for k in range(warm):
            call(k, False)
        for name in tr.get("prewarm", []):
            PREWARM[name](sysm)
        _sync(device)
        r.setup_parts["warm"] = time.perf_counter() - t_warm
        n_caps = len(counters.captures)
        ev0 = lap_counts(sysm, counters)
        lp = sysm.loop
        n_lp0 = len(lp.lp_edges) if lp else 0
        n_gba0 = len(sysm.gba.edges1) if sysm.gba is not None else 0
        recorder.open_window(sysm)
        if tracer is not None:
            tracer.open_window(sysm)
        t0 = time.perf_counter()
        r.setup_s = t0 - t_start - r.setup_parts.get("prior_sessions", 0.0)
        r.setup_parts["window_prep"] = t0 - t_warm - r.setup_parts["warm"]
        k = warm
        if tr["mode"] == "closed":
            n_win = window_scans(tr, seconds)
            if warm + n_win > len(stream):
                raise RuntimeError(
                    f"the stream of {len(stream)} scans is shorter than the "
                    f"warm-up and the window ({warm} + {n_win})")
            for k in range(warm, warm + n_win):
                r.emitted_in_window += call(k, True)
                r.window_scans.append(k)
                if tracer is not None:
                    tracer.tick(k)
            _sync(device)
            r.window_s = time.perf_counter() - t0
        else:
            dt = 1.0 / float(tr["rate_hz"])
            n_win = int(round(seconds * float(tr["rate_hz"])))
            last = warm + n_win - 1
            while True:
                if k >= len(stream):
                    raise RuntimeError(
                        f"the stream of {len(stream)} scans ran out before "
                        f"the window's scans were emitted")
                due = t0 + (k - warm) * dt
                wait = due - time.perf_counter()
                if wait > 2e-3:
                    time.sleep(wait - 1e-3)
                while time.perf_counter() < due:
                    pass
                start = time.perf_counter()
                if k <= last:
                    r.due[k] = due
                    r.lateness.append(start - due)
                    r.window_scans.append(k)
                call(k, k <= last)
                if tracer is not None:
                    tracer.tick(k)
                k += 1
                if k > last and all(j in r.emit_at for j in r.due):
                    break
                if k > last + tr.get("tail_scans", 60) - 1:
                    break
            _sync(device)
            r.window_s = n_win * dt
        if tracer is not None:
            tracer.close_window(sysm)
        recorder.close_window(sysm)
        r.captures_in_window = counters.captures[n_caps:]
        ev1 = lap_counts(sysm, counters)
        r.events = {k: ev1[k] - ev0[k] for k in ev1 if k != "sessions"}
        if lp is not None:
            # the GBA windows still in flight are read now, after the
            # window: their edges are the window's
            if sysm.gba is not None:
                sysm.gba.drain()
                r.edges += sysm.gba.edges1[n_gba0:]
            r.n_loops = len(lp.lp_edges) - n_lp0
            r.edges += lp.lp_edges[n_lp0:]
            r.scan_t = {(s_, i): float(sp.t)
                        for s_, sps in enumerate(lp.scan_poses)
                        for i, sp in enumerate(sps)}
            if priors is not None:
                r.prior_final = [np.stack([sp.p for sp in sps]) for sps in
                                 lp.scan_poses[:len(priors.names)]]
        if device.type == "cuda":
            r.peak_bytes = int(torch.cuda.max_memory_allocated(device))
        r.points_in, r.points_kept = counters.points_in, counters.points_kept
        r.phases["verify_calls"] = counters.verify
        r.occupancy = [int(lv.occ.sum()) for lv in sysm.odom.levels]
    finally:
        counters.uninstall()
    return r, sysm, stream
