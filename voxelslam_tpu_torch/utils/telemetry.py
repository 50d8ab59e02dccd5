"""Spans, counters and device times inside the port, off by default.

    from voxelslam_tpu_torch.utils import telemetry
    telemetry.enable()            # before the system is built: the step
    ...                           # graphs then capture their stage marks
    snap = telemetry.snapshot()   # {"spans", "counters", "graphs"}

Telemetry is on between `enable()` and `disable()`. When it is off, `span(name)` returns one shared no-op context,
`count(name, n)` returns at once and `mark(name)` does nothing: no
`record_function`, no CUDA event and no host read is made on any path.

When it is on:

- `span(name)` keeps the host start and end (`time.perf_counter_ns`) and
  the enclosing span, and opens `torch.profiler.record_function("span:" +
  name)`, so an idle gap of the card on the profiler's timeline is named
  by the innermost span that covers it. A span's self time is its
  duration less its children's. `recent()` gives the last spans on the
  profiler's clock (Unix nanoseconds).
- `count(name, n)` adds n to a counter. Counters only take values the host
  already holds.
- `pipeline.graphs.StepGraph` times each dispatch on the card with a pair
  of CUDA events (`dispatch_begin`/`dispatch_end`), read once the card
  has passed them (`query()`), at the next dispatch of any graph or at
  `snapshot()`, which waits for what is still pending. No dispatch waits.
- `mark(name)` inside a function being captured into a CUDA graph records
  an external timing event, which the capture keeps as an event-record
  node that every replay records again. Stage `name` of a replay takes
  the time from the mark before it (or the replay's start) to its own. A
  replay whose marks were not yet complete when its graph replayed again
  counts as `unsampled`: the marks then hold the newer replay's times.
  Graphs captured while telemetry was off have no marks.

`snapshot()` sums by name: spans (count, total, self and max ms, the
enclosing spans), counters, and per graph name its dispatches
(`replays`, a capture's eager warm-up included), `device_ms`,
`captures`, `capture_s`, `host_ms` (staging numpy inputs to the card)
and, for graphs with marks, the device ms of each stage (summed over a
replay's K unrolled steps) over `sampled` replays.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import time

import torch

RECENT = 4096          # spans `recent()` keeps


class _Null:
    """The shared no-op span."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NULL = _Null()


class _Span:
    __slots__ = ("tel", "name", "parent", "t0", "child_ns", "rf")

    def __init__(self, tel, name):
        self.tel = tel
        self.name = name

    def __enter__(self):
        stack = self.tel._stack
        self.parent = stack[-1] if stack else None
        stack.append(self)
        self.child_ns = 0
        # the clock is read inside the profiler range, whose start a
        # recording profiler takes late in record_function's entry
        self.rf = torch.profiler.record_function("span:" + self.name)
        self.rf.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        self.rf.__exit__(*exc)
        tel = self.tel
        stack = tel._stack
        if stack and stack[-1] is self:
            stack.pop()
        elif self in stack:
            stack.remove(self)
        dur = t1 - self.t0
        parent = self.parent
        if parent is not None:
            parent.child_ns += dur
        tel._add_span(self.name, None if parent is None else parent.name,
                      self.t0, t1, dur - self.child_ns)
        return False


class _Dispatch:
    """One timed dispatch of a step graph: its event pair and, for a
    replay of a graph with marks, the marks (name, event) in order."""
    __slots__ = ("graph", "start", "end", "marks")

    def __init__(self, graph, start, end, marks):
        self.graph, self.start, self.end, self.marks = graph, start, end, marks


class Telemetry:
    """The state behind the module's functions (see the module
    docstring)."""

    def __init__(self):
        self.enabled = False
        self._stack = []
        self._free = []            # timing events read and free again
        self._capture = None       # marks of the capture in progress
        self.reset()

    # -- switches ---------------------------------------------------------

    def on(self) -> bool:
        return self.enabled

    def reset(self):
        """Forget every span, counter and graph time; dispatches still in
        flight are dropped unread."""
        for d in getattr(self, "_pending", ()):
            d.marks = None
        self._spans = {}           # name -> [count, total, self, max] ns
        self._parents = {}         # name -> {parent name: count}
        self._recent = collections.deque(maxlen=RECENT)
        self._counters = {}
        self._graphs = {}
        self._pending = collections.deque()
        self._offset_ns = time.time_ns() - time.perf_counter_ns()

    # -- spans and counters -------------------------------------------------

    def span(self, name: str):
        return _Span(self, name) if self.on() else NULL

    def _add_span(self, name, parent, t0, t1, self_ns):
        s = self._spans.get(name)
        if s is None:
            s = self._spans[name] = [0, 0, 0, 0]
        dur = t1 - t0
        s[0] += 1
        s[1] += dur
        s[2] += self_ns
        s[3] = max(s[3], dur)
        ps = self._parents.setdefault(name, {})
        ps[parent] = ps.get(parent, 0) + 1
        self._recent.append((name, parent, t0 + self._offset_ns,
                             t1 + self._offset_ns))

    def count(self, name: str, n=1):
        if not self.on():
            return
        self._counters[name] = self._counters.get(name, 0) + n

    # -- graphs -------------------------------------------------------------

    def _graph(self, name):
        g = self._graphs.get(name)
        if g is None:
            g = self._graphs[name] = dict(
                replays=0, device_ms=0.0, captures=0, capture_s=0.0,
                host_ms=0.0, sampled=0, unsampled=0, stages={})
        return g

    def graph_add(self, name: str, key: str, value):
        """Add to one of graph `name`'s counters (`captures`, `capture_s`,
        `host_ms`)."""
        if self.on():
            self._graph(name)[key] += value

    def _event(self):
        return (self._free.pop() if self._free
                else torch.cuda.Event(enable_timing=True))

    def dispatch_begin(self):
        """The start event of a dispatch on the current stream, or None
        when telemetry is off."""
        if not self.on():
            return None
        self.poll()
        ev = self._event()
        ev.record()
        return ev

    def dispatch_end(self, name: str, start, marks=None):
        """Close the dispatch `start` began; returns its record, which the
        graph hands to `replay_again` before its next replay."""
        if start is None:
            return None
        end = self._event()
        end.record()
        d = _Dispatch(name, start, end, marks)
        self._pending.append(d)
        return d

    def replay_again(self, last):
        """Before a graph with marks replays again: its last replay's marks
        are read if complete, else that replay counts as unsampled (the
        replay about to run records the marks anew)."""
        if last is None or last.marks is None:
            return
        if not self.on():
            last.marks = None
            return
        self.poll()
        if last.marks is not None:
            self._graph(last.graph)["unsampled"] += 1
            last.marks = None

    def poll(self):
        """Read the pending dispatches the card has passed, oldest first."""
        while self._pending and self._pending[0].end.query():
            self._read(self._pending.popleft())

    def _read(self, d):
        g = self._graph(d.graph)
        g["replays"] += 1
        g["device_ms"] += d.start.elapsed_time(d.end)
        if d.marks is not None:
            prev = d.start
            st = g["stages"]
            for name, ev in d.marks:
                st[name] = st.get(name, 0.0) + prev.elapsed_time(ev)
                prev = ev
            g["sampled"] += 1
            d.marks = None
        self._free += [d.start, d.end]

    # -- marks ----------------------------------------------------------------

    @contextlib.contextmanager
    def capture_marks(self):
        """Around a CUDA graph capture: yields the list the capture's
        `mark` calls fill, or None when telemetry is off."""
        if not self.on():
            yield None
            return
        outer, self._capture = self._capture, []
        try:
            yield self._capture
        finally:
            self._capture = outer

    def mark(self, name: str):
        if self._capture is None or not torch.cuda.is_current_stream_capturing():
            return
        ev = torch.cuda.Event(enable_timing=True, external=True)
        ev.record()
        self._capture.append((name, ev))

    # -- reading --------------------------------------------------------------

    def snapshot(self) -> dict:
        """Everything recorded since the last reset, summed by name; waits
        for the dispatches still in flight."""
        while self._pending:
            d = self._pending.popleft()
            d.end.synchronize()
            self._read(d)
        ms = 1e-6
        return {
            "spans": {n: {"count": s[0], "total_ms": s[1] * ms,
                          "self_ms": s[2] * ms, "max_ms": s[3] * ms,
                          "parents": dict(self._parents.get(n, {}))}
                      for n, s in self._spans.items()},
            "counters": dict(self._counters),
            "graphs": {n: dict(g, stages=dict(g["stages"]))
                       for n, g in self._graphs.items()},
        }

    def recent(self) -> list:
        """The last spans as (name, parent, start_ns, end_ns), on the
        profiler's clock (Unix nanoseconds)."""
        return list(self._recent)


_T = Telemetry()


def enable():
    _T.enabled = True


def disable():
    _T.enabled = False


def on() -> bool:
    return _T.on()


def reset():
    _T.reset()


def snapshot() -> dict:
    return _T.snapshot()


def recent() -> list:
    return _T.recent()


def span(name: str):
    return _T.span(name)


def spanned(name: str):
    """A function decorator: each call is the span `name`."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with _T.span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


def count(name: str, n=1):
    _T.count(name, n)


def mark(name: str):
    _T.mark(name)


def state() -> Telemetry:
    """The process's telemetry, for the step graphs."""
    return _T
