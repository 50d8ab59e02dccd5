"""A step function of fixed shapes run as one CUDA graph replay a dispatch:
the port's counterpart of the JAX package's donated `jax.jit` megasteps
(`voxelslam_tpu/pipeline/odometry.py:158-163`).

`StepGraph(fn, device)` wraps `fn(carry, inputs) -> (carry, extras)`,
where `carry` is a tree (`core.tensors.tmap`'s dataclasses, tuples and
lists) of tensors that `fn` returns updated with the same structure and
shapes, `inputs` a tuple of tensors and `extras` a tuple of such trees. It
owns static buffers: the carry's leaves and the inputs. A call

  1. copies each carry leaf that is not already its static buffer into
     that buffer (a caller that rebound the carry between dispatches:
     a reset, an eviction, a loop correction, a checkpoint load), and the
     inputs into the static inputs: the host's numpy arrays (on the card
     through pinned staging buffers, two in turn, each reused only after
     the event of its last copy) or tensors on the device (copied on the
     device), of the first call's shapes; `inputs=None` keeps what the
     last call staged, so a loop
     over inputs that do not change (a GBA window's rounds) stages them
     once;
  2. runs `fn` on the static buffers and copies the returned carry back
     into them, so the state advances in place (the donation);
  3. returns the static carry tree and the extras.

On CUDA the first call runs step 2 eagerly on a side stream, which warms
up the libraries and is that dispatch's real step, then captures step 2
into a `torch.cuda.CUDAGraph`; every later call replays it. The extras
then live in the graph's pool and the next replay overwrites them, as
the static carry is overwritten: a caller that keeps either across a
dispatch clones it. On the CPU step 2 runs eagerly each call, with the
extras copied into buffers of their own, so the same reuse shows there.
A failed capture or replay raises; nothing falls back to eager. Python's
garbage collector is held off during a capture (it could destroy a dead
object's graph, which a capture refuses).

Graphs that never run concurrently may share one memory pool (`pool`, a
`torch.cuda.graph_pool_handle()`): a later capture may then place its
extras where an earlier graph keeps its temporaries, so a caller clones
an extra it keeps before another graph of the pool replays (the static
carry and inputs are allocated outside every pool).

Kernel launch counters (`ops.moments.counter`, `ops.segment_add.counter`)
record a capture's launches and bytes apart; each replay adds them, so the
counters count kernel executions. `capture_s` and `capture_bytes` (the
device memory the capture reserved: its pool's growth) describe the
capture.

With telemetry on (`utils.telemetry`), a call is the span
`graph:<name>`, and each dispatch on the card (a replay, or a capture's
eager warm-up) is timed by a pair of CUDA events that are read later,
never waited for; the graph's name also counts its captures, their
seconds and the host's ms staging numpy inputs. A capture made with
telemetry on keeps the step's stage marks (`telemetry.mark`).
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from ..core.tensors import tmap
from ..ops import moments, segment_add
from ..utils import telemetry

COUNTERS = (moments.counter, segment_add.counter)


def graph_name(key) -> str:
    """A cache key of step graphs ("steady", ("icp", 4)) as a name."""
    return key if isinstance(key, str) else "_".join(str(k) for k in key)


def leaves(tree) -> list:
    out = []
    tmap(out.append, tree)
    return out


def host_arrays(*xs) -> list:
    """One device-to-host copy of several tensors of any dtypes -> numpy
    arrays of their shapes and dtypes, bit for bit (each an array of its
    own, never a view of a buffer that a later dispatch overwrites)."""
    raw = [x.detach().contiguous().reshape(-1).view(torch.uint8) for x in xs]
    flat = torch.cat(raw).cpu().numpy() if raw else np.zeros(0, np.uint8)
    out, o = [], 0
    for x, r in zip(xs, raw):
        dt = torch.empty(0, dtype=x.dtype).numpy().dtype
        out.append(flat[o:o + r.numel()].view(dt).reshape(tuple(x.shape))
                   .copy())
        o += r.numel()
    return out


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a is b or (a.data_ptr() == b.data_ptr() and a.shape == b.shape
                      and a.stride() == b.stride() and a.dtype == b.dtype)


def assign(dsts, srcs) -> None:
    """dst.copy_(src) for each pair that is not one tensor already; a
    source that shares storage with any destination is cloned first, so
    the order of the copies cannot matter."""
    pairs = [(d, s) for d, s in zip(dsts, srcs) if not _same(d, s)]
    held = {d.untyped_storage().data_ptr() for d, _ in pairs}
    srcs = [s.clone() if s.untyped_storage().data_ptr() in held else s
            for _, s in pairs]
    for (d, _), s in zip(pairs, srcs):
        d.copy_(s)


class StepGraph:
    """`fn(carry, inputs)` over static buffers, one CUDA graph replay a
    call on the card (see the module docstring)."""

    def __init__(self, fn, device, pool=None, name=None):
        self.fn = fn
        self.name = name or getattr(fn, "__name__", "step")
        self.device = torch.device(device)
        self.pool = pool
        self.calls = 0
        self.tree = None            # the static carry tree
        self.static = None          # its leaves
        self.inputs = None          # static input tensors
        self.extras = None
        self.graph = None
        self.captured_launches = None
        self.captured_bytes = None
        self.marks = None           # the capture's stage marks
        self._last = None           # the last timed replay (telemetry)
        self.capture_s = None
        self.capture_bytes = None   # device memory the capture reserved
        self._staging = None
        self._events = [None, None]
        self._turn = 0

    def __call__(self, carry, inputs):
        """carry: the caller's carry tree; inputs: numpy arrays, tensors
        on the device, or None to keep the last call's. Returns (static
        carry tree, extras)."""
        with telemetry.span("graph:" + self.name):
            return self._call(carry, inputs)

    def _call(self, carry, inputs):
        src = leaves(carry)
        if self.tree is None:
            if inputs is None:
                raise ValueError("the first call of a step graph stages its "
                                 "inputs")
            self._allocate(carry, inputs)
        self.calls += 1
        if len(src) != len(self.static) or any(
                s.shape != d.shape or s.dtype != d.dtype
                for s, d in zip(src, self.static)):
            raise ValueError("the carry's structure, shapes or dtypes differ "
                             "from the captured step's")
        assign(self.static, src)
        tel = telemetry.state()
        if inputs is not None and tel.on():
            t0 = time.perf_counter()
            self._stage(inputs)
            tel.graph_add(self.name, "host_ms",
                          1e3 * (time.perf_counter() - t0))
        else:
            self._stage(inputs)
        if self.device.type != "cuda":
            out = self._step()
            if self.extras is None:
                self.extras = tmap(torch.empty_like, out)
            assign(leaves(self.extras), leaves(out))
            return self.tree, self.extras
        if self.graph is None:
            return self.tree, self._warm_and_capture()
        tel.replay_again(self._last)
        begin = tel.dispatch_begin()
        self.graph.replay()
        self._last = tel.dispatch_end(self.name, begin, self.marks)
        for c, n, b in zip(COUNTERS, self.captured_launches,
                           self.captured_bytes):
            c.replayed(n, b)
        return self.tree, self.extras

    def _allocate(self, carry, inputs):
        self.tree = tmap(lambda a: torch.empty_like(
            a, memory_format=torch.contiguous_format), carry)
        self.static = leaves(self.tree)
        if all(torch.is_tensor(a) for a in inputs):
            self.inputs = tuple(torch.empty_like(
                a, device=self.device, memory_format=torch.contiguous_format)
                for a in inputs)
            return
        arrs = [np.asarray(a) for a in inputs]
        self.inputs = tuple(
            torch.empty(a.shape, dtype=torch.from_numpy(np.empty(0, a.dtype))
                        .dtype, device=self.device) for a in arrs)
        if self.device.type == "cuda":
            self._staging = [tuple(torch.empty(t.shape, dtype=t.dtype,
                                               pin_memory=True)
                                   for t in self.inputs) for _ in range(2)]

    def _stage(self, inputs):
        if inputs is None:
            return
        if len(inputs) != len(self.inputs) or any(
                tuple(np.shape(a) if not torch.is_tensor(a) else a.shape)
                != tuple(d.shape) for a, d in zip(inputs, self.inputs)):
            raise ValueError("the inputs' number or shapes differ from the "
                             "captured step's")
        if all(torch.is_tensor(a) for a in inputs):
            assign(self.inputs, inputs)
            return
        if self.device.type != "cuda":
            for dst, a in zip(self.inputs, inputs):
                dst.copy_(torch.from_numpy(np.ascontiguousarray(a)))
            return
        k, self._turn = self._turn, 1 - self._turn
        if self._events[k] is not None:
            self._events[k].synchronize()     # its last copy has run
        for host, dst, a in zip(self._staging[k], self.inputs, inputs):
            host.numpy()[...] = a
            dst.copy_(host, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record()
        self._events[k] = ev

    def _step(self):
        carry, extras = self.fn(self.tree, self.inputs)
        assign(self.static, leaves(carry))
        return tuple(extras)

    def _warm_and_capture(self):
        tel = telemetry.state()
        begin = tel.dispatch_begin()
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            first = self._step()              # this dispatch's step
        main = torch.cuda.current_stream()
        main.wait_stream(side)
        tel.dispatch_end(self.name, begin)
        for e in leaves(first):
            e.record_stream(main)
        t0 = time.perf_counter()
        before = [(c.captured, c.captured_bytes) for c in COUNTERS]
        graph = torch.cuda.CUDAGraph()
        # a garbage collection inside the capture could free a dead
        # object's graph, whose destruction the capture refuses (it is
        # then invalidated): none until the capture has ended
        collecting = gc.isenabled()
        gc.disable()
        try:
            with tel.capture_marks() as marks, torch.cuda.graph(
                    graph, pool=self.pool, stream=side,
                    capture_error_mode="thread_local"):
                # after the context's empty_cache: the pool's growth
                reserved = torch.cuda.memory_reserved(self.device)
                self.extras = self._step()
        finally:
            if collecting:
                gc.enable()
        self.captured_launches = [c.captured - b[0]
                                  for c, b in zip(COUNTERS, before)]
        self.captured_bytes = [c.captured_bytes - b[1]
                               for c, b in zip(COUNTERS, before)]
        self.marks = marks or None
        self.graph = graph
        self.capture_s = time.perf_counter() - t0
        self.capture_bytes = torch.cuda.memory_reserved(self.device) - reserved
        tel.graph_add(self.name, "captures", 1)
        tel.graph_add(self.name, "capture_s", self.capture_s)
        return first
