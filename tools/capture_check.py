#!/usr/bin/env python3
"""Can the port's step functions run as CUDA graphs, and do they sum in a
fixed order? Two checks on one GPU, over each steady step function
(`_steady_megastep_k` at bench.py's batch of 4, `_steady_megastep` with
one scan a dispatch, `_mega_accum` with lba.mgsize = 2), each function of
the init path (an init-window scan, a dynamic-init round at the relaxed
and at the production gates and a successful init's map build and first
window BA, in the first of those runs) and
each function the global BA runs as a graph (`HbaRunner`'s round at the
coarse and the fine phase, the batched round over two windows, the window
condense and a batch's edges and condense), at SlamSystem's GBA widths on
tests/test_gba.py's scene, each loop-closure hook of the odometry (a
correction's map rebuild, its gravity-joint window solve, a keyframe
reload, an eviction; one run with clouds collected) and each program of
the loop pipeline at its widths (the keyframe merge + BTC extraction over
a window of that run's scans, ICP of one candidate and of a chunk padded
to four against 8,192-point keyframes, the pose graph at 64 anchors and
128 edges):

  1. host syncs: one dispatch, run eagerly, under
     `torch.cuda.set_sync_debug_mode("warn")`; every call that makes the
     host wait for the card, with its file:line (a CUDA graph cannot
     capture one);
  2. fixed order: the same dispatch twice more, its outputs bitwise
     equal to the first's (with `torch.use_deterministic_algorithms` off,
     as a user runs it); then once under a dispatch mode that runs every
     aten op twice more on the same inputs and lists, with file:line,
     each op whose outputs differ bitwise between the runs: where to
     look when the outputs differ. The hand-written kernels are outside
     the dispatcher; chip_smoke.py holds them to the CPU bitwise.

Run from the repository root:  python3 tools/capture_check.py
Prints one JSON object (and writes chiprun_out/capture_check.json); exits
non-zero on a host sync or outputs that differ. Needs a GPU.
"""

import collections
import dataclasses
import json
import os
import re
import sys
import types
import traceback
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(1, str(ROOT / "tests"))   # the loop-graph scenarios

N_REPEAT = 2          # extra runs of each op
PKG = "voxelslam_tpu_torch" + os.sep


def _where():
    """The innermost three frames of the port on the current stack."""
    st = [f for f in traceback.extract_stack() if PKG in f.filename]
    return " <- ".join(f"{f.filename.split(PKG)[1]}:{f.lineno}"
                       for f in st[-3:][::-1])


def _bits(t):
    import torch
    if t.dtype.is_floating_point:
        return t.contiguous().view({2: torch.int16, 4: torch.int32,
                                    8: torch.int64}[t.element_size()])
    return t


def unordered_mode():
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_flatten

    class Repeat(TorchDispatchMode):
        """Runs each op N_REPEAT more times on the same inputs (the
        arguments it writes restored from copies first)."""

        def __init__(self):
            super().__init__()
            self.ops = 0
            self.found = collections.Counter()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            name = func.overloadpacket.__name__
            if func.is_view or "empty" in name or name in (
                    "set_", "resize_", "detach", "lift_fresh"):
                return func(*args, **kwargs)
            written = [(i, a.name) for i, a in enumerate(
                func._schema.arguments)
                if a.alias_info is not None and a.alias_info.is_write]

            def slots():
                for i, n in written:
                    if i < len(args):
                        yield ("a", i), args[i]
                    elif n in kwargs:
                        yield ("k", n), kwargs[n]
            saved = {key: v.clone() for key, v in slots()
                     if isinstance(v, torch.Tensor)}
            out = func(*args, **kwargs)
            self.ops += 1
            ref = [t.clone() for t in tree_flatten(out)[0]
                   if isinstance(t, torch.Tensor)]
            for _ in range(N_REPEAT):
                a, k = list(args), dict(kwargs)
                for (kind, key), v in saved.items():
                    (a if kind == "a" else k)[key] = v.clone()
                got = [t for t in tree_flatten(func(*a, **k))[0]
                       if isinstance(t, torch.Tensor)]
                if any(x.shape != y.shape
                       or not torch.equal(_bits(x), _bits(y))
                       for x, y in zip(ref, got)):
                    self.found[f"{name} @ {_where()}"] += 1
                    break
            return out

    return Repeat()


def check_dispatch(fn, carry, inputs):
    """Checks 1 and 2 on one call of a step function: its host syncs, its
    outputs over three runs (bitwise equal or not), and the ops whose
    outputs differ between runs of the op (some are harmless: a write
    of several values to a row that is sliced away)."""
    import torch
    from voxelslam_tpu_torch.pipeline.graphs import leaves
    torch.cuda.synchronize()
    syncs = collections.Counter()

    def seen(message, category, filename, lineno, file=None, line=None):
        if "called a synchronizing" in str(message):
            at = f"{os.path.relpath(filename, ROOT)}:{lineno}"
            syncs[f"{at} ({str(message)[:80]}) <- {_where()}"] += 1
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = seen
        torch.cuda.set_sync_debug_mode("warn")
        try:
            first = fn(carry, inputs)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    ref = [_bits(t) for t in leaves(first)]
    same = all(all(torch.equal(x, _bits(y)) for x, y in
                   zip(ref, leaves(fn(carry, inputs)))) for _ in range(2))
    torch.cuda.synchronize()
    mode = unordered_mode()
    with mode:
        fn(carry, inputs)
    torch.cuda.synchronize()
    return dict(host_syncs=dict(syncs), outputs_repeat_bitwise=same,
                ops_checked=mode.ops, ops_differing=dict(mode.found))


def run(cfg, packets, steps, device="cuda"):
    """Drive an eager pipeline and check its `nth` dispatch of each step
    of `steps` ({name: nth}, names as `SlamPipeline._run` gets them).
    Returns {name: result}."""
    import torch
    from voxelslam_tpu_torch.pipeline import SlamPipeline
    pipe = SlamPipeline(cfg, collect_clouds=("steady" in steps),
                        device=device, step_graphs=False)
    result, seen, staged = {}, collections.Counter(), {}
    real = pipe._run

    def checked(name, fn, carry, inputs):
        if inputs is not None:      # None: a round of the staged window
            staged[name] = tuple(torch.as_tensor(a, device=pipe.device)
                                 for a in inputs)
        seen[name] += 1
        if name in steps and seen[name] == steps[name]:
            result[name] = check_dispatch(fn, carry, staged[name])
        return real(name, fn, carry, inputs)
    pipe._run = checked
    for pkt in packets:
        pipe.process_scan(*pkt)
        if len(result) == len(steps):
            break
    missing = set(steps) - set(result)
    if missing:
        raise RuntimeError(f"no dispatch of {sorted(missing)} "
                           f"({dict(seen)})")
    return result


HOOKS = ("correction", "g_reloc", "keyframe_reload", "evict")


def run_hooks(cfg, packets, device="cuda"):
    """Drive an eager pipeline with clouds collected, the map's load
    checked every 4 scans at a load that always evicts, a g_update
    correction from three keyframe stand-ins before scan 24 and a reload
    before scan 28 (tests/test_torch_loop_graph_cuda.py's hooks), and
    check the first dispatch of each hook. Returns ({name: result}, the
    run's ScanPoses)."""
    import torch
    from voxelslam_tpu_torch.pipeline import SlamPipeline
    from test_torch_loop_graph_cuda import DX_P, DX_R, stand_ins
    cfg = dataclasses.replace(cfg, map=dataclasses.replace(
        cfg.map, evict_check_every=4, evict_load=0.01))
    pipe = SlamPipeline(cfg, collect_clouds=True, device=device,
                        step_graphs=False)
    result = {}
    real = pipe._run

    def checked(name, fn, carry, inputs):
        base = re.sub(r"_\d+(x\d+)?$", "", name)
        if base in HOOKS and base not in result:
            result[base] = check_dispatch(fn, carry, tuple(
                torch.as_tensor(a, device=device) for a in inputs))
        return real(name, fn, carry, inputs)
    pipe._run = checked
    for k, pkt in enumerate(packets):
        if k == 24:
            pipe.apply_correction(DX_R, DX_P, True,
                                  stand_ins(pipe.scan_poses, (0, 2, -1)))
        elif k == 28:
            pipe.insert_keyframe_fixed(stand_ins(pipe.scan_poses, (1,))[0])
        pipe.process_scan(*pkt)
    pipe.flush()
    missing = set(HOOKS) - set(result)
    if missing:
        raise RuntimeError(f"no dispatch of {sorted(missing)}")
    return result, pipe.scan_poses


def run_loop(cfg, poses, device="cuda"):
    """Check one call of each loop program (see the module docstring) at
    the loop pipeline's own widths, on two keyframes merged from the
    windows of `poses`."""
    import numpy as np
    import torch
    from voxelslam_tpu_torch.pipeline import LoopPipeline
    from test_torch_loop_graph_cuda import icp_chunk, pose_chain
    lp = LoopPipeline(cfg, device=device, step_graphs=False)
    result = {}

    def checked(key, fn, inputs):
        staged = tuple(torch.as_tensor(a, device=device) for a in inputs)
        name = "loop_" + (key if isinstance(key, str)
                          else "_".join(map(str, key)))
        if name not in result:
            result[name] = check_dispatch(fn, (), staged)
        return fn((), staged)[1]
    lp._run = checked
    W = cfg.lba.win_size
    kfs = []
    for j in range(2):
        g = poses[j * W:(j + 1) * W]
        down, dmask, _ = lp._keyframe(g, g[-1].R, g[-1].p)
        kfs.append(types.SimpleNamespace(cloud=down, mask=dmask,
                                         R0=np.asarray(g[-1].R),
                                         p0=np.asarray(g[-1].p)))
    chunk, cands = icp_chunk(kfs, np.random.default_rng(0))
    for n in (1, 3):
        lp._icp_chunk(kfs[1], chunk[:n], cands[:n])
    lp._solve_pose_graph(*pose_chain(0))
    return result


def run_gba():
    """Check one call of each function the global BA captures (see the
    module docstring), eagerly, at `HbaRunner`'s default widths."""
    import numpy as np
    import torch
    import chip_smoke as cs
    from voxelslam_tpu_torch.config import SlamConfig
    from voxelslam_tpu_torch.gba import HbaRunner
    from voxelslam_tpu_torch.parallel.dist_gba import (condense_window,
                                                       make_window_fleet)
    r = HbaRunner(SlamConfig(), device="cuda", step_graphs=False)
    W, P = r.cfg.gba.win_size, r.kf_point_max
    kfs, _ = cs.scene_keyframes(W + r.cfg.gba.stride, P)

    def window(w):
        return tuple(torch.as_tensor(np.stack(x), dtype=torch.float32,
                                     device="cuda") for x in (
            [k.cloud for k in w], [k.mask for k in w], [k.R0 for k in w],
            [k.p0 for k in w], np.ones(len(w))))
    clouds, masks, Rs, ps, wmask = window(kfs[:W])
    res = {}
    for fine in (False, True):
        res["gba_round_" + ("fine" if fine else "coarse")] = check_dispatch(
            r._round_fn(W, 1024, fine), (Rs, ps), (clouds, masks, wmask))
    two = [window(kfs[s:s + W]) for s in (0, r.cfg.gba.stride)]
    cb, mb, Rb, pb, wb = (torch.stack(x) for x in zip(*two))
    z = torch.zeros((2,), dtype=torch.int32, device="cuda")
    carry = (Rb, pb, Rb.new_zeros((2, 6 * W, 6 * W)), Rb.new_zeros((2,)),
             Rb.new_zeros((2,)), z, z)
    res["gba_batched_round"] = check_dispatch(r._batch_round_fn(W, 1024),
                                              carry, (cb, mb, wb))
    vs = r.cfg.map.voxel_size / 8.0
    res["gba_condense"] = check_dispatch(
        lambda c, x: (c, condense_window(*x, vs, P)), (),
        (clouds, masks, Rs, ps))
    seen = {}

    def run(fn, *inputs):
        seen.update(fn=fn, inputs=inputs)
        return fn(*inputs)
    make_window_fleet(None, lambda *a: r._batch_step(*a, 1024), W, vs, P,
                      run=run)(cb, mb, Rb, pb, wb)
    res["gba_batch_outputs"] = check_dispatch(
        lambda c, x: (c, seen["fn"](*x)), (), seen["inputs"])
    return res


def main():
    import torch
    if not torch.cuda.is_available():
        sys.exit("capture_check: needs a GPU")
    import chip_smoke as cs
    from voxelslam_tpu_torch.ops import moments, segment_add
    moments.build()
    segment_add.build()
    cfg = cs.bench_config()
    _, packets = cs.bench_packets(36)
    mg2 = dataclasses.replace(cfg, lba=dataclasses.replace(cfg.lba,
                                                           mgsize=2))
    res = {"card": cs.subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()}
    init = {"init_accum": 2, "init_round": 2, "init_round_aligned": 1,
            "init_map": 1}
    res.update(run(cfg, packets, dict(init, steady_k=2)))
    res.update(run(cfg, packets, {"steady": 2}))
    res.update(run(mg2, packets, {"accum": 2}))
    hooks, poses = run_hooks(cfg, packets)
    res.update(hooks)
    res.update(run_loop(cfg, poses))
    res.update(run_gba())
    ok = all(not r["host_syncs"] and r["outputs_repeat_bitwise"]
             for k, r in res.items() if k != "card")
    res["ok"] = ok
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "capture_check.json").write_text(json.dumps(res, indent=1))
    print(json.dumps(res))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
