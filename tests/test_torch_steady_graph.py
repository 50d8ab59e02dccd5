"""The steady step as step graphs (`voxelslam_tpu_torch/pipeline/graphs.py`)
and the fixed-order scatter-add (`voxelslam_tpu_torch/ops/segment_add.py`),
on the CPU.

A StepGraph on the CPU runs the same static-buffer code as on the card
(copy-in of a rebound carry, the step, copy-back into the buffers, the
extras in buffers the next dispatch overwrites) with the step run eagerly;
only capture and replay are the card's. So `SlamPipeline(step_graphs=True)`
is held bitwise to `step_graphs=False` over runs that rebind the carry
between dispatches (eviction, a reset, a checkpoint load, a loop
correction) and over each dispatch path (`_steady_megastep_k` at K = 4,
`_steady_megastep` at K = 1, `_mega_accum` with lba.mgsize = 2).
`tests/test_torch_kernels.py` holds the captured step to the eager one
on the card.

segment_add is held bitwise to a sequential scatter-add in ascending source
index (the order its CUDA kernels add in: their schedule, emulated by
`test_torch_segment_add.emulate` on both paths), and within a float32
tolerance to the JAX package's `.at[].add(mode="drop")`. Config and scene
are tests/test_determinism.py's.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from voxelslam_tpu_torch import config as C
from voxelslam_tpu_torch.core.tensors import drop_add
from voxelslam_tpu_torch.io import simulator as sim
from voxelslam_tpu_torch.ops import segment_add as sa
from voxelslam_tpu_torch.pipeline import SlamPipeline, SlamSystem
from voxelslam_tpu_torch.pipeline.graphs import StepGraph, assign

from test_torch_segment_add import emulate

torch.set_num_threads(1)

WIDTHS = (1, 3, 4, 6, 18, 36)
# ops that read a device value back to the host on the card (a CUDA graph
# cannot capture them); a step that runs none of them on the CPU runs none
# on the card but the library calls' own (tools/capture_check.py)
HOST_READS = {"_local_scalar_dense", "nonzero", "_linalg_check_errors",
              "masked_select", "_unique2", "unique_dim",
              "unique_consecutive", "equal", "is_nonzero", "bincount",
              "repeat_interleave"}


# --------------------------------------------------------------------------
# segment_add
# --------------------------------------------------------------------------

def _seg_inputs(D, seed, C=257, N=900):
    """buf (C[, D]), idx (N,) in [0, C] with C (dropped) among them and a
    quarter of the sources on row 5, val (N[, D]); float32."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, C + 1, N)
    idx[::4] = 5
    idx[1::97] = C
    tail = (D,) if D > 1 else ()
    return (rng.normal(size=(C,) + tail).astype(np.float32), idx,
            rng.normal(size=(N,) + tail).astype(np.float32))


def _sequential(buf, idx, val):
    out = buf.copy()
    for i, r in enumerate(idx):
        if r < len(buf):
            out[r] = out[r] + val[i]
    return out


def _bits(a):
    return np.ascontiguousarray(a).view(np.int32)


@pytest.mark.parametrize("D", WIDTHS)
def test_segment_add_is_the_sequential_scatter_add(D):
    buf, idx, val = _seg_inputs(D, seed=D)
    want = _sequential(buf, idx, val)
    tb, ti, tv = (torch.from_numpy(buf), torch.from_numpy(idx),
                  torch.from_numpy(val))
    for got in (sa.segment_add_ref(tb, ti, tv), sa.segment_add(tb, ti, tv),
                drop_add(tb, ti, tv), drop_add(tb, ti.to(torch.int32), tv)):
        assert np.array_equal(_bits(got.numpy()), _bits(want))
    for path in (1, 2):                 # the CUDA kernels' schedule
        pl = sa.plan(buf.shape[0], len(idx), D, path=path)
        assert np.array_equal(_bits(emulate(buf, idx, val, pl)), _bits(want))
    # XLA's CPU scatter may sum a row in another order: float32 rounding
    # of up to ~230 unit-normal terms on the hot row
    jx = np.asarray(jnp.asarray(buf).at[idx].add(val, mode="drop"))
    np.testing.assert_allclose(jx, want, rtol=1e-5, atol=1e-4)


def test_drop_add_packed_columns_equal_separate_adds():
    """Columns that share an index sum independently: the downsample's and
    the inserts' packed adds are bitwise their separate adds."""
    _, idx, val = _seg_inputs(4, seed=11)
    ti, tv = torch.from_numpy(idx), torch.from_numpy(val)
    packed = drop_add(torch.zeros(257, 4), ti, tv)
    n = drop_add(torch.zeros(257), ti, tv[:, 0])
    s = drop_add(torch.zeros(257, 3), ti, tv[:, 1:4])
    assert torch.equal(packed[:, 0], n) and torch.equal(packed[:, 1:], s)


def test_segment_add_rejects_mismatched_shapes():
    with pytest.raises(ValueError):
        sa.segment_add(torch.zeros(4, 3), torch.zeros(5, dtype=torch.long),
                       torch.zeros(5, 2))


# --------------------------------------------------------------------------
# StepGraph's buffers
# --------------------------------------------------------------------------

@dataclasses.dataclass
class _Pair:
    a: torch.Tensor
    b: torch.Tensor


def _toy(carry, inputs):
    x, pair = carry
    (inc,) = inputs
    x2 = x + inc
    return (x2, _Pair(a=pair.a * 2.0, b=pair.b + x2.sum())), (x2 * 10.0,)


def test_step_graph_advances_its_buffers_in_place():
    g = StepGraph(_toy, "cpu")
    carry = (torch.zeros(3), _Pair(a=torch.ones(2), b=torch.zeros(())))
    tree, (ext,) = g(carry, (np.ones(3, np.float32),))
    assert torch.equal(tree[0], torch.ones(3))
    assert torch.equal(tree[1].a, torch.full((2,), 2.0))
    kept = ext.clone()
    tree2, (ext2,) = g(tree, (np.full(3, 2.0, np.float32),))
    # the same buffers, advanced; the extra overwritten in place
    assert tree2[0] is tree[0] and tree2[1].b is tree[1].b and ext2 is ext
    assert torch.equal(tree2[0], torch.full((3,), 3.0))
    assert float(tree2[1].b) == 3.0 + 9.0
    assert not torch.equal(ext, kept)
    # a rebound leaf is copied in before the step
    fresh = (torch.full((3,), -1.0), tree2[1])
    tree3, _ = g(fresh, (np.zeros(3, np.float32),))
    assert torch.equal(tree3[0], torch.full((3,), -1.0))
    with pytest.raises(ValueError):
        g((torch.zeros(4), tree3[1]), (np.zeros(3, np.float32),))


def test_assign_reads_every_source_before_writing():
    """A source that is a view of another destination is read before that
    destination is overwritten, whatever the order of the pairs."""
    a, b = torch.zeros(2), torch.tensor([5.0, 6.0])
    assign([a, b], [b[0:2], torch.tensor([7.0, 8.0])])
    assert a.tolist() == [5.0, 6.0] and b.tolist() == [7.0, 8.0]
    b = torch.tensor([5.0, 6.0])
    assign([b, a], [torch.tensor([7.0, 8.0]), b[0:2]])
    assert a.tolist() == [5.0, 6.0] and b.tolist() == [7.0, 8.0]


# --------------------------------------------------------------------------
# SlamPipeline: step graphs against the eager step
# --------------------------------------------------------------------------

def _packets(n_scans):
    traj = sim.make_trajectory(duration=0.2 + 0.1 * (n_scans + 2),
                               speed=1.2, wobble=0.25, yaw_rate=0.3,
                               ramp=1.2)
    normals, dsp = sim.box_room(half_extent=(14.0, 12.0, 3.5),
                                center=(4.0, 0.0, 1.0))
    out, t = [], 0.1
    for k in range(n_scans):
        scan = sim.lidar_scan(traj, t, t + 0.1, normals, dsp, n_az=96,
                              n_el=16, noise=0.01, seed=k)
        hit = scan["hit"]
        ts = np.arange(t - 0.01, t + 0.1 + 1e-6, 1.0 / 200.0)
        imu = np.array([np.concatenate(traj.imu_at(ti)) for ti in ts])
        out.append((scan["points"][hit], scan["offsets"][hit], ts,
                    imu[:, 0:3], imu[:, 3:6], t, t + 0.1))
        t += 0.1
    return out


def _cfg(**kw):
    """tests/test_determinism.py's widths with a window of 6 scans (init
    in 8 scans); `kw` replaces MapConfig, OdometryConfig or LocalBAConfig
    fields."""
    parts = dict(map=C.MapConfig(capacities=(1 << 11, 1 << 12, 1 << 12),
                                 unique_max=(1024, 1024, 2048), win_size=6),
                 odom=C.OdometryConfig(point_max=1024, imu_max=64),
                 lba=C.LocalBAConfig(factor_max=256, win_size=6))
    for k, v in kw.items():
        sect = next(s for s in parts if hasattr(parts[s], k))
        parts[sect] = dataclasses.replace(parts[sect], **{k: v})
    return C.SlamConfig(**parts)


@pytest.fixture(scope="module")
def packets():
    return _packets(30)


class _HostReads(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.found = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        if name in HOST_READS:
            self.found.add(name)
        return func(*args, **(kwargs or {}))


def _watch(pipe, log):
    """Record, for the pipeline's first dispatch of each step graph, the
    host-reading ops its step runs (log[name])."""
    real = pipe._run

    def run(name, fn, carry, inputs):
        if name in log:
            return real(name, fn, carry, inputs)
        mode = _HostReads()
        with mode:
            out = real(name, fn, carry, inputs)
        log[name] = sorted(mode.found)
        return out
    pipe._run = run


def _trace(pipe, packets, events=None, hook=None):
    """process_scan over packets; per scan the pose x (R, p) copied."""
    xs = []
    for k, pkt in enumerate(packets):
        if hook is not None:
            pipe = hook(k, pipe) or pipe
        out = pipe.process_scan(*pkt)
        if events is not None:
            events.append(out)
        xs.append(np.concatenate([pipe.x.R.numpy().ravel(),
                                  pipe.x.p.numpy()]))
    return pipe, np.stack(xs)


def _poses(pipe):
    return np.stack([np.concatenate([sp.R.ravel(), sp.p, sp.v])
                     for sp in pipe.scan_poses])


@pytest.fixture(scope="module")
def batched(packets, tmp_path_factory):
    """K = 4 (SlamSystem without loop closure): eviction checked every 4
    scans at a load that always evicts, a checkpoint saved and loaded into
    a fresh system at scan 13 with a partial batch queued, a divergence
    reset at scan 17 and a second init; both ways. Returns {graphed: (xs,
    poses, events, host reads)}."""
    cfg = _cfg(evict_check_every=4, evict_load=0.01)
    path = str(tmp_path_factory.mktemp("ckpt") / "mid.ckpt")
    res = {}
    for graphed in (True, False):
        def make():
            s = SlamSystem(cfg, enable_loop=False, device="cpu")
            s.odom.step_graphs = graphed
            return s
        box = {"sys": make()}
        log = {}
        _watch(box["sys"].odom, log)

        def hook(k, pipe):
            if k == 13:
                del box["sys"].odom._run     # the watch is not state
                box["sys"].save_checkpoint(path)
                box["sys"] = make()
                box["sys"].load_checkpoint(path)
                return box["sys"].odom
            if k == 17:
                pipe.reset(session=pipe.session + 1)
            return None
        events = []
        pipe, xs = _trace(box["sys"].odom, packets, events, hook)
        pipe.flush()
        res[graphed] = (xs, _poses(pipe), events, log, pipe)
    return res


def test_graphs_equal_eager_batched_lifecycle(batched):
    (xs_g, p_g, ev_g, _, _), (xs_e, p_e, ev_e, _, _) = (batched[True],
                                                        batched[False])
    assert ev_g == ev_e
    assert np.array_equal(xs_g, xs_e)
    assert np.array_equal(p_g, p_e)


def test_batched_run_covers_the_rebinding_events(batched):
    xs, poses, events, log, pipe = batched[True]
    phases = [e.get("phase") for e in events]
    assert any(e.get("evicted") for e in events)
    assert "init_done" in phases[18:]            # the second init
    assert pipe.session == 1 and "steady_k" in pipe._graphs
    assert np.isfinite(xs).all() and len(poses) > 15
    assert log["steady_k"] == []                 # no host read in the step


@pytest.fixture(scope="module")
def single(packets):
    """K = 1 (collect_clouds=True, as SlamSystem): a loop correction (the
    map rebuilt from the window clouds) at scan 13; both ways. In the
    graphed run each deferred emission is held to a copy taken when it was
    deferred, after the next dispatch has run."""
    res = {}
    c, s = np.cos(0.02), np.sin(0.02)
    dx_R = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
    for graphed in (True, False):
        pipe = SlamPipeline(_cfg(), collect_clouds=True, device="cpu",
                            step_graphs=graphed)
        log, kept, stale = {}, [None], []
        _watch(pipe, log)
        real = pipe._emit_pending

        def emit():
            if kept[-1] is not None:
                stale.append(any(
                    torch.is_tensor(a) and not torch.equal(a, b)
                    for a, b in zip(pipe._pending, kept[-1])))
                kept.append(None)
            return real()
        pipe._emit_pending = emit

        def hook(k, p):
            # the deferred emission as it was left by scan k - 1
            kept.append(None if p._pending is None else tuple(
                a.clone() if torch.is_tensor(a) else a for a in p._pending))
            if k == 13:
                p.apply_correction(dx_R, np.array([0.05, -0.02, 0.0]),
                                   False, [])
        _, xs = _trace(pipe, packets[:20], hook=hook)
        pipe.flush()
        res[graphed] = (xs, _poses(pipe), log, stale, kept, pipe)
    return res


def test_graphs_equal_eager_single_scan_with_correction(single):
    assert np.array_equal(single[True][0], single[False][0])
    assert np.array_equal(single[True][1], single[False][1])
    clouds = [[sp.cloud for sp in single[g][5].scan_poses]
              for g in (True, False)]
    assert all(np.array_equal(a, b) for a, b in zip(*clouds))


def test_pending_survives_the_next_dispatch(single):
    _, _, log, stale, kept, pipe = single[True]
    assert len(stale) > 5 and not any(stale)
    assert "steady" in pipe._graphs and log["steady"] == []


@pytest.fixture(scope="module")
def refill(packets):
    """lba.mgsize = 2: BA bursts and refill scans through `_mega_accum`'s
    step graph; both ways."""
    res = {}
    for graphed in (True, False):
        pipe = SlamPipeline(_cfg(mgsize=2), device="cpu",
                            step_graphs=graphed)
        log = {}
        _watch(pipe, log)
        events = []
        _, xs = _trace(pipe, packets[:20], events)
        pipe.flush()
        res[graphed] = (xs, _poses(pipe), events, log, pipe)
    return res


def test_graphs_equal_eager_mgsize2(refill):
    (xs_g, p_g, ev_g, log, pipe), (xs_e, p_e, ev_e, _, _) = (refill[True],
                                                             refill[False])
    assert sum(bool(e.get("accum")) for e in ev_g) >= 3
    assert ev_g == ev_e
    assert np.array_equal(xs_g, xs_e) and np.array_equal(p_g, p_e)
    assert log["accum"] == [] and log["steady"] == []
    assert set(pipe._graphs) == {"steady", "accum", "init_accum",
                                 "init_round", "init_round_aligned",
                                 "init_map"}
