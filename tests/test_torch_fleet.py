"""GBA windows batched on one card in the PyTorch port: `HbaRunner(mesh=...,
fleet_batch=...)` with the size-1 mesh of `global_win_mesh(min_devices=1)`
(`parallel.dist_gba.make_window_fleet`, `HbaRunner._batch_step`), on the
CPU at tests/test_torch_gba.py's shapes and keyframes.

Held: one batched round's map against each window's own, bitwise; the
batched stream against the port's single-window runner and the JAX
runner's single-window stream (tests/test_dist_gba.py:55-62's tolerances;
the JAX package's own slow test holds the JAX fleet to that stream); a
partial batch; windows that stop early stay frozen; the ops a batched
round dispatches; a checkpoint with a batch queued and one in flight.
"""

import dataclasses

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from voxelslam_tpu.config import SlamConfig as JSlamConfig, GBAConfig as JGBA
from voxelslam_tpu.gba import HbaRunner as JRunner
from voxelslam_tpu_torch import config as tconfig
from voxelslam_tpu_torch.core.tensors import tmap
from voxelslam_tpu_torch.gba import HbaRunner
from voxelslam_tpu_torch.parallel.multihost import global_win_mesh
from voxelslam_tpu_torch.pipeline.system import SlamSystem

from test_torch_gba import (GBA, N_KF, _runner_kw, jax_stream,
                            make_keyframes, port_cfg, port_kfs, round_params,
                            window_inputs)
from test_torch_helpers import t
from test_torch_multihost import assert_gba_close

torch.set_num_threads(1)


def fleet_runner(fleet_batch, cfg=None):
    return HbaRunner(cfg or port_cfg(), device="cpu",
                     mesh=global_win_mesh(min_devices=1),
                     fleet_batch=fleet_batch, **_runner_kw())


def single_runner():
    return HbaRunner(port_cfg(), device="cpu", **_runner_kw())


def leaves(tree):
    """The tensors of a tensor, Cluster or tuple of them."""
    out = []
    tmap(out.append, tree)
    return out


def batch_inputs(kfs, starts, W=5):
    """Windows kfs[s:s+W] for s in `starts`, stacked (Nw, W, ...)."""
    return tuple(np.stack(x) for x in zip(*(window_inputs(kfs[s:s + W], W)
                                            for s in starts)))


@pytest.fixture(scope="module")
def kfs():
    return make_keyframes(N_KF + 2)        # the first N_KF are the stream's


@pytest.fixture(scope="module")
def streams(kfs):
    """The JAX runner's single-window stream and the port's single-window
    and batched (fleet_batch 2: a full batch, then a padded one) streams
    over the first N_KF keyframes, each flushed."""
    jr = JRunner(JSlamConfig(gba=JGBA(**GBA)), **_runner_kw())
    _, _, jax_after = jax_stream(jr, kfs[:N_KF])
    single, fleet = single_runner(), fleet_runner(2)
    single.bottom_up(port_kfs(kfs[:N_KF]))
    fleet.bottom_up(port_kfs(kfs[:N_KF]))
    return dict(jax=jax_after, single=single, fleet=fleet)


def test_batched_round_map_is_each_windows_own(kfs):
    """Three windows in one round, the second at the fine phase's voxel
    size and gates: each window's map (table keys and occupancy, window
    clusters and noise records, running total, plane state, slab and
    eigenvalues, creation stamps), harvested factors and 3-iteration LM
    (poses, Hessian, residuals) are bitwise the ones it gets alone."""
    r = single_runner()
    coarse, _ = r._map_cfgs(5)
    cfg = port_cfg()
    starts, phase = (0, 2, 4), (0, 1, 0)
    inp = tuple(t(a) for a in batch_inputs(kfs, starts))
    gates = [t([round_params(cfg, p)[k] for p in phase]) for k in range(3)]
    levels, factors = r._round_map(coarse, 1024, *gates, *inp)
    lm = r._build_and_lm(coarse, 1024, *gates, *inp)
    for b, p in enumerate(phase):
        one = tuple(x[b] for x in inp)
        lv1, f1 = r._round_map(coarse, 1024, *round_params(cfg, p), *one)
        for field in dataclasses.fields(lv1[0]):
            for x, y in zip(leaves(getattr(levels[0], field.name)),
                            leaves(getattr(lv1[0], field.name))):
                assert torch.equal(x[b], y), (b, field.name)
        for x, y in zip(factors, f1):
            assert torch.equal(x[b], y), b
        assert torch.sum(f1[6]) > 10                  # planes were found
        lm1 = r._build_and_lm(coarse, 1024, *round_params(cfg, p), *one)
        for x, y in zip(lm, lm1):
            assert torch.equal(x[b], y), b


def test_bottom_up_fleet_batch_2_matches_single_and_jax(streams):
    """bottom_up at fleet_batch 2 over 3 windows (the second batch padded
    with a copy of its one window, whose results are thrown away): the
    edges and submaps of the port's single-window runner and of the JAX
    single-window stream, and the same pending keyframes."""
    fleet = streams["fleet"]
    assert [w["Nw"] for w in fleet.window_log] == [2, 2]
    assert len(fleet.submaps) == 3
    assert_gba_close(fleet.edges1, fleet.submaps, streams["single"].edges1,
                     streams["single"].submaps)
    ref = streams["jax"]
    assert_gba_close(fleet.edges1, fleet.submaps, ref["edges1"],
                     ref["submaps"])
    assert [k.scan_id for k in fleet._pending] == \
        [k["scan_id"] for k in ref["_pending"]]
    # one read a round for the whole batch, one at each harvest
    assert fleet.host_syncs == sum(w["rounds"] for w in fleet.window_log) + 2


def test_partial_batch_flushes_one_window(kfs):
    """One window queued under fleet_batch 2: nothing runs until flush,
    which pads the batch, runs it and keeps the one real window
    (tests/test_dist_gba.py:65-77's claim)."""
    runner = fleet_runner(2)
    outs = [runner.add_keyframe(k) for k in port_kfs(kfs[:5])]
    assert outs[-1] == dict(queued=1) and not runner.submaps
    out = runner.flush()
    assert out is not None and out["flushed"] == 1
    assert len(runner.submaps) == 1 and len(runner.edges1) > 0
    assert runner.window_log[-1]["Nw"] == 2


def test_stopped_windows_stay_frozen(kfs):
    """Two windows that stop after different numbers of rounds: the batch
    runs until the later one stops, and each window's results are bitwise
    those of its own window step, the earlier one's phase held at 2
    through the extra rounds (one more round would move its poses by over
    1e-3 and its r1 by about 20%)."""
    r = single_runner()
    inp = batch_inputs(kfs, (0, 2))
    alone = [r._window_step(*(t(a[b]) for a in inp), 1024) for b in (0, 1)]
    rounds = [w["rounds"] for w in r.window_log]
    assert rounds[0] != rounds[1]
    out = r._batch_step(*(t(a) for a in inp), 1024)
    log = r.window_log[-1]
    assert log["rounds"] == max(rounds)
    early = int(np.argmin(rounds))
    assert [ph[early] for ph in log["phases"][rounds[early] - 1:]] == \
        [2] * (max(rounds) - rounds[early] + 1)
    for b in (0, 1):
        for x, y in zip(out, alone[b]):
            assert torch.equal(x[b], y), b


class _CountOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


def test_batched_round_dispatches_as_many_ops(kfs):
    """One batched round (map, refit, harvest, 3 LM iterations) over 4
    windows dispatches at most 1.2 times the aten ops of the same round
    over 1: the windows share every op, none loops over them."""
    r = single_runner()
    coarse, _ = r._map_cfgs(5)
    cfg = port_cfg()
    counts = {}
    for nw in (1, 4):
        inp = tuple(t(a) for a in batch_inputs(kfs, (0, 2, 4, 6)[:nw]))
        gates = [t([round_params(cfg, 0)[k]] * nw) for k in range(3)]
        with _CountOps() as c:
            r._build_and_lm(coarse, 1024, *gates, *inp)
        counts[nw] = c.n
    assert counts[4] <= 1.2 * counts[1], counts


def _system(cfg):
    sysm = SlamSystem(cfg, enable_gba=True, device="cpu")
    sysm.gba = fleet_runner(2, cfg)
    return sysm


def test_checkpoint_with_batches_in_flight_resumes(kfs, tmp_path):
    """A checkpoint taken with one batch in flight and one window queued,
    resumed on the CPU into a system whose runner has the same mesh and
    width: the rest of the stream ends with the edges and submaps of the
    run that went on, within 5e-3."""
    cfg = dataclasses.replace(tconfig.small_test_config(),
                              gba=tconfig.GBAConfig(**GBA))
    pk = port_kfs(kfs)
    a = _system(cfg)
    for k in pk[:N_KF]:
        a.gba.add_keyframe(k)
    assert a.gba._fleet_inflight is not None and len(a.gba._win_queue) == 1
    path = str(tmp_path / "ckpt")
    a.save_checkpoint(path)
    b = _system(cfg)
    b.load_checkpoint(path)
    assert b.gba.mesh is a.gba.mesh or b.gba.mesh == a.gba.mesh
    for s in (a, b):
        for k in pk[N_KF:]:
            s.gba.add_keyframe(k)
        s.gba.flush()
    assert len(a.gba.submaps) == 4
    assert len(b.gba.edges1) == len(a.gba.edges1)
    for x, y in zip(b.gba.edges1 + b.gba.submaps,
                    a.gba.edges1 + a.gba.submaps):
        for k in ("R", "t", "v6", "R0", "p0", "cloud", "mask"):
            if hasattr(x, k):
                np.testing.assert_allclose(getattr(x, k), getattr(y, k),
                                           atol=5e-3)
