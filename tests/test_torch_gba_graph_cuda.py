"""The global BA's step graphs on the card (`HbaRunner(step_graphs=True)`:
each round, batched round and condense one CUDA graph replay) against the
eager rounds (`step_graphs=False`) on the same card, bitwise, with
deterministic algorithms off as a user runs them. This file imports no
JAX, so it runs where JAX is absent:

    python -m pytest -m cuda --noconftest -p no:cacheprovider tests/test_torch_gba_graph_cuda.py
"""

import pytest
import torch

from test_torch_multihost import P, chip_smoke, gba_cfg, runner_kw
from voxelslam_tpu_torch.gba import HbaRunner
from voxelslam_tpu_torch.ops import segment_add as sa
from voxelslam_tpu_torch.parallel.multihost import global_win_mesh

torch.set_num_threads(1)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    sa._library()                 # built before the first capture


def _run(graphed, kfs, fleet_batch=None):
    """bottom_up over kfs, then (without a mesh) the total BA; returns
    the runner, its edges and submaps as bytes, and the segment_add
    launches the run counted."""
    mesh = global_win_mesh(min_devices=1) if fleet_batch else None
    r = HbaRunner(gba_cfg(), mesh=mesh, fleet_batch=fleet_batch,
                  step_graphs=graphed, **dict(runner_kw(), device="cuda"))
    sa.counter.reset()
    r.bottom_up(kfs)
    if mesh is None:
        r.total_ba()
    torch.cuda.synchronize()
    return r, chip_smoke.gba_snapshot(r), sa.counter.launches


@pytest.mark.cuda
def test_graphed_windows_equal_eager_on_card():
    """Three windows dispatched ahead and the total BA: every edge and
    submap, and each window's rounds and phases, bitwise the eager
    runner's; each round one call of a captured graph (a capture at the
    first, replays after), and segment_add counted once per replay, so as
    often as the eager rounds launch it."""
    _card()
    kfs = chip_smoke.scene_keyframes(9, P)[0]
    torch.use_deterministic_algorithms(False)
    g, g_snap, g_seg = _run(True, kfs)
    e, e_snap, e_seg = _run(False, kfs)
    assert g_snap == e_snap and g.window_log == e.window_log
    assert len(g.submaps) == 3 and g.edges2
    assert all(s.graph is not None and s.capture_s > 0
               for s in g._graphs.values())
    assert sum(s.calls for k, s in g._graphs.items() if k[0] == "step") \
        == sum(w["rounds"] for w in g.window_log)
    assert g_seg == e_seg > 0


@pytest.mark.cuda
def test_graphed_fleet_equals_eager_on_card():
    """fleet_batch 2 (a full batch, then a padded one): the batched round
    and the batch's edges and condense as graphs, bitwise the eager
    fleet's."""
    _card()
    kfs = chip_smoke.scene_keyframes(9, P)[0]
    torch.use_deterministic_algorithms(False)
    g, g_snap, g_seg = _run(True, kfs, fleet_batch=2)
    e, e_snap, e_seg = _run(False, kfs, fleet_batch=2)
    assert g_snap == e_snap and g.window_log == e.window_log
    assert set(g._graphs) == {("batch", 2, 5, 1024), ("outputs", 2, 5)}
    assert g_seg == e_seg > 0
