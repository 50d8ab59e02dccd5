"""GBA windows batched on the card (`HbaRunner._round_map`/`_build_and_lm`
with a leading window axis, and the fleet at fleet_batch 2) against the
same batched path on the CPU. This file imports no JAX, so it runs where
JAX is absent:

    python -m pytest -m cuda --noconftest -p no:cacheprovider tests/test_torch_fleet_cuda.py
"""

import pytest
import torch

from test_torch_multihost import (P, assert_gba_close, chip_smoke, gba_cfg,
                                  runner_kw)
from voxelslam_tpu_torch.gba import HbaRunner
from voxelslam_tpu_torch.parallel.multihost import global_win_mesh

torch.set_num_threads(1)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _batch(kfs, starts, W=5):
    """Windows kfs[s:s+W], stacked: clouds, masks, Rs, ps, wmask."""
    import numpy as np
    win = [kfs[s:s + W] for s in starts]
    return (np.stack([[k.cloud for k in w] for w in win]).astype(np.float32),
            np.stack([[k.mask for k in w] for w in win]).astype(np.float32),
            np.stack([[k.R0 for k in w] for w in win]).astype(np.float32),
            np.stack([[k.p0 for k in w] for w in win]).astype(np.float32),
            np.ones((len(starts), W), np.float32))


@pytest.mark.cuda
def test_batched_round_on_card_matches_cpu():
    """One batched round over three windows, the second at the fine
    phase's voxel size and gates: the same table keys, occupancy and point
    counts as the CPU's, window means within 1e-4 m (the card's scatter
    adds sum in another order) and the round's poses (3 LM iterations on
    those sums) within 5e-3, tests/test_torch_system.py's bound between
    the card and the CPU."""
    _card()
    kfs = chip_smoke.scene_keyframes(9, P)[0]
    cfg = gba_cfg()
    g, m = cfg.gba, cfg.map
    gates = [(g.voxel_size, m.voxel_size, g.voxel_size),
             (g.min_eigen_value, m.min_eigen_value, g.min_eigen_value),
             (g.eigen_value_thr, m.plane_thr[0], g.eigen_value_thr)]
    out = {}
    for dev in ("cpu", "cuda"):
        kw = dict(runner_kw(), device=dev)
        r = HbaRunner(cfg, **kw)
        coarse, _ = r._map_cfgs(5)
        inp = [torch.as_tensor(a, device=dev) for a in _batch(kfs, (0, 2, 4))]
        gt = [torch.tensor(x, device=dev) for x in gates]
        levels, _ = r._round_map(coarse, 1024, *gt, *inp)
        lm = r._build_and_lm(coarse, 1024, *gt, *inp)
        out[dev] = (levels[0], [x.cpu() for x in lm[:2]])
    a, b = out["cpu"][0], out["cuda"][0]
    assert torch.equal(a.keys, b.keys.cpu()) and torch.equal(a.occ,
                                                             b.occ.cpu())
    assert torch.equal(a.win.n, b.win.n.cpu())
    torch.testing.assert_close(b.win.mu.cpu(), a.win.mu, atol=1e-4, rtol=0)
    for x, y in zip(out["cuda"][1], out["cpu"][1]):
        torch.testing.assert_close(x, y, atol=5e-3, rtol=0)


@pytest.mark.cuda
def test_fleet_on_card_matches_cpu():
    """bottom_up at fleet_batch 2 over 3 windows on the card and on the
    CPU: the same edges and submaps, within tests/test_dist_gba.py's
    tolerances."""
    _card()
    kfs = chip_smoke.scene_keyframes(9, P)[0]
    runs = {}
    for dev in ("cpu", "cuda"):
        r = HbaRunner(gba_cfg(), mesh=global_win_mesh(min_devices=1),
                      fleet_batch=2, **dict(runner_kw(), device=dev))
        r.bottom_up(kfs)
        runs[dev] = r
    assert_gba_close(runs["cuda"].edges1, runs["cuda"].submaps,
                     runs["cpu"].edges1, runs["cpu"].submaps)
