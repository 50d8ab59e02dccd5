"""`lba.mgsize > 1` in the port against the JAX package: a BA burst
marginalizes `mgsize` frames and the window refills over the next
`mgsize - 1` scans without BA (`_mega_accum`, `_process_steady_accum`).

`SlamPipeline.process_scan` runs tests/test_torch_pipeline.py's box-room
packets at its tiny configuration with `mgsize=2` on both sides (the JAX
run once, in a module fixture)."""

import dataclasses

import numpy as np
import pytest
import torch

from voxelslam_tpu import config as jconfig
from voxelslam_tpu.pipeline import SlamPipeline as JPipeline
from voxelslam_tpu_torch import config as tconfig
from voxelslam_tpu_torch.pipeline import SlamPipeline

from test_torch_pipeline import ATE_LIMIT, _ate, _config, _packets

torch.set_num_threads(1)

N_SCANS = 22
MG = 2


def _mg_config(mod):
    cfg = _config(mod)
    return dataclasses.replace(cfg, lba=dataclasses.replace(cfg.lba,
                                                            mgsize=MG))


def _drive(pipe, packets):
    outs = [pipe.process_scan(*pkt) for pkt in packets]
    pipe.flush()
    return outs


@pytest.fixture(scope="module")
def jax_run():
    traj, packets = _packets(N_SCANS)
    pipe = JPipeline(_mg_config(jconfig), collect_clouds=False)
    outs = _drive(pipe, packets)
    return traj, packets, outs, list(pipe.scan_poses)


def test_mgsize2_process_scan_matches_jax(jax_run):
    """The same phase sequence and the same refill scans (`accum`), with
    their iEKF stats; per-scan poses within 5 mm of each other (the
    tolerance of tests/test_torch_pipeline.py) and ATE under 0.10 m on
    both sides."""
    traj, packets, jouts, jposes = jax_run
    pipe = SlamPipeline(_mg_config(tconfig), collect_clouds=False,
                        device="cpu")
    touts = _drive(pipe, packets)
    assert [o.get("phase") for o in touts] == [o.get("phase") for o in jouts]
    accum = [bool(o.get("accum")) for o in touts]
    assert accum == [bool(o.get("accum")) for o in jouts]
    assert sum(accum) >= 3 and "reset" not in [o.get("phase") for o in touts]
    for a, b in zip(touts, jouts):
        if a.get("accum"):
            assert a["ok"] == b["ok"]
            assert abs(a["matches"] - b["matches"]) <= 2
    assert len(pipe.scan_poses) == len(jposes) >= N_SCANS - 4
    np.testing.assert_allclose([s.t for s in pipe.scan_poses],
                               [s.t for s in jposes], atol=1e-6)
    dp = np.linalg.norm(np.stack([s.p for s in pipe.scan_poses])
                        - np.stack([s.p for s in jposes]), axis=1)
    assert dp.max() < 5e-3, dp
    dR = np.stack([s.R for s in pipe.scan_poses]) - np.stack(
        [s.R for s in jposes])
    assert np.abs(dR).max() < 5e-3
    ate_j, ate_t = _ate(traj, jposes), _ate(traj, pipe.scan_poses)
    assert ate_j < ATE_LIMIT and ate_t < ATE_LIMIT, (ate_j, ate_t)


def test_mgsize2_bursts_emit_mg_poses_and_refill():
    """After init, scans alternate between a refill (win_count W-2 ->
    W-1, no emission) and a BA burst that emits `mgsize` poses and drops
    win_count back to W-2; scan times stay in order."""
    _, packets = _packets(N_SCANS)
    cfg = _mg_config(tconfig)
    W = cfg.lba.win_size
    pipe = SlamPipeline(cfg, collect_clouds=False, device="cpu")
    seen = []
    for pkt in packets:
        before = len(pipe.scan_poses)
        out = pipe.process_scan(*pkt)
        pipe._flush_pending()
        if pipe.init_done and out.get("phase") == "odom":
            seen.append((bool(out.get("accum")),
                         len(pipe.scan_poses) - before, pipe.win_count))
    assert seen and all(s in ((True, 0, W - 1), (False, MG, W - MG))
                        for s in seen), seen
    assert {s[0] for s in seen} == {True, False}
    ts = [s.t for s in pipe.scan_poses]
    assert ts == sorted(ts)
