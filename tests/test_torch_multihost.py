"""The global BA's windows over several ranks in the PyTorch port
(`voxelslam_tpu_torch.parallel.multihost`, the fleet of
`parallel.dist_gba`): the single-process pass-through, and four gloo
processes on the CPU, each running its share of one batch of windows,
against one process running the whole batch. This file imports no JAX:
the ranks are spawned processes that import it.

`assert_gba_close` holds two runs' edges and submaps to the tolerances of
tests/test_dist_gba.py:55-62 (tests/test_torch_fleet.py uses it too).
"""

import os
import pathlib
import pickle
import socket
import sys
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as tmp

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402
from voxelslam_tpu_torch import config as tconfig  # noqa: E402
from voxelslam_tpu_torch.gba import HbaRunner  # noqa: E402
from voxelslam_tpu_torch.parallel import multihost as mh  # noqa: E402

torch.set_num_threads(1)

P = 2048
RANKS = 4
GBA = dict(voxel_size=3.0, win_size=5, stride=2, total_max_iter=4)
N_KF = 11                     # 4 windows of 5 keyframes, stride 2


def runner_kw():
    return dict(kf_point_max=P, capacity=1 << 12, unique_max=1024,
                device="cpu")


def gba_cfg():
    return tconfig.SlamConfig(gba=tconfig.GBAConfig(**GBA))


def _get(o, k):
    return o[k] if isinstance(o, dict) else getattr(o, k)


def assert_gba_close(edges_a, submaps_a, edges_b, submaps_b):
    """The same edges (pairs, R within 2e-4, t within 2e-3, v6 within rtol
    0.3) and submaps (first pose within 2e-3, occupied cells within 32) in
    the same order: tests/test_dist_gba.py:55-62's tolerances. Records may
    be the port's objects or the JAX runner's dicts."""
    assert len(edges_a) == len(edges_b) > 0
    assert len(submaps_a) == len(submaps_b) > 0
    for a, b in zip(edges_a, edges_b):
        assert [_get(a, k) for k in ("id_a", "id_b", "ord_a", "ord_b")] == \
            [_get(b, k) for k in ("id_a", "id_b", "ord_a", "ord_b")]
        np.testing.assert_allclose(_get(a, "R"), _get(b, "R"), atol=2e-4)
        np.testing.assert_allclose(_get(a, "t"), _get(b, "t"), atol=2e-3)
        np.testing.assert_allclose(_get(a, "v6"), _get(b, "v6"), rtol=0.3)
    for a, b in zip(submaps_a, submaps_b):
        assert _get(a, "scan_id") == _get(b, "scan_id")
        np.testing.assert_allclose(_get(a, "p0"), _get(b, "p0"), atol=2e-3)
        assert abs(float(np.sum(_get(a, "mask")))
                   - float(np.sum(_get(b, "mask")))) < 32


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank, port, kfs, out_dir):
    """One rank: join the gloo group, stream the keyframes through a runner
    on the group's mesh, build a SlamSystem under the group, and write
    what it holds."""
    torch.set_num_threads(1)
    from voxelslam_tpu_torch.pipeline.system import SlamSystem
    try:
        joined = mh.ensure_distributed(
            init_method=f"tcp://127.0.0.1:{port}", world_size=RANKS,
            rank=rank)
        mesh = mh.global_win_mesh()
        runner = HbaRunner(gba_cfg(), mesh=mesh, **runner_kw())
        runner.bottom_up(kfs)
        sysm = SlamSystem(tconfig.small_test_config(), enable_gba=True,
                          device="cpu")
        res = dict(joined=joined, mesh=(mesh.size, mesh.rank),
                   system_mesh_size=sysm.gba.mesh.size,
                   edges=runner.edges1, submaps=runner.submaps,
                   log=runner.window_log)
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(res, f)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


@pytest.fixture(scope="module")
def keyframes():
    return chip_smoke.scene_keyframes(N_KF, P)[0]


@pytest.fixture(scope="module")
def ranks(keyframes, tmp_path_factory):
    """Four gloo processes, each with its rank's results."""
    out = str(tmp_path_factory.mktemp("ranks"))
    ctx = tmp.spawn(_rank_main, args=(_free_port(), keyframes, out),
                    nprocs=RANKS, join=False)
    deadline = time.monotonic() + 240
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail("the gloo ranks did not finish in 240 s")
    res = []
    for r in range(RANKS):
        with open(os.path.join(out, f"rank{r}.pkl"), "rb") as f:
            res.append(pickle.load(f))
    return res


def test_ensure_distributed_passes_through(monkeypatch):
    """No cluster in the environment: no group, and False."""
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    assert mh.ensure_distributed() is False
    assert not dist.is_initialized()


def test_global_win_mesh_single_process():
    """One process is no mesh by default, and a size-1 mesh (no group) for
    the one-card batched path."""
    assert not dist.is_initialized()
    assert mh.global_win_mesh() is None
    m = mh.global_win_mesh(min_devices=1)
    assert (m.size, m.rank, m.group) == (1, 0, None)


def test_gloo_ranks_match_single_process(ranks, keyframes):
    """One batch of 4 windows split over 4 ranks, one window each, then
    gathered: every rank holds the edges and submaps of the single process
    that ran the whole batch."""
    one = HbaRunner(gba_cfg(), mesh=mh.global_win_mesh(min_devices=1),
                    fleet_batch=RANKS, **runner_kw())
    one.bottom_up(keyframes)
    assert [w["Nw"] for w in one.window_log] == [RANKS]
    for r, res in enumerate(ranks):
        assert res["joined"] is True and res["mesh"] == (RANKS, r)
        assert [w["Nw"] for w in res["log"]] == [1]       # its own window
        assert len(res["submaps"]) == RANKS
        assert_gba_close(res["edges"], res["submaps"], one.edges1,
                         one.submaps)


def test_system_under_group_uses_the_mesh(ranks):
    """SlamSystem(enable_gba=True) under the 4-rank group wires the group's
    mesh into its runner, as the JAX system does with its devices."""
    assert [res["system_mesh_size"] for res in ranks] == [RANKS] * RANKS
