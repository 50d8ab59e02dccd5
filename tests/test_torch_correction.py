"""The odometry's loop-closure hooks against the JAX package:
`apply_correction` (with and without the gravity-joint `_g_reloc`),
`insert_keyframe_fixed`, and the per-scan clouds that `collect_clouds=True`
puts on every emitted ScanPose.

The JAX pipeline runs once, in a module fixture, over the box-room packets
of tests/test_torch_pipeline.py with clouds collected. After the last
packet it flushes its deferred emission, snapshots its carry, and runs
each hook from that snapshot; the port installs the same carry and runs
the same hook."""

import types

import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from voxelslam_tpu import config as jconfig
from voxelslam_tpu.pipeline import SlamPipeline as JPipeline
from voxelslam_tpu_torch import config as tconfig, convert
from voxelslam_tpu_torch.map import voxel_map as tvm
from voxelslam_tpu_torch.pipeline import SlamPipeline

from test_torch_helpers import n, to_np_dict, assert_level_close
from test_torch_pipeline import _config, _host_fields, _packets

torch.set_num_threads(1)

N_SCANS = 20
DX_R = Rotation.from_rotvec([0.004, -0.003, 0.03]).as_matrix()
DX_P = np.array([0.2, -0.1, 0.05])
# (state fields the hooks change, restored between JAX runs)
_MUTABLE = ("win", "mp", "levels", "x", "_gravity", "_last_p")


def _keyframes(poses):
    """Keyframe stand-ins (the hooks read cloud, mask, R0, p0) built from
    three emitted scans of the run."""
    return [types.SimpleNamespace(cloud=sp.cloud, mask=sp.cloud_mask,
                                  R0=sp.R, p0=sp.p)
            for sp in (poses[2], poses[4], poses[-1])]


def _state(pipe):
    return {"x": to_np_dict(pipe.x), "win": to_np_dict(pipe.win),
            "levels": [to_np_dict(lv) for lv in pipe.levels],
            "mp": np.array(pipe.mp), "gravity": np.array(pipe._gravity)}


@pytest.fixture(scope="module")
def jax_run():
    traj, packets = _packets(N_SCANS)
    pipe = JPipeline(_config(jconfig), collect_clouds=True)
    phases = [pipe.process_scan(*pkt).get("phase") for pkt in packets]
    pipe._flush_pending()
    assert pipe.init_done and pipe.win_count == pipe.cfg.lba.win_size - 1
    poses = list(pipe.scan_poses)
    snap = {k: getattr(pipe, k) for k in _MUTABLE}
    carry = {"x": to_np_dict(pipe.x),
             "levels": [to_np_dict(lv) for lv in pipe.levels],
             "win": to_np_dict(pipe.win), "mp": np.array(pipe.mp),
             "preints_dev": to_np_dict(pipe.preints_dev)}
    host = _host_fields(pipe)
    bufs = {k: getattr(pipe, k).copy()
            for k in ("scan_buf", "scan_mask", "scan_tr")}
    kfs = _keyframes(poses)
    after = {}
    for g_update in (False, True):
        for k, v in snap.items():
            setattr(pipe, k, v)
        pipe.apply_correction(DX_R, DX_P, g_update, kfs)
        after[g_update] = _state(pipe)
    for k, v in snap.items():
        setattr(pipe, k, v)
    pipe.insert_keyframe_fixed(kfs[0])
    after["keyframe"] = _state(pipe)
    return dict(packets=packets, phases=phases, poses=poses, carry=carry,
                host=host, bufs=bufs, kfs=kfs, after=after)


def _port_from_carry(jax_run):
    pipe = SlamPipeline(_config(tconfig), collect_clouds=True, device="cpu")
    host = dict(jax_run["host"])
    for f in ("_gravity", "_bg0"):
        host[f] = torch.as_tensor(host[f], dtype=torch.float32)
    pipe.load_carry(convert.carry_from_numpy(jax_run["carry"]), **host)
    for k, v in jax_run["bufs"].items():
        setattr(pipe, k, v.copy())
    return pipe


def _assert_state_close(pipe, want):
    for f in ("R", "p", "v", "g"):
        np.testing.assert_allclose(n(getattr(pipe.win, f)), want["win"][f],
                                   atol=1e-4, err_msg=f)
        np.testing.assert_allclose(n(getattr(pipe.x, f)), want["x"][f],
                                   atol=1e-4, err_msg=f)
    np.testing.assert_array_equal(n(pipe.mp), want["mp"])
    np.testing.assert_allclose(n(pipe._gravity), want["gravity"], atol=1e-4)
    for lj, lt in zip(want["levels"], pipe.levels):
        lj = convert.from_numpy(tvm.VoxelLevel, lj)
        assert_level_close(lj, lt)
        np.testing.assert_array_equal(n(lt.state), n(lj.state))


@pytest.mark.parametrize("g_update", [False, True])
def test_apply_correction_matches_jax(jax_run, g_update):
    """dx applied to the window, the live map rebuilt from three keyframes
    and the corrected window scans (and, with g_update, the window
    re-optimized with gravity): window, state and levels as JAX's."""
    pipe = _port_from_carry(jax_run)
    last_p = pipe._last_p.copy()
    pipe.apply_correction(DX_R, DX_P, g_update, jax_run["kfs"])
    _assert_state_close(pipe, jax_run["after"][g_update])
    np.testing.assert_allclose(pipe._last_p, DX_R @ last_p + DX_P,
                               atol=1e-9)
    if g_update:       # the gravity-joint solve moved the window
        moved = np.abs(jax_run["after"][True]["win"]["p"]
                       - jax_run["after"][False]["win"]["p"]).max()
        assert moved > 1e-4


def test_insert_keyframe_fixed_matches_jax(jax_run):
    """One keyframe folded into the fixed statistics with a touched-plane
    refresh: levels as JAX's, window unchanged."""
    pipe = _port_from_carry(jax_run)
    fix_n = [float(torch.sum(lv.fix.n)) for lv in pipe.levels]
    pipe.insert_keyframe_fixed(jax_run["kfs"][0])
    _assert_state_close(pipe, jax_run["after"]["keyframe"])
    added = float(np.sum(jax_run["kfs"][0].mask))
    for lv, before in zip(pipe.levels, fix_n):   # a full table drops a few
        assert before + 0.95 * added <= float(torch.sum(lv.fix.n)) \
            <= before + added


def test_insert_fixed_level_into_empty_map():
    """insert_fixed on an empty map: the fixed clusters are the points'
    per-voxel statistics, the running total equals them, and jour stamps
    the new voxels."""
    cfg = tconfig.MapConfig(capacities=(1 << 10, 1 << 11, 1 << 11),
                            unique_max=(512, 512, 1024))
    rng = np.random.default_rng(0)
    pts = torch.as_tensor(rng.uniform(-4, 4, (600, 3)), dtype=torch.float32)
    mask = torch.as_tensor(rng.random(600) > 0.1, dtype=torch.float32)
    levels, touched = tvm.insert_fixed_touched(
        tvm.empty_map(cfg), cfg, pts, torch.zeros(600), mask, 7.0)
    for lv, (slots, valid, dropped) in zip(levels, touched):
        assert int(dropped) == 0
        np.testing.assert_allclose(float(lv.fix.n.sum()), float(mask.sum()))
        np.testing.assert_array_equal(n(lv.tot.n), n(lv.fix.n))
        np.testing.assert_allclose(n(lv.tot.mu), n(lv.fix.mu), atol=0)
        s = slots[valid].long()
        assert torch.all(lv.jour[s] == 7.0) and torch.all(lv.occ[s])
        assert float(lv.win.n.abs().sum()) == 0.0


def test_scan_pose_clouds_match_jax(jax_run):
    """collect_clouds=True from a cold start: every emitted ScanPose
    carries its scan's downsampled body-frame cloud, as JAX's does."""
    pipe = SlamPipeline(_config(tconfig), collect_clouds=True, device="cpu")
    phases = [pipe.process_scan(*pkt).get("phase")
              for pkt in jax_run["packets"]]
    pipe._flush_pending()
    assert phases == jax_run["phases"]
    pj, pt = jax_run["poses"], pipe.scan_poses
    assert len(pt) == len(pj) >= N_SCANS - 11
    for a, b in zip(pt, pj):
        assert a.cloud.shape == b.cloud.shape
        np.testing.assert_array_equal(a.cloud_mask, b.cloud_mask)
        np.testing.assert_allclose(a.cloud, b.cloud, atol=1e-4)
        np.testing.assert_allclose(a.p, b.p, atol=5e-3)
        assert a.cloud_mask.sum() > 100
