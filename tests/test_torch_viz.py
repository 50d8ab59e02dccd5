"""The port's visualization export (`utils/viz.py`) against the JAX
package's: every file it writes is byte-identical for the same ScanPoses
(each side gets its own package's ScanPose, built from the same numpy
fields)."""

import os

import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from voxelslam_tpu.pipeline.odometry import ScanPose as JScanPose
from voxelslam_tpu.utils import viz as jviz
from voxelslam_tpu_torch.pipeline.odometry import ScanPose as TScanPose
from voxelslam_tpu_torch.utils import viz as tviz

torch.set_num_threads(1)


def _fields(n_scans=12, n_pts=300, seed=0):
    """Per-scan ScanPose fields: random rotations (some with a negative
    trace, the quaternion's other branch), sessions 0-2, masks with gaps."""
    rng = np.random.default_rng(seed)
    R = Rotation.from_rotvec(rng.normal(0, 1.5, (n_scans, 3))).as_matrix()
    out = []
    for i in range(n_scans):
        mask = (rng.random(n_pts) > 0.2).astype(np.float32)
        out.append(dict(
            t=100.0 + 0.1 * i, R=R[i].astype(np.float32),
            p=rng.normal(0, 5, 3).astype(np.float32),
            v=rng.normal(0, 1, 3).astype(np.float32),
            v6=rng.uniform(1e-6, 1e-3, 6).astype(np.float32),
            cloud=rng.uniform(-10, 10, (n_pts, 3)).astype(np.float32),
            cloud_mask=mask, session=i * 3 // n_scans))
    return out


def _poses(cls, fields):
    return [cls(**f) for f in fields]


def _same_file(a, b):
    with open(a, "rb") as fa, open(b, "rb") as fb:
        da, db = fa.read(), fb.read()
    assert da == db and len(da) > 0
    return da


@pytest.mark.parametrize("binary", [True, False])
def test_write_ply_bytes(tmp_path, binary):
    pts = np.random.default_rng(1).normal(0, 3, (257, 3))
    tviz.write_ply(str(tmp_path / "t" / "a.ply"), pts, binary=binary)
    jviz.write_ply(str(tmp_path / "j" / "a.ply"), pts, binary=binary)
    data = _same_file(tmp_path / "t" / "a.ply", tmp_path / "j" / "a.ply")
    assert data.startswith(b"ply\n") and b"element vertex 257" in data


def test_write_ply_colored_bytes(tmp_path):
    rng = np.random.default_rng(2)
    pts = rng.normal(0, 3, (100, 3)).astype(np.float32)
    col = rng.integers(0, 256, (100, 3)).astype(np.uint8)
    tviz.write_ply_colored(str(tmp_path / "t.ply"), pts, col)
    jviz.write_ply_colored(str(tmp_path / "j.ply"), pts, col)
    _same_file(tmp_path / "t.ply", tmp_path / "j.ply")


def test_export_trajectory_bytes(tmp_path):
    f = _fields()
    tviz.export_trajectory(str(tmp_path / "t.tum"), _poses(TScanPose, f))
    jviz.export_trajectory(str(tmp_path / "j.tum"), _poses(JScanPose, f))
    _same_file(tmp_path / "t.tum", tmp_path / "j.tum")
    rows = np.loadtxt(tmp_path / "t.tum")
    assert rows.shape == (12, 8)
    np.testing.assert_allclose(np.linalg.norm(rows[:, 4:], axis=1), 1.0,
                               atol=1e-6)


@pytest.mark.parametrize("max_points", [5_000_000, 700])
def test_export_map_bytes(tmp_path, max_points):
    """export_map, and merged_world_cloud's jump subsample when the merged
    cloud would pass max_points."""
    f = _fields()
    tp, jp = _poses(TScanPose, f), _poses(JScanPose, f)
    tviz.export_map(str(tmp_path / "t.ply"), tp, max_points=max_points)
    jviz.export_map(str(tmp_path / "j.ply"), jp, max_points=max_points)
    _same_file(tmp_path / "t.ply", tmp_path / "j.ply")
    cloud = tviz.merged_world_cloud(tp, max_points)
    assert np.array_equal(cloud, jviz.merged_world_cloud(jp, max_points))
    total = int(sum(x["cloud_mask"].sum() for x in f))
    assert len(cloud) <= max_points and (len(cloud) < total) == (
        max_points < total)
    assert tviz.merged_world_cloud([]).shape == (0, 3)


@pytest.mark.parametrize("max_points", [5_000_000, 900])
def test_export_map_sessions_bytes(tmp_path, max_points):
    f = _fields()
    tviz.export_map_sessions(str(tmp_path / "t.ply"), _poses(TScanPose, f),
                             max_points=max_points)
    jviz.export_map_sessions(str(tmp_path / "j.ply"), _poses(JScanPose, f),
                             max_points=max_points)
    data = _same_file(tmp_path / "t.ply", tmp_path / "j.ply")
    assert b"property uchar red" in data


class _System:
    """What SlamRecorder reads of a system: its emitted scan poses."""

    def __init__(self):
        self.scan_poses = []


def test_slam_recorder_directory(tmp_path):
    """A recorder streamed over the same scans writes the same files
    (per-scan clouds, trajectory every 3 scans, flush map), and clear()
    wipes them."""
    f = _fields(n_scans=8, n_pts=120)
    dirs = {}
    for tag, cls, viz in (("t", TScanPose, tviz), ("j", JScanPose, jviz)):
        sysm = _System()
        rec = viz.SlamRecorder(str(tmp_path / tag), every=3, save_scans=True)
        for i, x in enumerate(f):
            sysm.scan_poses.append(cls(**x))
            rec.on_scan(sysm, {"phase": "init" if i == 0 else "odom"})
        rec.flush(sysm)
        dirs[tag] = sorted(os.listdir(tmp_path / tag))
    assert dirs["t"] == dirs["j"]
    assert {"map.ply", "trajectory.txt", "scan_000002.ply"} <= set(dirs["t"])
    assert "scan_000001.ply" not in dirs["t"]
    for name in dirs["t"]:
        _same_file(tmp_path / "t" / name, tmp_path / "j" / name)
    tviz.SlamRecorder(str(tmp_path / "t")).clear()
    assert os.listdir(tmp_path / "t") == []
