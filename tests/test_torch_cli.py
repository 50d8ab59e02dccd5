"""The port's command line (`python -m voxelslam_tpu_torch`, `cli.py`)
against the JAX package's: `info`, config overrides, `export`, a `demo`
run on both sides (the port with `--device cpu`), a `run` over a recorded
Hesai dataset written by chip_smoke.py's writer, and the refusal to run
without a device when CUDA is absent."""

import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from voxelslam_tpu import cli as jcli
from voxelslam_tpu.io import sessions as jses
from voxelslam_tpu_torch import cli as tcli
from voxelslam_tpu_torch.io import sessions as tses
from voxelslam_tpu_torch.pipeline.odometry import ScanPose

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
POSE_TOL = 5e-3         # m and quaternion entries (tests/test_torch_system.py)
# tests/test_cli.py's demo overrides
DEMO_OVERRIDES = {"map": {"capacities": [1 << 11, 1 << 12, 1 << 12],
                          "unique_max": [1024, 2048, 2048]},
                  "odom": {"point_max": 1024, "imu_max": 48,
                           "down_size": 0.4},
                  "lba": {"factor_max": 256}}


def run_cli(mod, argv):
    lines = []
    return mod.main(argv, log=lines.append), lines


@pytest.mark.parametrize("argv", [["info"], ["info", "hesai"],
                                  ["info", "velodyne"]])
def test_info_matches_jax(argv):
    rc, lines = run_cli(tcli, argv)
    assert (rc, lines) == run_cli(jcli, argv)
    assert rc == 0 and lines


@pytest.mark.parametrize("extra", [
    ["--preset", "hesai"], ["--preset", "default"], ["--tiny"],
    ["--preset", "ouster", "--lidar-type", "velodyne"]])
def test_config_overrides_match_jax(tmp_path, extra):
    """`--config` overrides over a preset (and --tiny, --lidar-type) give
    the JAX CLI's config field by field."""
    path = str(tmp_path / "ov.json")
    with open(path, "w") as f:
        json.dump(dict(DEMO_OVERRIDES, loop={"jud_default": 0.42}), f)
    argv = ["run", "ds", "--config", path] + extra
    t = tcli._build_config(tcli.build_parser().parse_args(argv))
    j = jcli._build_config(jcli.build_parser().parse_args(argv))
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.odom.point_max == 1024 and t.loop.jud_default == 0.42


def test_parser_device_option():
    """run and demo take --device (default cuda), passed to SlamSystem."""
    p = tcli.build_parser()
    assert p.parse_args(["demo"]).device == "cuda"
    assert p.parse_args(["run", "d", "--device", "cpu"]).device == "cpu"
    assert p.prog == "voxelslam-tpu-torch"


def test_export_round_trip(tmp_path):
    """export: a saved session -> TUM trajectory and PLY map, byte-identical
    to the JAX CLI's."""
    rng = np.random.default_rng(1)
    sps = [ScanPose(t=0.1 * i, R=np.eye(3), p=np.array([0.5 * i, 0.0, 1.0]),
                    v=np.zeros(3), v6=np.ones(6),
                    cloud=rng.uniform(-2, 2, (30, 3)).astype(np.float32),
                    cloud_mask=np.ones(30, np.float32), session=0)
           for i in range(5)]
    sdir = str(tmp_path / "sess0")
    tses.save_session(sdir, sps)
    out = {}
    for tag, mod in (("t", tcli), ("j", jcli)):
        traj, ply = str(tmp_path / f"{tag}.tum"), str(tmp_path / f"{tag}.ply")
        rc, lines = run_cli(mod, ["export", sdir, "--export-traj", traj,
                                  "--export-map", ply,
                                  "--max-map-points", "100"])
        assert rc == 0
        out[tag] = [open(p, "rb").read() for p in (traj, ply)]
    assert out["t"] == out["j"]
    rows = np.loadtxt(tmp_path / "t.tum")
    assert rows.shape == (5, 8)
    np.testing.assert_allclose(rows[:, 1], 0.5 * np.arange(5), atol=1e-6)
    assert b"element vertex 75" in out["t"][1]


def _ate(lines):
    txt = "\n".join(lines)
    return float(txt.split("ATE RMSE vs ground truth:")[1].split("m")[0])


def test_demo_matches_jax(tmp_path):
    """demo at tests/test_cli.py's overrides with --no-loop, the port on the
    CPU against the JAX CLI on the same argv: the same number of scan
    poses, poses within POSE_TOL, ATE < 0.15 m on both, the same session
    files."""
    cfg = str(tmp_path / "cfg.json")
    with open(cfg, "w") as f:
        json.dump(DEMO_OVERRIDES, f)
    res = {}
    for tag, mod, extra in (("t", tcli, ["--device", "cpu"]),
                            ("j", jcli, [])):
        argv = ["demo", "--scans", "25", "--preset", "default", "--config",
                cfg, "--no-loop", "--save-dir", str(tmp_path / f"{tag}maps"),
                "--session-name", "demo0", "--export-traj",
                str(tmp_path / f"{tag}.tum")] + extra
        rc, lines = run_cli(mod, argv)
        assert rc == 0
        res[tag] = dict(lines=lines, tum=np.loadtxt(tmp_path / f"{tag}.tum"),
                        files=sorted(os.listdir(tmp_path / f"{tag}maps"
                                                / "demo0")))
    t, j = res["t"], res["j"]
    assert t["lines"][0] == j["lines"][0]       # "finished: N scan poses"
    assert t["tum"].shape == j["tum"].shape and len(t["tum"]) > 15
    np.testing.assert_allclose(t["tum"], j["tum"], atol=POSE_TOL)
    assert _ate(t["lines"]) < 0.15 and _ate(j["lines"]) < 0.15
    assert t["files"] == j["files"] and "alidarState.txt" in t["files"]
    tb = tses.load_session(str(tmp_path / "tmaps" / "demo0"))
    jb = jses.load_session(str(tmp_path / "jmaps" / "demo0"))
    assert len(tb) == len(jb) == len(t["tum"])
    for a, b in zip(tb, jb):
        np.testing.assert_allclose(a.p, b.p, atol=POSE_TOL)
        # the de-skewed scan is downsampled after the pose moved it, so a
        # point near a voxel boundary may fall on either side
        assert abs(len(a.cloud) - len(b.cloud)) <= 0.01 * len(b.cloud)


def test_run_hesai_dataset(tmp_path):
    """run over a recorded Hesai dataset (structured .npy scans in the
    LiDAR frame, absolute stamps) at the hesai preset, shrunk, with GBA:
    rc 0, the session, PLY and TUM files written, and the trajectory on
    the simulator's truth."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from voxelslam_tpu_torch.utils.metrics import ate_rmse
    ds = str(tmp_path / "ds")
    traj, hits = chip_smoke.write_hesai_dataset(ds, 24, 64, 16)
    cfg = str(tmp_path / "small.json")
    with open(cfg, "w") as f:
        json.dump({"map": {"capacities": [1 << 12, 1 << 12, 1 << 13],
                           "unique_max": [2048, 2048, 4096]},
                   "odom": {"point_max": 1024, "imu_max": 48},
                   "lba": {"factor_max": 512}}, f)
    save, tum, ply = (str(tmp_path / n) for n in ("maps", "t.tum", "m.ply"))
    rc, lines = run_cli(tcli, ["run", ds, "--preset", "hesai", "--config",
                               cfg, "--gba", "--device", "cpu",
                               "--save-dir", save, "--session-name", "s0",
                               "--export-map", ply, "--export-traj", tum])
    assert rc == 0 and lines[0] == "processed 24 scans"
    rows = np.loadtxt(tum, ndmin=2)
    assert len(rows) == len(tses.load_session(os.path.join(save, "s0"))) > 10
    assert os.path.exists(os.path.join(save, "edge.txt"))
    gt = np.stack([traj.state_at(t)[1] for t in rows[:, 0]])
    assert ate_rmse(rows[:, 1:4], gt) < 0.10
    assert chip_smoke.ply_vertices(ply) > 0 and min(hits) == 1024


def test_demo_without_device_needs_cuda():
    """Without --device on a host without CUDA the CLI exits non-zero and
    names CUDA; it never carries on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is valid here")
    res = subprocess.run([sys.executable, "-m", "voxelslam_tpu_torch", "demo",
                          "--tiny", "--scans", "2"], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert "CUDA" in res.stderr and "ATE" not in res.stdout
