"""The batched generator (`slambench.sim`) against the frozen numpy
simulator (`slambench.simref`), at small sizes on the CPU."""

import json
import math

import numpy as np
import pytest
import torch

from slambench import cell, sim, simref

LEGS = [(3.0, 0.5), (2.0, -0.3)]


def test_trajectory_matches_the_loop():
    a = simref.make_waypoint_trajectory(LEGS, wobble=0.2, z_amp=0.05,
                                        still=0.5)
    b = sim.waypoint_trajectory(LEGS, wobble=0.2, z_amp=0.05, still=0.5)
    assert np.abs(a.Rs - b.Rs).max() < 1e-12
    assert np.abs(a.ps - b.ps).max() < 1e-12
    assert np.array_equal(a.ts, b.ts)


def test_imu_matches_the_loop():
    traj = simref.make_waypoint_trajectory(LEGS, wobble=0.2, still=0.5)
    a = simref.imu_stream(traj, 200, (0.01, 0, 0), (0, 0.1, 0), 0.01, 0.1,
                          seed=5)
    b = sim.imu_samples(traj, 200, (0.01, 0, 0), (0, 0.1, 0), 0.01, 0.1,
                        seed=5)
    for x, y in zip(a, b):
        assert np.abs(x - y).max() < 1e-12


@pytest.mark.parametrize("traffic", ["replay-revisit", "live-walk"])
def test_scans_match_the_column_raycast(traffic):
    """No noise: every decoded point of the batched raycast is the frozen
    simulator's, column by column, after the decoders' filter."""
    spec = json.load(open(cell.HERE / "traffic" / f"{traffic}.json"))
    scene = sim.scene_from_spec(spec["scene"])
    traj = simref.make_waypoint_trajectory(LEGS, wobble=0.2, still=0.5)
    tb = np.array([0.6, 0.7, 1.9, 4.3])
    te = tb + 0.1
    fov = (math.degrees(-0.4), math.degrees(0.3))   # lidar_scan's default
    pts, offs, counts, rays = sim.lidar_scans(
        traj, scene, tb, te, 64, 16, fov, device="cpu", seed=0, blind=0.7,
        filter_num=3)
    starts = np.concatenate([[0], np.cumsum(counts)])
    for k in range(len(tb)):
        r = simref.lidar_scan(traj, tb[k], te[k], scene, n_az=64, n_el=16)
        h = r["hit"]
        f = simref._finalize(r["points"][h].astype(np.float64),
                             r["offsets"][h].astype(np.float64),
                             np.zeros(h.sum()), 0.7, 3)
        assert rays[k] == h.sum()
        got = pts[starts[k]:starts[k + 1]]
        assert got.shape == f["points"].shape
        assert np.abs(got - f["points"]).max() < 1e-5
        assert np.abs(offs[starts[k]:starts[k + 1]] - f["offsets"]).max() \
            < 1e-7


def test_beam_pattern_is_the_sensors():
    d, ph = sim.beam_pattern(2000, 32, (-16.0, 15.0))
    el = np.degrees(np.arcsin(d[:, 2]))
    assert d.shape == (64000, 3)
    assert abs(el.min() + 16.0) < 1e-9 and abs(el.max() - 15.0) < 1e-9
    assert np.all(np.diff(ph.reshape(2000, 32)[:, 0]) > 0)


def test_extrinsic_puts_points_in_the_lidar_frame():
    """With the hesai extrinsic, R_ext p + t_ext taken to the world at the
    IMU's pose lands on a scene surface."""
    spec = json.load(open(cell.HERE / "traffic" / "replay-revisit.json"))
    scene = sim.scene_from_spec(spec["scene"])
    traj = simref.make_waypoint_trajectory(LEGS, wobble=0.2, still=0.5)
    R_ext = np.array([0, -1, 0, -1, 0, 0, 0, 0, -1.0]).reshape(3, 3)
    t_ext = np.array([-0.001, -0.00855, 0.055])
    tb = np.array([2.0])
    pts, offs, counts, _ = sim.lidar_scans(
        traj, scene, tb, tb + 0.1, 64, 16, (-16.0, 15.0), device="cpu",
        seed=0, extrinsic=(R_ext, t_ext))
    assert counts[0] == 64 * 16          # a closed room: every ray returns
    p = pts.astype(np.float64)
    _, phase = sim.beam_pattern(64, 16, (-16.0, 15.0))
    i = traj.index(tb[0] + phase * 0.1)
    w = np.einsum("nij,nj->ni", traj.Rs[i], p @ R_ext.T + t_ext) + traj.ps[i]
    dist = np.abs(w @ scene.normals.T + scene.ds).min(axis=1)
    assert dist.max() < 1e-4


def test_noise_is_seeded():
    spec = json.load(open(cell.HERE / "traffic" / "live-walk.json"))
    scene = sim.scene_from_spec(spec["scene"])
    traj = simref.make_waypoint_trajectory(LEGS, wobble=0.2, still=0.5)
    tb = np.array([1.0, 1.1])
    run = lambda seed: sim.lidar_scans(
        traj, scene, tb, tb + 0.1, 64, 16, (-16.6, 16.6), device="cpu",
        seed=seed, noise=0.02, dropout_at=60.0)
    a, b, c = run(2**31 + 7), run(2**31 + 7), run(3)
    assert np.array_equal(a[0], b[0])
    assert a[0].shape != c[0].shape or not np.array_equal(a[0], c[0])
    assert torch.Generator().manual_seed(2**33) is not None
