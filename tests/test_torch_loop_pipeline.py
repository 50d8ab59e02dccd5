"""The port's loop pipeline against the JAX package on the synthetic drift
stream of tests/test_system.py (out and back along a corridor of the
simulator's scene, +y drift injected linearly), cut to the first 100 scan
poses: the JAX side fires its first correction at the last of them. Both
sides must create the same keyframes, find the same loop edges, fire the
correction at the same scan and write back the same poses. The JAX run
happens once, in a module fixture."""

import numpy as np
import pytest
import torch

from voxelslam_tpu import config as jconfig
from voxelslam_tpu.io import simulator as sim
from voxelslam_tpu.pipeline.loop import LoopPipeline as JLoop
from voxelslam_tpu.pipeline.odometry import ScanPose as JScanPose
from voxelslam_tpu_torch import config as tconfig
from voxelslam_tpu_torch.pipeline import LoopPipeline, ScanPose

torch.set_num_threads(1)

P = 2048                  # points per drift-stream scan
N_DRIFT = 100             # the JAX side corrects at scan 99
DRIFT_RATE = 0.5 / 140.0  # metres of +y drift per scan


def _yaw_R(a):
    return np.array([[np.cos(a), -np.sin(a), 0],
                     [np.sin(a), np.cos(a), 0], [0, 0, 1.0]])


def _drift_stream():
    """(true R, drifted p, cloud, mask) per scan, as tests/test_system.py
    makes them."""
    scene = sim.make_scene()
    poses = [(_yaw_R(0.0), np.array([0.1 * i, 0.0, 1.0])) for i in range(70)]
    poses += [(_yaw_R(np.pi), np.array([7.0 - 0.1 * i, 0.6, 1.0]))
              for i in range(70)]
    out = []
    dirs, _ = sim.scan_directions(140, 14)
    for k, (R, p) in enumerate(poses[:N_DRIFT]):
        pc, hit = sim.raycast(np.asarray(p, float), R, dirs, scene)
        body = pc[hit] + np.random.default_rng(k).normal(0, 0.01,
                                                         pc[hit].shape)
        cloud = np.zeros((P, 3), np.float32)
        mask = np.zeros(P, np.float32)
        m = min(len(body), P)
        cloud[:m], mask[:m] = body[:m], 1
        out.append((R, p + np.array([0, DRIFT_RATE * k, 0]), cloud, mask))
    return out


def _feed(lp, cls, stream):
    lp.new_session()
    corr = []
    for k, (R, p, cloud, mask) in enumerate(stream):
        c = lp.push(cls(t=0.1 * k, R=R.copy(), p=p.copy(), v=np.zeros(3),
                        v6=np.full(6, 1e-4), cloud=cloud, cloud_mask=mask,
                        session=0))
        if c is not None:
            corr.append((k, c))
    return corr


def _drift_cfg(mod):
    return mod.SlamConfig(loop=mod.LoopConfig(curr_halt=3,
                                              descriptor_near_num=5))


@pytest.fixture(scope="module")
def drift():
    stream = _drift_stream()
    jlp = JLoop(_drift_cfg(jconfig))
    jcorr = _feed(jlp, JScanPose, stream)
    return stream, jlp, jcorr


def test_loop_pipeline_matches_jax_on_drift_stream(drift):
    """Same keyframes, loop edges and correction scan; edge transforms,
    written-back poses and the correction within 1e-3."""
    stream, jlp, jcorr = drift
    tlp = LoopPipeline(_drift_cfg(tconfig), device="cpu")
    tcorr = _feed(tlp, ScanPose, stream)
    assert [k for k, _ in jcorr] == [N_DRIFT - 1]       # the JAX side fires
    assert [k for k, _ in tcorr] == [k for k, _ in jcorr]
    assert [len(k) for k in tlp.keyframes] == [len(k) for k in jlp.keyframes]
    key = lambda e: (e.id_a, e.id_b, e.ord_a, e.ord_b)
    assert [key(e) for e in tlp.lp_edges] == [key(e) for e in jlp.lp_edges]
    for et, ej in zip(tlp.lp_edges, jlp.lp_edges):
        np.testing.assert_allclose(et.R, ej.R, atol=1e-3)
        np.testing.assert_allclose(et.t, ej.t, atol=1e-3)
    for st, sj in zip(tlp.scan_poses[0], jlp.scan_poses[0]):
        np.testing.assert_allclose(st.R, sj.R, atol=1e-3)
        np.testing.assert_allclose(st.p, sj.p, atol=1e-3)
    (_, ct), (_, cj) = tcorr[0], jcorr[0]
    np.testing.assert_allclose(ct.dx_R, cj.dx_R, atol=1e-3)
    np.testing.assert_allclose(ct.dx_p, cj.dx_p, atol=1e-3)
    assert ct.g_update == cj.g_update is False
    assert ([kf.scan_id for kf in ct.map_keyframes]
            == [kf.scan_id for kf in cj.map_keyframes])
    # the burst removed most of the injected drift, as in the JAX test
    err = np.linalg.norm(tlp.scan_poses[0][-1].p - stream[-1][1]
                         + np.array([0, DRIFT_RATE * (N_DRIFT - 1), 0]))
    assert err < 0.5 * DRIFT_RATE * N_DRIFT
