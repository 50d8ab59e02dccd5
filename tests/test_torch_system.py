"""The port's full system against the JAX package: `SlamSystem` runs the
short box-room drive of tests/test_system.py on both sides (the JAX run
once, in a module fixture); and the system's device resolution and the
options it does not port yet."""

import numpy as np
import pytest
import torch

from voxelslam_tpu import config as jconfig
from voxelslam_tpu.io import simulator as sim
from voxelslam_tpu.pipeline.system import SlamSystem as JSystem
from voxelslam_tpu.utils.metrics import ate_rmse
from voxelslam_tpu_torch import config as tconfig
from voxelslam_tpu_torch.pipeline import LoopPipeline, SlamSystem

torch.set_num_threads(1)


def _system_cfg(mod):
    return mod.SlamConfig(
        map=mod.MapConfig(capacities=(1 << 11, 1 << 12, 1 << 12),
                          unique_max=(1024, 2048, 2048)),
        odom=mod.OdometryConfig(point_max=1024, imu_max=48, down_size=0.4),
        lba=mod.LocalBAConfig(factor_max=256),
        loop=mod.LoopConfig(descriptor_near_num=5))


def _system_packets():
    traj = sim.make_trajectory(duration=3.6, speed=1.0, wobble=0.25,
                               yaw_rate=0.3, still=0.45)
    normals, dsp = sim.box_room(half_extent=(14.0, 12.0, 3.5),
                                center=(4.0, 0.0, 1.0))
    packets, t, k = [], 0.2, 0
    while t + 0.1 < 3.1:
        scan = sim.lidar_scan(traj, t, t + 0.1, normals, dsp, n_az=110,
                              n_el=12, noise=0.01, seed=k)
        hit = scan["hit"]
        ts = np.arange(t - 0.01, t + 0.1 + 1e-6, 1.0 / 200.0)
        imu = np.array([np.concatenate(traj.imu_at(ti)) for ti in ts])
        packets.append((scan["points"][hit], scan["offsets"][hit], ts,
                        imu[:, 0:3], imu[:, 3:6], t, t + 0.1))
        t += 0.1
        k += 1
    return traj, packets


def _drive(sysm, packets):
    phases = [sysm.process_scan(*pkt).get("phase") for pkt in packets]
    poses = sysm.finish()
    return phases, poses


@pytest.fixture(scope="module")
def system_run():
    traj, packets = _system_packets()
    jsys = JSystem(_system_cfg(jconfig))
    phases, poses = _drive(jsys, packets)
    return traj, packets, jsys, phases, poses


def test_slam_system_matches_jax(system_run):
    """Odometry + loop pipeline wired: the same phases and keyframes, poses
    within 5e-3, ATE under 0.10 m on both sides."""
    traj, packets, jsys, jphases, jposes = system_run
    tsys = SlamSystem(_system_cfg(tconfig), device="cpu")
    tphases, tposes = _drive(tsys, packets)
    assert tphases == jphases and "reset" not in tphases
    assert ([len(k) for k in tsys.loop.keyframes]
            == [len(k) for k in jsys.loop.keyframes])
    assert len(tsys.loop.keyframes[0]) >= 1
    assert len(tposes) == len(jposes) > 15
    for a, b in zip(tposes, jposes):
        np.testing.assert_allclose(a.p, b.p, atol=5e-3)
        np.testing.assert_allclose(a.R, b.R, atol=5e-3)
    gt = np.stack([traj.state_at(sp.t)[1] for sp in jposes])
    for poses in (tposes, jposes):
        assert ate_rmse(np.stack([sp.p for sp in poses]), gt) < 0.10
    assert tsys.corrections == jsys.corrections


def test_system_and_loop_need_cuda_without_device():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is valid here")
    cfg = tconfig.small_test_config()
    for make in (lambda: SlamSystem(cfg), lambda: LoopPipeline(cfg)):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
    sysm = SlamSystem(cfg, device="cpu")
    assert sysm.odom.device.type == sysm.loop.device.type == "cpu"


@pytest.mark.parametrize("kwargs,item", [
    (dict(enable_gba=True), "item 5"), (dict(previous_maps=["s0"]), "item 3"),
    (dict(savepath="maps"), "item 3")])
def test_system_unported_options_raise(kwargs, item):
    with pytest.raises(NotImplementedError, match=item):
        SlamSystem(tconfig.small_test_config(), device="cpu", **kwargs)


def test_system_unported_methods_raise():
    sysm = SlamSystem(tconfig.small_test_config(), device="cpu")
    for call, item in ((lambda: sysm.save(), "item 3"),
                       (lambda: sysm.save_checkpoint("c"), "item 6"),
                       (lambda: sysm.load_checkpoint("c"), "item 6"),
                       (lambda: sysm.finish(run_gba=True), "item 5")):
        with pytest.raises(NotImplementedError, match=item):
            call()
