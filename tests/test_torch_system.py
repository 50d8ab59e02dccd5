"""The port's full system against the JAX package: `SlamSystem` runs the
short box-room drive of tests/test_system.py on both sides, with GBA on
(`GBAConfig(win_size=2, stride=1)`). The JAX run happens once, in a
module fixture: its `finish(run_gba=False)` gives the poses without GBA,
a second `finish()` then runs the bottom-up flush, the total BA and the
top-down solve. The port's GBA run is a module fixture too; its session is
saved and reloaded. Also: the system's device resolution, a checkpoint
of a fresh system, and the multi-card GBA it does not port yet."""

import copy
import os

import numpy as np
import pytest
import torch

from voxelslam_tpu import config as jconfig
from voxelslam_tpu.gba import HbaRunner as JRunner
from voxelslam_tpu.io import simulator as sim
from voxelslam_tpu.pipeline.system import SlamSystem as JSystem
from voxelslam_tpu.utils.metrics import ate_rmse
from voxelslam_tpu_torch import config as tconfig
from voxelslam_tpu_torch.io import sessions as tses
from voxelslam_tpu_torch.loop import btc as tbtc
from voxelslam_tpu_torch.pipeline import LoopPipeline, SlamSystem

from test_torch_helpers import n, t

torch.set_num_threads(1)

POSE_TOL = 5e-3         # m and rotation entries, port against JAX


def _system_cfg(mod):
    return mod.SlamConfig(
        map=mod.MapConfig(capacities=(1 << 11, 1 << 12, 1 << 12),
                          unique_max=(1024, 2048, 2048)),
        odom=mod.OdometryConfig(point_max=1024, imu_max=48, down_size=0.4),
        lba=mod.LocalBAConfig(factor_max=256),
        loop=mod.LoopConfig(descriptor_near_num=5),
        gba=mod.GBAConfig(win_size=2, stride=1))


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


def _drive(sysm, packets, **finish_kw):
    phases = [sysm.process_scan(*pkt).get("phase") for pkt in packets]
    poses = sysm.finish(**finish_kw)
    return phases, poses


def _pose_arrays(poses):
    return (np.stack([sp.p for sp in poses]), np.stack([sp.R for sp in poses]))


@pytest.fixture(scope="module")
def system_run():
    """The JAX system with GBA on, driven once. Its GBA runner is the
    single-card one (mesh=None), as the JAX system builds it on one chip;
    the CPU test harness shows 8 virtual devices, which would select the
    sharded window fleet."""
    traj, packets = _system_packets()
    jsys = JSystem(_system_cfg(jconfig), enable_gba=True)
    jsys.gba = JRunner(jsys.cfg)
    phases, poses = _drive(jsys, packets, run_gba=False)
    before = copy.deepcopy(poses)
    gba_poses = jsys.finish()
    return dict(traj=traj, packets=packets, jsys=jsys, phases=phases,
                poses=before, gba_poses=gba_poses)


@pytest.fixture(scope="module")
def port_gba_run(system_run, tmp_path_factory):
    """The port with GBA on over the same packets; its live session saved
    under a temporary savepath."""
    savepath = str(tmp_path_factory.mktemp("maps"))
    tsys = SlamSystem(_system_cfg(tconfig), enable_gba=True, device="cpu",
                      savepath=savepath)
    phases, poses = _drive(tsys, system_run["packets"])
    tsys.save("run")
    return dict(tsys=tsys, phases=phases, poses=poses, savepath=savepath)


def test_slam_system_matches_jax(system_run):
    """Odometry + loop pipeline wired: the same phases and keyframes, poses
    within 5e-3, ATE under 0.10 m on both sides."""
    jsys, jposes = system_run["jsys"], system_run["poses"]
    tsys = SlamSystem(_system_cfg(tconfig), device="cpu")
    tphases, tposes = _drive(tsys, system_run["packets"])
    assert tphases == system_run["phases"] and "reset" not in tphases
    assert ([len(k) for k in tsys.loop.keyframes]
            == [len(k) for k in jsys.loop.keyframes])
    assert len(tsys.loop.keyframes[0]) >= 1
    assert len(tposes) == len(jposes) > 15
    for a, b in zip(tposes, jposes):
        np.testing.assert_allclose(a.p, b.p, atol=POSE_TOL)
        np.testing.assert_allclose(a.R, b.R, atol=POSE_TOL)
    gt = np.stack([system_run["traj"].state_at(sp.t)[1] for sp in jposes])
    for poses in (tposes, jposes):
        assert ate_rmse(np.stack([sp.p for sp in poses]), gt) < 0.10
    assert tsys.corrections == jsys.corrections
    assert tsys.gba is None


def test_system_gba_matches_jax(system_run, port_gba_run):
    """GBA on: the same windows (submaps), bottom-up and total-BA edges and
    loop edges as the JAX system, and `finish()` poses within 5e-3 of the
    JAX system's."""
    jsys, tsys = system_run["jsys"], port_gba_run["tsys"]
    assert port_gba_run["phases"] == system_run["phases"]
    assert len(tsys.gba.window_log) == len(tsys.gba.submaps) \
        == len(jsys.gba.submaps) >= 1
    assert len(tsys.gba.edges1) == len(jsys.gba.edges1) >= 1
    assert len(tsys.gba.edges2) == len(jsys.gba.edges2)
    assert len(tsys.loop.lp_edges) == len(jsys.loop.lp_edges)
    tp, tR = _pose_arrays(port_gba_run["poses"])
    jp, jR = _pose_arrays(system_run["gba_poses"])
    np.testing.assert_allclose(tp, jp, atol=POSE_TOL)
    np.testing.assert_allclose(tR, jR, atol=POSE_TOL)


def test_system_gba_finish_writes_back(port_gba_run):
    """`finish()` streams every keyframe into the GBA, drains it and runs
    the top-down solve: no window in flight, the bottom-up edges joined
    the loop pipeline's graph, the returned poses are the odometry's own
    objects (corrected in place), and every window's residual fell."""
    tsys = port_gba_run["tsys"]
    g = tsys.gba
    assert g._inflight_step is None and g._inflight_cond is None
    assert tsys._gba_consumed == {0: len(tsys.loop.keyframes[0])}
    assert all(any(e is f for f in tsys.loop.lp_edges) for e in g.edges1)
    assert port_gba_run["poses"] is tsys.odom.scan_poses
    assert len(tsys.loop.scan_poses) == 1 and all(
        a is b for a, b in zip(tsys.loop.scan_poses[0], tsys.odom.scan_poses))
    assert all(w["rounds"] >= 1 for w in g.window_log)
    p, R = _pose_arrays(port_gba_run["poses"])
    assert np.isfinite(p).all() and np.isfinite(R).all()


def test_finish_without_gba_leaves_it_idle(system_run):
    """`finish(run_gba=False)` flushes the odometry and the loop pipeline
    but runs no window; with loop closure off there is no GBA at all."""
    tsys = SlamSystem(_system_cfg(tconfig), enable_gba=True, device="cpu")
    _drive(tsys, system_run["packets"][:14], run_gba=False)
    assert tsys.gba is not None and not tsys.gba.window_log
    assert SlamSystem(_system_cfg(tconfig), enable_loop=False,
                      enable_gba=True, device="cpu").gba is None


def test_system_save_round_trip(port_gba_run):
    """save(): the live session's directory holds alidarState.txt with
    every scan's pose (within 1e-5, as tests/test_sessions.py: 7 decimals
    of a quaternion from an f32 rotation) and one cloud per
    scan; edge.txt holds every loop edge after finish."""
    tsys, d = port_gba_run["tsys"], port_gba_run["savepath"]
    sps = tsys.loop.scan_poses[0]
    back = tses.load_session(os.path.join(d, "run"))
    assert len(back) == len(sps) > 15
    for a, b in zip(back, sps):
        np.testing.assert_allclose(a.p, b.p, atol=1e-5)
        np.testing.assert_allclose(a.R, b.R, atol=1e-5)
        assert len(a.cloud) == int(b.cloud_mask.sum())
    edges, absent = tses.read_edges(os.path.join(d, "edge.txt"), ["run"])
    assert len(edges) == len(tsys.loop.lp_edges) >= 1 and not absent


def test_system_previous_maps_reload(port_gba_run):
    """A new system with `previous_maps=["run"]`: the saved session is
    searchable session 0 with floor(scans / win_size) keyframes and its
    loop edges, the live session is session 1, and a query from a
    reloaded keyframe finds a candidate in its descriptor database."""
    tsys, d = port_gba_run["tsys"], port_gba_run["savepath"]
    cfg = _system_cfg(tconfig)
    re = SlamSystem(cfg, device="cpu", savepath=d, previous_maps=["run"])
    assert re.session_names == ["run", "live1"]
    assert re.loop.cur_session == 1
    n_scans = len(tsys.loop.scan_poses[0])
    assert len(re.loop.keyframes[0]) == n_scans // cfg.lba.win_size >= 1
    assert len(re.loop.lp_edges) == len(tsys.loop.lp_edges)
    kf = re.loop.keyframes[0][-1]
    desc = {k: n(v) for k, v in tbtc.extract(t(kf.cloud), t(kf.mask),
                                              re.loop.btc_cfg).items()}
    assert re.loop.dbs[0].search(desc, skip_near=-1, current_frame=1 << 30)


def test_system_and_loop_need_cuda_without_device():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is valid here")
    cfg = tconfig.small_test_config()
    for make in (lambda: SlamSystem(cfg), lambda: LoopPipeline(cfg)):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
    sysm = SlamSystem(cfg, device="cpu")
    assert sysm.odom.device.type == sysm.loop.device.type == "cpu"


def test_system_gba_runs_on_the_system_device():
    sysm = SlamSystem(tconfig.small_test_config(), enable_gba=True,
                      device="cpu")
    assert sysm.gba.device.type == "cpu"
    assert (sysm.gba.kf_point_max, sysm.gba._capacity,
            sysm.gba._unique_max) == (8192, 1 << 13, 4096)


def test_system_unported_methods_raise(tmp_path):
    """Checkpoints are ported (tests/test_torch_checkpoint.py holds them to
    bitwise resumes): a fresh system's snapshot loads into another. GBA
    windows over several cards are not, and still raise."""
    sysm = SlamSystem(tconfig.small_test_config(), device="cpu")
    path = str(tmp_path / "c")
    sysm.save_checkpoint(path)
    re = SlamSystem(tconfig.small_test_config(), device="cpu")
    re.load_checkpoint(path)
    assert re.session_names == sysm.session_names and not re.scan_poses
    from voxelslam_tpu_torch.gba.hba import HbaRunner
    with pytest.raises(NotImplementedError, match="item 7"):
        HbaRunner(tconfig.small_test_config(), mesh=object(), device="cpu")
