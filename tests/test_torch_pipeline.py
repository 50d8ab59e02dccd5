"""The slice as a whole: `SlamPipeline.process_scan` of the port against
the JAX package's, on the simulator's box room at a tiny configuration.

The JAX pipeline runs once, in a module fixture the two parity tests
share: its
first steady scans compile for most of a minute on the CPU. Along the
way the fixture snapshots the carry (device state + host bookkeeping)
just before one steady scan and records what that scan's fused step
returned."""

import dataclasses

import numpy as np
import pytest
import torch

from voxelslam_tpu import config as jconfig
from voxelslam_tpu.io import simulator as sim
from voxelslam_tpu.pipeline import SlamPipeline as JPipeline
from voxelslam_tpu.utils.metrics import ate_rmse
from voxelslam_tpu_torch import config as tconfig, convert
from voxelslam_tpu_torch.pipeline import SlamPipeline
from voxelslam_tpu_torch.pipeline.odometry import CARRY_HOST_FIELDS

from test_torch_helpers import n, to_np_dict, assert_level_close

torch.set_num_threads(1)

N_SCANS = 16
STEP_SCAN = 13          # second steady scan (init completes at scan 11)
ATE_LIMIT = 0.10        # m (tests/test_pipeline_e2e.py)


def _config(mod):
    return mod.SlamConfig(
        map=mod.MapConfig(capacities=(1 << 11, 1 << 12, 1 << 12),
                          unique_max=(512, 512, 512)),
        odom=mod.OdometryConfig(point_max=512, imu_max=48, batch_scans=1,
                                stats_ring=1),
        lba=mod.LocalBAConfig(factor_max=256))


def _packets(n_scans, n_az=64, n_el=12):
    """bench.py's scene at 64x12 beams: box room, 200 Hz IMU, seed = scan
    index."""
    traj = sim.make_trajectory(duration=0.2 + 0.1 * (n_scans + 2), speed=1.2,
                               wobble=0.25, yaw_rate=0.3, ramp=1.2)
    normals, dsp = sim.box_room(half_extent=(14.0, 12.0, 3.5),
                                center=(4.0, 0.0, 1.0))
    out, t0 = [], 0.1
    for k in range(n_scans):
        scan = sim.lidar_scan(traj, t0, t0 + 0.1, normals, dsp, n_az=n_az,
                              n_el=n_el, noise=0.01, seed=k)
        hit = scan["hit"]
        ts = np.arange(t0 - 0.01, t0 + 0.1 + 1e-6, 1.0 / 200.0)
        imu = np.array([np.concatenate(traj.imu_at(x)) for x in ts])
        out.append((scan["points"][hit], scan["offsets"][hit], ts,
                    imu[:, 0:3], imu[:, 3:6], t0, t0 + 0.1))
        t0 += 0.1
    return traj, out


def _host_fields(pipe):
    out = {}
    for f in CARRY_HOST_FIELDS:
        v = getattr(pipe, f)
        if v is not None and not isinstance(v, (int, float, bool)):
            v = np.array(v)
        out[f] = v
    return out


@pytest.fixture(scope="module")
def jax_run():
    traj, packets = _packets(N_SCANS)
    pipe = JPipeline(_config(jconfig), collect_clouds=False)
    real = pipe._jit_megastep
    rec = {}

    def spy(*args):
        out = real(*args)
        if "carry" in rec and "out" not in rec:
            rec["out"] = [to_np_dict(o) if dataclasses.is_dataclass(o)
                          else [to_np_dict(lv) for lv in o]
                          if isinstance(o, tuple) else np.array(o)
                          for o in out[:6]]
        return out

    pipe._jit_megastep = spy
    phases = []
    for k, pkt in enumerate(packets):
        if k == STEP_SCAN:
            assert pipe.init_done
            rec["carry"] = {
                "x": to_np_dict(pipe.x),
                "levels": [to_np_dict(lv) for lv in pipe.levels],
                "win": to_np_dict(pipe.win), "mp": np.array(pipe.mp),
                "preints_dev": to_np_dict(pipe.preints_dev)}
            rec["host"] = _host_fields(pipe)
        phases.append(pipe.process_scan(*pkt).get("phase"))
    pipe.flush()
    assert "out" in rec
    return dict(traj=traj, packets=packets, phases=phases,
                poses=list(pipe.scan_poses), rec=rec)


def _ate(traj, poses):
    est = np.stack([sp.p for sp in poses])
    gt = np.stack([traj.state_at(sp.t)[1] for sp in poses])
    return float(ate_rmse(est, gt))


def test_one_steady_step_from_shared_carry(jax_run):
    """Install the JAX carry through `convert` and run the same packet
    through the port's process_scan: the fused step's stats (ok,
    matches, BA residuals, v6, emitted pose), next state and voxel tables
    match the JAX step's."""
    rec = jax_run["rec"]
    pipe = SlamPipeline(_config(tconfig), collect_clouds=False, device="cpu")
    host = dict(rec["host"])
    for f in ("_gravity", "_bg0"):
        host[f] = torch.as_tensor(host[f], dtype=torch.float32)
    pipe.load_carry(convert.carry_from_numpy(rec["carry"]), **host)
    out = pipe.process_scan(*jax_run["packets"][STEP_SCAN])
    assert out["phase"] == "odom"

    x_j, lv_j, win_j, mp_j, _, ring_j = rec["out"]
    ring_t = n(pipe._pending[0])
    # the port's row ends with one more count: the points the dedup
    # dropped past unique_max (none here)
    assert ring_t.shape == (1, pipe._stats_len) == (1, ring_j.shape[1] + 1)
    assert ring_t[0, -1] == 0.0
    a, b = ring_j[0], ring_t[0, :-1]
    assert a[0] == b[0] == 1.0                       # ok (divergence gate)
    assert abs(a[1] - b[1]) <= 2, (a[1], b[1])       # iEKF matches of ~500
    np.testing.assert_allclose(b[2], a[2], rtol=1e-3)        # nnt eig0
    np.testing.assert_allclose(b[3:5], a[3:5], rtol=1e-3)    # BA r0, r1
    np.testing.assert_allclose(b[5:11], a[5:11], rtol=1e-3)  # v6
    # emitted frame: t, R (9), p, v, bg, ba, g (f32 solves: 1e-4)
    np.testing.assert_allclose(b[11:], a[11:], atol=1e-4)

    np.testing.assert_array_equal(n(pipe.mp), mp_j)
    for f in ("R", "p", "v", "bg", "ba", "g"):
        np.testing.assert_allclose(n(getattr(pipe.x, f)), x_j[f], atol=1e-4,
                                   err_msg=f)
        np.testing.assert_allclose(n(getattr(pipe.win, f)), win_j[f],
                                   atol=1e-4, err_msg=f)
    ports = convert.carry_from_numpy({**rec["carry"], "levels": lv_j})
    for lj, lt in zip(ports["levels"], pipe.levels):
        assert_level_close(lj, lt)
        np.testing.assert_array_equal(n(lt.state), n(lj.state))


def test_process_scan_cold_start_matches_jax(jax_run):
    """Both pipelines from cold start over the same packets: the same
    phase sequence (IMU init, LIO init window, dynamic init, odometry),
    per-scan emitted poses within 5 mm of each other, and each side's
    ATE under the e2e bound."""
    pipe = SlamPipeline(_config(tconfig), collect_clouds=False, device="cpu")
    phases = [pipe.process_scan(*pkt).get("phase")
              for pkt in jax_run["packets"]]
    pipe.flush()
    assert phases == jax_run["phases"]
    assert phases.count("init_done") == 1 and "reset" not in phases
    pj, pt = jax_run["poses"], pipe.scan_poses
    assert len(pt) == len(pj) >= N_SCANS - 3
    np.testing.assert_allclose([s.t for s in pt], [s.t for s in pj],
                               atol=1e-6)
    dp = np.linalg.norm(np.stack([s.p for s in pt])
                        - np.stack([s.p for s in pj]), axis=1)
    assert dp.max() < 5e-3, dp
    dR = np.stack([s.R for s in pt]) - np.stack([s.R for s in pj])
    assert np.abs(dR).max() < 5e-3
    ate_j = _ate(jax_run["traj"], pj)
    ate_t = _ate(jax_run["traj"], pt)
    assert ate_j < ATE_LIMIT and ate_t < ATE_LIMIT, (ate_j, ate_t)
    assert abs(ate_t - ate_j) < 2e-3, (ate_j, ate_t)


def test_batched_dispatch_matches_per_scan():
    """`batch_scans` queues scans and runs them as one K-step call with
    deferred emission (the JAX package's lax.scan over the step): the
    same poses, bit for bit, as one step per scan."""
    traj, packets = _packets(N_SCANS + 3)
    poses = {}
    for K in (1, 4):
        cfg = _config(tconfig)
        cfg = dataclasses.replace(
            cfg, odom=dataclasses.replace(cfg.odom, batch_scans=K))
        pipe = SlamPipeline(cfg, collect_clouds=False, device="cpu")
        phases = [pipe.process_scan(*pkt).get("phase") for pkt in packets]
        pipe.flush()
        assert "reset" not in phases and phases.count("init_done") == 1
        poses[K] = pipe.scan_poses
    assert len(poses[4]) == len(poses[1]) >= N_SCANS
    for a, b in zip(poses[1], poses[4]):
        assert a.t == b.t
        np.testing.assert_array_equal(a.R, b.R)
        np.testing.assert_array_equal(a.p, b.p)
        np.testing.assert_array_equal(a.v6, b.v6)


def test_divergence_reset_starts_new_session():
    """Scans too sparse to constrain the pose fail the divergence gate;
    after `degrade_bound` of them in a row the pipeline resets into a
    new session (system_reset) and initializes again from the next
    good scans, keeping the IMU's gravity."""
    traj, packets = _packets(N_SCANS + 12)
    cfg = _config(tconfig)
    cfg = dataclasses.replace(
        cfg, odom=dataclasses.replace(cfg.odom, degrade_bound=2))
    pipe = SlamPipeline(cfg, collect_clouds=False, device="cpu")
    phases = []
    for k, pkt in enumerate(packets):
        if 13 <= k < 18:             # 20 points: the normal Gram's eig0 < 14
            pkt = (pkt[0][:20], pkt[1][:20]) + pkt[2:]
        phases.append(pipe.process_scan(*pkt).get("phase"))
    assert phases.count("reset") == 1, phases
    r = phases.index("reset")
    assert 13 < r <= 18 and phases[r + 1] == "init_accum", phases
    assert pipe.session == 1 and pipe._gravity is not None
    assert "init_done" in phases[r:], phases
    sessions = [sp.session for sp in pipe.scan_poses]
    assert sessions == sorted(sessions) and set(sessions) == {0, 1}


def test_batched_divergence_reset_returns_from_its_dispatch():
    """K = 4: the K-step call emits its own replay's rows, so the reset
    returns from the dispatch call whose row trips `degrade_bound` (not a
    dispatch later); the scans handed in after it start the new session's
    init (the first, over the last two sparse scans, fails its degeneracy
    gate: one more session), and the sessions of the emitted poses never
    go back."""
    traj, packets = _packets(N_SCANS + 26)
    cfg = _config(tconfig)
    cfg = dataclasses.replace(cfg, odom=dataclasses.replace(
        cfg.odom, degrade_bound=2, batch_scans=4))
    pipe = SlamPipeline(cfg, collect_clouds=False, device="cpu")
    oks = {}                     # a dispatch call -> its rows' ok flags
    run, call = pipe._run, [0]

    def watch(name, fn, carry, inputs):
        out = run(name, fn, carry, inputs)
        if name == "steady_k":
            oks[call[0]] = [bool(v > 0) for v in n(out[1][0])[:, 0]]
        return out
    pipe._run = watch
    phases = []
    for k, pkt in enumerate(packets):
        if 13 <= k < 18:             # 20 points: the normal Gram's eig0 < 14
            pkt = (pkt[0][:20], pkt[1][:20]) + pkt[2:]
        call[0] = k
        phases.append(pipe.process_scan(*pkt).get("phase"))
    assert phases.count("reset") == 1, phases
    r = phases.index("reset")
    # the host's hysteresis over the rows in dispatch order
    cnt, trip = 0, None
    for k in sorted(oks):
        for ok in oks[k]:
            cnt = max(0, cnt - 1) if ok else cnt + 1
            if cnt > cfg.odom.degrade_bound and trip is None:
                trip = k
    assert r == trip and r in oks, (r, trip, sorted(oks))
    assert phases[r + 1] == "init_accum", phases
    assert phases[r:].count("init_failed") == 1, phases
    assert pipe.session == 2 and "init_done" in phases[r:], phases
    assert phases[-1] == "odom" and pipe._gravity is not None
    sessions = [sp.session for sp in pipe.scan_poses]
    assert sessions == sorted(sessions) and set(sessions) == {0, 2}
