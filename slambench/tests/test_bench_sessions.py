"""Prior sessions (`slambench.sessions`): the writer's files as the port
reads them back, and whole runs on the CPU of a tiny cell that names
prior sessions, added by files and `BENCHMARK.json` entries alone: its
live session joins a prior one and reads correct; the planted
`relocated` fault and a route that never meets a prior one make it
incorrect. The two cells of the checkout keep their streams and the
numbers their check compares."""

import copy
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from slambench import cell, sessions, sim
from slambench.shrink import merge

from .test_bench_runs import SHRINK

ROOT = cell.ROOT
CELL = "xt32-prior-tiny"
# a circuit of the replay floor's room (a 12 m lap from the origin); the
# prior session walks it once from the origin, the live one from its far
# side the other way round (turned by half a lap)
LAP = {"legs": [[10.0, 0.6283185307179586]], "speed": 1.2, "still": 1.0,
       "ramp": 1.0, "wobble": 0.15, "z_amp": 0.05}
TINY = {
    "config": {"system": {"enable_loop": True, "enable_gba": False,
                          "previous_maps": ["site0"]}},
    "traffic": {
        "prior_sessions": [dict(LAP, repeat=2, start=[0, 0, 0, 0],
                                scans=120)],
        "prior_error": {"t_m": 0.01, "yaw_deg": 0.05},
        "prior_v6": [1e-4, 1e-4, 1e-4, 1e-4, 1e-4, 1e-4],
        "prior_edges": {"radius_m": 2.0, "yaw_deg": 30.0, "every": 1},
        "trajectory": dict(LAP, repeat=3, start=[0.0, 3.8197, 0.0,
                                                 3.141592653589793]),
        "warm_scans": 44, "prewarm": [], "check_verify": 0,
        "check_verify_first": 0, "lap_scans": 0,
        "window_expect": {"keyframes": 0, "verified": 0,
                          "gba_windows": 0}}}


# runs the harness as `python -m slambench.run` does, and also copies
# each pose where the caller of `SlamSystem.process_scan` reads it, once
# the call that emitted it has returned; its last line says whether those
# are the poses the run recorded as emitted in the window
CALLER_POSES = """
import json, sys
import numpy as np
from slambench import drive, run
from voxelslam_tpu_torch.pipeline.system import SlamSystem

seen, caller, kept = [0], {}, {}
call = SlamSystem.process_scan
make = drive.run


def process_scan(self, *a, **kw):
    out = call(self, *a, **kw)
    ps = self.odom.scan_poses
    for e in range(seen[0], len(ps)):
        caller[e] = (np.array(ps[e].R, copy=True), np.array(ps[e].p, copy=True))
    seen[0] = len(ps)
    return out


def keep(*a, **kw):
    kept["run"] = made = make(*a, **kw)
    return made


SlamSystem.process_scan = process_scan
drive.run = keep
rc = run.main(sys.argv[1:])
r = kept["run"][0]
same = [all(np.array_equal(x, y) for x, y in
            zip(r.emitted_pose[j], caller[r.emit_index[j]]))
        for j in sorted(r.emitted_pose)]
print(json.dumps({"poses": len(same), "as_the_caller_reads": all(same)}))
sys.exit(rc)
"""


def run(*args, tmpdir=None, timeout=1200, caller_poses=False):
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="2",
               MKL_NUM_THREADS="2")
    if tmpdir is not None:
        env["TMPDIR"] = str(tmpdir)
    how = ["-c", CALLER_POSES] if caller_poses else ["-m", "slambench.run"]
    p = subprocess.run([sys.executable, *how, *args],
                       cwd=ROOT, capture_output=True, text=True,
                       timeout=timeout, env=env)
    last = p.stdout.strip().splitlines()[-1] if p.stdout.strip() else ""
    return p, last


def diagnostics(stdout: str) -> dict:
    return [json.loads(x) for x in stdout.splitlines()
            if x.startswith('{"points_handed_in"')][0]


def add_cell(root, name, config, traffic, base_config="hilti23-xt32",
             base_traffic="replay-revisit"):
    """A cell added under `root` by files alone: a configuration and a
    traffic file (each the checkout's `base_*` with `config` / `traffic`
    merged in), a limits file, and entries in a copy of BENCHMARK.json.
    The harness's code is the checkout's."""
    for sub in ("configs", "traffic", "metrics", "limits"):
        if not (root / "slambench" / sub).exists():
            shutil.copytree(ROOT / "slambench" / sub, root / "slambench" / sub)
    bpath = root / "BENCHMARK.json"
    b = json.load(open(bpath if bpath.exists() else ROOT / "BENCHMARK.json"))
    here = root / "slambench"
    c = merge(copy.deepcopy(json.load(open(
        here / "configs" / f"{base_config}.json"))), config)
    c["name"] = name
    json.dump(c, open(here / "configs" / f"{name}.json", "w"))
    t = merge(copy.deepcopy(json.load(open(
        here / "traffic" / f"{base_traffic}.json"))), traffic)
    json.dump(t, open(here / "traffic" / f"{name}.json", "w"))
    shutil.copy(here / "limits" / "xt32-replay-revisit.json",
                here / "limits" / f"{name}.json")
    b["configs"].append({"name": name, "source": c["source"],
                         "file": f"slambench/configs/{name}.json",
                         "reduced": [], "why": "a test"})
    b["workloads"].append({"name": name, "config": name, "traffic": name,
                           "chips": 1, "why": "a test"})
    json.dump(b, open(bpath, "w"))
    return name


def tiny_spec() -> dict:
    """SHRINK for the hesai configuration: three map levels, every point
    of a 128 x 16 sweep kept; the traffic's warm-up stays."""
    spec = json.loads(SHRINK)
    spec["config"]["overrides"] = {
        "odom": {"point_max": 2048},
        "map": {"capacities": [16384, 65536, 262144],
                "unique_max": [2048] * 3}}
    spec["traffic"] = {"tail_scans": 10}
    return spec


def tiny_run(root, *extra, traffic=None, seed=7):
    """The tiny prior-session cell, added under `root`, once on the CPU;
    its temporary files go to `root`/tmp."""
    add_cell(root, CELL, TINY["config"], merge(
        copy.deepcopy(TINY["traffic"]), traffic or {}))
    (root / "tmp").mkdir(exist_ok=True)
    p, last = run("--workload", CELL, "--seed", str(seed), "--seconds", "13",
                  "--trace", "0", "--device", "cpu", "--shrink",
                  json.dumps(tiny_spec()), "--root", str(root), *extra,
                  tmpdir=root / "tmp")
    assert p.returncode == 0, p.stderr[-3000:]
    return json.loads(last), p.stdout, p.stderr


def test_written_files_read_back_through_the_port(tmp_path):
    from voxelslam_tpu_torch.io import sessions as ses
    c = cell.load_cell("xt32-replay-revisit")
    merge(c.config, {"system": {"previous_maps": ["a", "b"]},
                     "sensor": {"n_az": 64, "n_el": 8}})
    leg = dict(LAP, repeat=1, scans=30)
    merge(c.traffic, {
        "prior_sessions": [dict(leg, start=[1.0, 2.0, 0.0, 0.3]),
                           dict(leg, start=[1.2, 2.1, 0.0, 0.35])],
        "prior_error": {"t_m": 0.02, "yaw_deg": 0.1},
        "prior_v6": [1e-4, 2e-4, 3e-4, 4e-5, 5e-5, 6e-5],
        "prior_edges": {"radius_m": 1.0, "yaw_deg": 30.0, "every": 1}})
    cfg = c.slam_config()
    pri = sessions.write(c, cfg, 2**31 + 11, "cpu", str(tmp_path))
    assert pri.edges and pri.bytes > 0
    for s, name in enumerate(pri.names):
        sps = ses.load_session(str(tmp_path / name))
        assert len(sps) == 30
        R = np.stack([sp.R for sp in sps])
        p = np.stack([sp.p for sp in sps])
        assert np.abs(p - pri.saved_p[s]).max() < 1e-6
        assert np.abs(R - pri.saved_R[s]).max() < 1e-6
        assert [len(sp.cloud) for sp in sps] == list(pri.points[s])
        assert np.allclose(sps[0].v6, [1e-4, 2e-4, 3e-4, 4e-5, 5e-5, 6e-5])
    # the first session defines F: its first pose is the origin, yaw 0
    assert np.abs(pri.saved_p[0][0]).max() < 1e-12
    assert abs(pri.saved_R[0][0][1, 0]) < 1e-12
    edges, absent = ses.read_edges(str(tmp_path / "edge.txt"), pri.names)
    assert not absent and len(edges) == len(pri.edges)
    for e, (a, b, ia, ib) in zip(edges, pri.edges):
        assert (e.id_a, e.id_b, e.ord_a, e.ord_b) == (a, b, ia, ib)
        Ra, pa = pri.truth(a, ia)
        Rb, pb = pri.truth(b, ib)
        assert np.abs(e.t - Ra.T @ (pb - pa)).max() < 1e-6
        assert np.abs(e.R - Ra.T @ Rb).max() < 1e-6
    # the clouds are the scene in the body frame at each scan's end
    sc = sim.scene_from_spec(c.traffic["scene"])
    R_t = pri.frame_R @ pri.gt_R[1][12]
    p_t = pri.frame_R @ pri.gt_p[1][12] + pri.frame_p
    w = sps[12].cloud.astype(np.float64) @ R_t.T + p_t
    assert np.median(np.abs(w @ sc.normals.T + sc.ds).min(axis=1)) < 0.03


@pytest.mark.parametrize("traffic", ["replay-revisit", "live-walk"])
def test_streams_keep_their_bits(traffic):
    """A trajectory with no `start`, or a zero one, is the same object, so
    both cells' streams are bitwise what they were; a start moves the
    trajectory rigidly and leaves the IMU's samples as they were."""
    spec = json.load(open(cell.HERE / "traffic" / f"{traffic}.json"))
    tj = spec["trajectory"]
    assert "start" not in tj
    a = sim.trajectory(tj)
    b = sim.trajectory(dict(tj, start=[0, 0, 0, 0]))
    for f in ("ts", "Rs", "ps", "vs", "omegas", "accs"):
        assert np.array_equal(getattr(a, f), getattr(b, f))
    c = sim.trajectory(dict(tj, start=[3.0, -2.0, 0.5, 1.1]))
    Rz = sim.yaw_matrix(1.1)
    assert np.abs(c.ps - (a.ps @ Rz.T + [3.0, -2.0, 0.5])).max() < 1e-12
    assert np.abs(c.Rs - Rz @ a.Rs).max() < 1e-12
    imu = [sim.imu_samples(t, 200, (0.01, 0, 0), (0, 0.1, 0), 0.0, 0.0,
                           seed=1, t1=3.0) for t in (a, c)]
    for x, y in zip(*imu):
        assert np.abs(x - y).max() < 1e-9
    sensor = dict(json.load(open(
        cell.HERE / "configs" / "hilti23-xt32.json"))["sensor"],
        n_az=64, n_el=8, blind=0.5, point_filter_num=1,
        extrinsic_R=np.eye(3).ravel().tolist(), extrinsic_t=[0, 0, 0])
    s1 = sim.make_stream(sensor, spec, 2**31 + 3, "cpu", n_scans=4)
    s2 = sim.make_stream(sensor, dict(spec, trajectory=dict(
        tj, start=[0, 0, 0, 0])), 2**31 + 3, "cpu", n_scans=4)
    for f in ("pts", "offsets", "imu_gyr", "imu_acc", "gt_R", "gt_p"):
        assert np.array_equal(getattr(s1, f), getattr(s2, f))


@pytest.mark.parametrize("workload", ["os1-live-walk", "xt32-replay-revisit"])
def test_cells_without_priors_compare_what_they_did(workload, tmp_path):
    """The checkout's cells compare the same numbers as before prior
    sessions existed, with the same values: each pose the check judges,
    taken as the odometry hands it out, is bitwise the pose the caller of
    `SlamSystem.process_scan` reads once the call has returned (where the
    check took it before prior sessions existed). They write no session
    directory."""
    tmp = tmp_path / "tmp"
    tmp.mkdir()
    spec = json.loads(SHRINK)
    if workload == "xt32-replay-revisit":
        spec = tiny_spec()
        spec["config"]["system"] = {"enable_gba": False}
        merge(spec["traffic"], {"warm_scans": 30, "prewarm": []})
    p, last = run("--workload", workload, "--seed", "5", "--seconds", "3",
                  "--trace", "0", "--device", "cpu", "--shrink",
                  json.dumps(spec), tmpdir=tmp, caller_poses=True)
    assert p.returncode == 0, p.stderr[-3000:]
    poses = json.loads(last)
    assert poses["poses"] > 0 and poses["as_the_caller_reads"], poses
    out = json.loads(p.stdout.strip().splitlines()[-2])
    want = ["points_truncated", "map_total_gap", "map_key_violations",
            "pose_err_m"]
    if workload == "xt32-replay-revisit":
        want += ["edge_err_m", "verify_mismatch"]
    assert list(out["checks"]) == want + ["plan_missed", "poses_missing"]
    diag = diagnostics(p.stdout)
    assert diag["prior_sessions"] is None
    assert "prior_sessions" not in diag["setup_parts"]
    assert not [f for f in os.listdir(tmp)
                if f.startswith("slambench-sessions-")]


def test_the_live_session_joins_a_prior_one(tmp_path):
    out, stdout, err = tiny_run(tmp_path)
    c = out["checks"]
    assert "reloc_err_m" in c, err[-3000:]
    assert out["correct"] is True, c
    diag = diagnostics(stdout)
    assert diag["setup_parts"]["prior_sessions"] > 0
    assert diag["prior_sessions"]["load_s"] > 0
    # the sessions' directory is gone after the run
    assert not os.listdir(tmp_path / "tmp")


def test_a_relocated_correction_is_incorrect(tmp_path):
    out, _, _ = tiny_run(tmp_path, "--fault", "relocated")
    assert out["correct"] is False
    assert out["checks"]["reloc_err_m"]["value"] > \
        out["checks"]["reloc_err_m"]["limit"]


def test_a_route_that_never_meets_a_prior_one_is_incorrect(tmp_path):
    """The live session walks the far end of the floor, where no prior
    route passes: nothing relocalizes, and the plan misses it."""
    out, _, err = tiny_run(tmp_path, traffic={"trajectory": {
        "start": [-11.0, -8.91, 0.0, 0.0]}})
    assert out["correct"] is False
    assert "reloc_err_m" not in out["checks"]
    assert out["checks"]["plan_missed"]["value"] >= 1
    assert "relocalized" in err
