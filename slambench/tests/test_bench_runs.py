"""Whole runs of the harness on the CPU at a tiny size (`--device cpu`
skips the look for a card, `--shrink` cuts the sensor and the map): a
sound run is correct; each fault planted under the timed path makes
`correct` false; a cell added by files and entries alone runs with no
edit; the run refuses to start without a card or without the port."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from slambench import cell

ROOT = cell.ROOT
SHRINK = json.dumps({
    "config": {"overrides": {"odom": {"point_max": 1024},
                             "map": {"capacities": [8192, 32768],
                                     "unique_max": [1024, 1024]}},
               "sensor": {"n_az": 128, "n_el": 16}},
    "traffic": {"warm_scans": 24, "tail_scans": 30}})


def run(*args, cwd=ROOT, timeout=900):
    p = subprocess.run([sys.executable, "-m", "slambench.run", *args],
                       cwd=cwd, capture_output=True, text=True,
                       timeout=timeout,
                       env=dict(os.environ, PYTHONPATH=str(cwd),
                                OMP_NUM_THREADS="2", MKL_NUM_THREADS="2"))
    last = p.stdout.strip().splitlines()[-1] if p.stdout.strip() else ""
    return p, last


def tiny(*extra, workload="os1-live-walk", root=None, seed=5):
    args = ["--workload", workload, "--seed", str(seed), "--seconds", "3",
            "--trace", "0", "--device", "cpu", "--shrink", SHRINK, *extra]
    if root is not None:
        args += ["--root", str(root)]
    p, last = run(*args)
    assert p.returncode == 0, p.stderr[-3000:]
    return json.loads(last), p.stderr


def test_a_sound_run_is_correct():
    out, err = tiny()
    assert out["correct"] is True
    c = out["checks"]
    assert c["map_key_violations"]["value"] == 0
    assert c["map_total_gap"]["value"] < 1e-5
    assert c["pose_err_m"]["value"] < 0.05
    assert list(c)[-1] == "poses_missing"
    assert list(out)[-1] == "checks"
    assert err.strip().splitlines()[-1].startswith("check poses_missing")


@pytest.mark.parametrize("fault", ["stale", "half", "altered"])
def test_a_fault_makes_it_incorrect(fault):
    out, _ = tiny("--fault", fault)
    assert out["correct"] is False


def test_a_new_cell_needs_no_edit(tmp_path):
    """A throwaway cell: a traffic file, a metric reader and entries in a
    copy of BENCHMARK.json; the harness's code is the checkout's."""
    for sub in ("configs", "traffic", "metrics", "limits"):
        shutil.copytree(ROOT / "slambench" / sub, tmp_path / "slambench" / sub)
    b = json.load(open(ROOT / "BENCHMARK.json"))
    b["workloads"].append({"name": "os1-slow-walk", "chips": 1,
                           "config": "newer-college-os1-64",
                           "traffic": "slow-walk", "why": "a test"})
    b["per_layer"].append({"name": "extra.window_scans", "unit": "scans",
                           "better": "higher", "source": "program_counter",
                           "layer": "test", "moves": "pose_latency_p95_ms",
                           "workloads": ["os1-slow-walk"]})
    for m in b["end_to_end"]:
        if m["name"] == "pose_latency_p95_ms":
            m["workloads"].append("os1-slow-walk")
    json.dump(b, open(tmp_path / "BENCHMARK.json", "w"))
    t = json.load(open(ROOT / "slambench" / "traffic" / "live-walk.json"))
    t["rate_hz"] = 5.0
    json.dump(t, open(tmp_path / "slambench" / "traffic" / "slow-walk.json",
                      "w"))
    json.dump({"map_total_gap": 1e-5}, open(
        tmp_path / "slambench" / "limits" / "os1-slow-walk.json", "w"))
    (tmp_path / "slambench" / "metrics" / "extra.window_scans.py").write_text(
        "def read(run):\n    return len(run.window_scans)\n")
    out, _ = tiny(workload="os1-slow-walk", root=tmp_path)
    assert out["correct"] is True
    assert out["attempted"] == 15                  # 3 s at 5 Hz
    assert set(out["metrics"]) == {"pose_latency_p95_ms", "setup_s"}
    args = ["--workload", "os1-slow-walk", "--seed", "5", "--seconds", "3",
            "--trace", "1", "--device", "cpu", "--shrink", SHRINK,
            "--root", str(tmp_path)]
    p, last = run(*args)
    assert json.loads(last)["metrics"]["extra.window_scans"]["value"] == 15


def test_no_card_no_result():
    p, last = run("--workload", "os1-live-walk", "--seed", "1", "--seconds",
                  "1", "--trace", "0")
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert p.returncode != 0 and not last.startswith("{")


def test_without_the_port_no_result(tmp_path):
    shutil.copytree(ROOT / "slambench", tmp_path / "slambench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    p, last = run("--workload", "os1-live-walk", "--seed", "1", "--seconds",
                  "1", "--trace", "0", "--device", "cpu", cwd=tmp_path)
    assert p.returncode != 0 and not last.startswith("{")
