"""On the card (`-m cuda`; skipped where there is none): the control,
the program with TF32 matmuls (the precision just below the strict float32
the configurations state), makes `correct` false in both cells, at sizes a
test run holds; the same runs in float32 are correct.

    python -m pytest -m cuda slambench/tests/test_bench_cuda.py
"""

import json
import os
import subprocess
import sys

import pytest

from slambench import cell

pytestmark = pytest.mark.cuda

SHRINK = {
    "os1-live-walk": {"traffic": {"warm_scans": 30, "tail_scans": 40}},
    "xt32-replay-revisit": {
        "config": {"sensor": {"n_az": 1000}},
        "traffic": {"warm_scans": 120, "window_expect": {},
                    "check_verify_first": 0}},
}


@pytest.fixture(scope="module")
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")


def run(workload, seed, *extra):
    p = subprocess.run(
        [sys.executable, "-m", "slambench.run", "--workload", workload,
         "--seed", str(seed), "--seconds", "8", "--trace", "0",
         "--shrink", json.dumps(SHRINK[workload]), *extra],
        cwd=cell.ROOT, capture_output=True, text=True, timeout=900,
        env=dict(os.environ, PYTHONPATH=str(cell.ROOT)))
    assert p.returncode == 0, p.stderr[-3000:]
    return json.loads(p.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("workload", sorted(SHRINK))
def test_tf32_is_refused(card, workload):
    sound = run(workload, 2**31 + 11)
    control = run(workload, 2**31 + 11, "--control", "tf32")
    assert sound["correct"] is True
    assert control["correct"] is False
    gap = control["checks"]["map_total_gap"]
    assert gap["value"] > gap["limit"]
