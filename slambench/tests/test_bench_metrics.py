"""The metric arithmetic on hand-made runs: the closed-loop rate, the p95
from the due time, the idle share as a union of intervals, the roofline
bytes, the emission lag."""

import types

import numpy as np
import pytest

from slambench import cell, peaks, trace
from slambench.drive import Run


def read(name, run):
    return cell.metric_reader(name)(run)


def test_closed_loop_rate_counts_every_emitted_scan():
    r = Run(cell="c", seed=1, seconds=10, mode="closed", window_s=12.5,
            emitted_in_window=50)
    assert read("replay.scans_per_s", r) == pytest.approx(4.0)
    r.mode = "open"
    assert read("replay.scans_per_s", r) is None


def test_p95_is_taken_from_the_due_time():
    r = Run(cell="c", seed=1, seconds=10, mode="open")
    # 100 scans due every 0.1 s, each emitted 0.5 s after it was due, and
    # 10 late ones 2 s after: the feeder's own lateness does not hide them
    for k in range(100):
        r.due[k] = 0.1 * k
        r.emit_at[k] = 0.1 * k + (2.0 if k % 10 == 3 else 0.5)
    p95 = read("pose_latency_p95_ms", r)
    assert p95 == pytest.approx(1e3 * np.percentile(
        [2.0 if k % 10 == 3 else 0.5 for k in range(100)], 95))
    assert p95 > 1000.0


def test_emit_lag_counts_scans_handed_in():
    r = Run(cell="c", seed=1, seconds=1, mode="open")
    for k in range(10):
        r.due[k] = 0.0
        r.emit_call[k] = k + 7
    assert read("odometry.emit_lag_scans", r) == pytest.approx(7.0)


def test_idle_share_is_one_minus_the_union():
    # two streams overlapping: the sum (2.0) passes the window, the union
    # (1.5) does not
    iv = [(0.0, 1.0), (0.5, 1.5)]
    assert trace.union_length(iv) == pytest.approx(1.5)
    assert trace.union_length([(0, 1), (0.2, 0.3), (2, 3)]) == 2.0
    tr = types.SimpleNamespace(window_s=2.0, busy_s=trace.union_length(iv),
                               summary={"scans": 1})
    r = Run(cell="c", seed=1, seconds=1, mode="closed", trace=tr)
    assert read("device.idle_share", r) == pytest.approx(25.0)
    assert trace.idle_gaps(iv, 0.0, 2.0) == [(1.5, 2.0)]


def test_reduce_events_counts_kernels_launches_and_spans():
    class E:
        def __init__(self, name, dev, s, d):
            self._n, self._dev, self._s, self._d = name, dev, s, d

        def name(self):
            return self._n

        def device_type(self):
            return self._dev

        def start_ns(self):
            return self._s

        def duration_ns(self):
            return self._d
    ev = [E("accumulate_kernel", "DeviceType.CUDA", 0, 10),
          E("Memcpy HtoD", "DeviceType.CUDA", 5, 10),
          E("cudaGraphLaunch", "DeviceType.CPU", 0, 1),
          E("cudaLaunchKernel", "DeviceType.CPU", 0, 1),
          E("aten::add", "DeviceType.CPU", 0, 1),
          E("span:verify", "DeviceType.CPU", 20, 30),
          E("span:verify", "DeviceType.CUDA", 20, 30)]
    dev, by_name, kernels, launches, spans = trace.reduce_events(ev)
    assert kernels == 1 and launches == 2
    assert trace.union_length(dev) == 15
    assert spans == [(20, 50, "verify")]
    assert by_name["accumulate_kernel"] == 10


def test_moments_roofline_bytes():
    assert peaks.moments_bytes(1000, 3) == 1000 * 3 * 68
    s = dict(moments_s=1e-5, moments_bytes=peaks.moments_bytes(10000, 3),
             scans=1)
    tr = types.SimpleNamespace(summary=s)
    r = Run(cell="c", seed=1, seconds=1, mode="closed", trace=tr)
    v = read("kernel.moments_roofline.replay", r)
    assert v == pytest.approx(100 * 2.04e6 / 3.35e12 / 1e-5)
    assert read("kernel.moments_roofline.live", r) is None
    s["moments_s"] = 0.0
    assert read("kernel.moments_roofline.replay", r) is None
