"""The port's host ingest against the JAX package's: the vendor decoders
(`io/decoders.py`, numpy and native paths), `sync_packages`, the native
bindings (`csrc/ingest.cpp`: structured decode, yaw times, host voxel
downsample), the prefetching `ScanLoader` (`csrc/loader.cpp`) and
`cli.iter_dataset`. Every comparison is exact (`np.array_equal`): both
packages run the same numpy code and the same C++ source on the same
inputs. The port builds its libraries with g++ into `build/torch_kernels/`;
the JAX package's builds `voxelslam_tpu/native/libvsingest.so` (ignored by
git, also built by tests/test_native.py)."""

import os

import numpy as np
import pytest
import torch

from voxelslam_tpu import cli as jcli
from voxelslam_tpu import native as jnative
from voxelslam_tpu.io import decoders as jdec
from voxelslam_tpu_torch import cli as tcli
from voxelslam_tpu_torch import native as tnative
from voxelslam_tpu_torch.io import decoders as tdec

torch.set_num_threads(1)


def _xyz(rng, n, lo=-30.0, hi=30.0):
    return rng.uniform(lo, hi, (3, n)).astype(np.float32)


def _rec(fields, n, rng):
    arr = np.zeros(n, np.dtype([("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
                                ("intensity", "<f4")] + fields))
    arr["x"], arr["y"], arr["z"] = _xyz(rng, n)
    arr["intensity"] = rng.uniform(0, 255, n)
    return arr


def _layout(name, n=3000, seed=0):
    """One scan's structured array in the named vendor layout."""
    rng = np.random.default_rng(seed)
    if name == "livox_u4_ns":
        a = _rec([("offset_time", "<u4")], n, rng)
        a["offset_time"] = (rng.uniform(0, 0.1, n) * 1e9).astype(np.uint32)
    elif name == "livox_float":
        a = _rec([("offset_time", "<f8")], n, rng)
        a["offset_time"] = rng.uniform(0, 0.1, n) * 1e9
    elif name == "velodyne_s":
        a = _rec([("time", "<f4")], n, rng)
        a["time"] = rng.uniform(0, 0.1, n)
    elif name == "velodyne_us":
        a = _rec([("time", "<f4")], n, rng)
        a["time"] = rng.uniform(0, 0.1, n) * 1e6
    elif name == "velodyne_ns":
        a = _rec([("time", "<f8")], n, rng)
        a["time"] = rng.uniform(0, 0.1, n) * 1e9
    elif name == "velodyne_yaw":
        a = _rec([("ring", "<u2")], n, rng)
    elif name == "ouster_u4_ns":
        a = _rec([("t", "<u4")], n, rng)
        a["t"] = (rng.uniform(0, 0.1, n) * 1e9).astype(np.uint32)
    elif name in ("hesai", "robosense"):
        a = _rec([("timestamp", "<f8"), ("ring", "<u2")], n, rng)
        a["timestamp"] = 1.7e9 + rng.uniform(0, 0.12, n)
    elif name == "tartanair":
        a = _rec([], n, rng)
    else:
        raise ValueError(name)
    return a


LAYOUTS = {  # layout -> lidar type
    "livox_u4_ns": "livox", "livox_float": "livox",
    "velodyne_s": "velodyne", "velodyne_us": "velodyne",
    "velodyne_ns": "velodyne", "velodyne_yaw": "velodyne",
    "ouster_u4_ns": "ouster", "hesai": "hesai", "robosense": "robosense",
    "tartanair": "tartanair",
}


def _same_decode(a, b):
    assert sorted(a) == sorted(b) == ["intensity", "offsets", "points"]
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        assert np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize("use_native", [True, False])
@pytest.mark.parametrize("blind,pfn", [(0.5, 1), (8.0, 3)])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_decode_matches_jax(layout, blind, pfn, use_native):
    """`decode` equals the JAX package's exactly for every vendor layout,
    through the native decoder and the numpy path, with the blind radius
    and 1-in-N decimation applied."""
    arr = _layout(layout, seed=len(layout))
    kw = dict(blind=blind, point_filter_num=pfn, use_native=use_native)
    out = tdec.decode(arr, LAYOUTS[layout], **kw)
    _same_decode(out, jdec.decode(arr, LAYOUTS[layout], **kw))
    r = np.linalg.norm(out["points"], axis=1)
    assert r.min() > blind and len(out["points"]) > 100
    assert np.all(np.diff(out["offsets"]) >= 0)
    assert out["offsets"].max() <= jdec.MAX_OFFSET_S


@pytest.mark.parametrize("use_native", [True, False])
@pytest.mark.parametrize("lidar_type", ["hesai", "livox", "velodyne"])
def test_decode_empty_scan_dummy_points(lidar_type, use_native):
    """A scan with no point past the blind radius decodes to the two dummy
    points (reference voxelslam.hpp:82), as in the JAX package."""
    layout = {"hesai": "hesai", "livox": "livox_u4_ns",
              "velodyne": "velodyne_s"}[lidar_type]
    arr = _layout(layout, n=200, seed=5)
    arr["x"] *= 0.01
    arr["y"] *= 0.01
    arr["z"] *= 0.01
    kw = dict(blind=2.0, use_native=use_native)
    out = tdec.decode(arr, lidar_type, **kw)
    _same_decode(out, jdec.decode(arr, lidar_type, **kw))
    assert np.array_equal(out["points"], np.zeros((2, 3), np.float32))


def test_decode_rejects_unknown_type():
    with pytest.raises(ValueError, match="unknown lidar type"):
        tdec.decode(_layout("tartanair", n=10), "sick")


def _stream(n_scans, seed=0):
    """(scans, imu rows) of a short stream, 200 Hz IMU from 9.9 s."""
    rng = np.random.default_rng(seed)
    scans = []
    for k in range(n_scans):
        t0 = 10.0 + 0.1 * k
        scans.append(dict(points=_xyz(rng, 50).T.copy(),
                          offsets=np.sort(rng.uniform(0, 0.1, 50)).astype(
                              np.float32), t_beg=t0, t_end=t0 + 0.1))
    ts = np.arange(9.9, 10.0 + 0.1 * n_scans + 0.02, 1.0 / 200.0)
    imu = [(t, rng.normal(0, 0.1, 3), rng.normal(0, 1.0, 3)) for t in ts]
    return scans, imu


def _sync_all(mod, scans, imu, point_notime):
    """Feed scans one at a time, drain packets, as iter_dataset does."""
    import copy
    scans, imu_q = copy.deepcopy(scans), list(imu)
    queue, state, out = [], {}, []
    for s in scans:
        queue.append(s)
        while (pkt := mod.sync_packages(queue, imu_q, point_notime=point_notime,
                                        state=state)) is not None:
            out.append(pkt)
    return out


def _same_packets(a, b):
    assert len(a) == len(b) > 0
    for p, q in zip(a, b):
        assert sorted(p) == sorted(q)
        for k in ("imu_ts", "imu_gyr", "imu_acc"):
            assert np.array_equal(p[k], q[k]), k
        assert sorted(p["scan"]) == sorted(q["scan"])
        for k, v in p["scan"].items():
            assert np.array_equal(v, q["scan"][k]), k


@pytest.mark.parametrize("point_notime", [False, True])
def test_sync_packages_matches_jax(point_notime):
    """The same packet sequence as the JAX `sync_packages`; with
    point_notime the first scan anchors the clock and yields no packet."""
    scans, imu = _stream(6)
    out = _sync_all(tdec, scans, imu, point_notime)
    _same_packets(out, _sync_all(jdec, scans, imu, point_notime))
    assert len(out) == (5 if point_notime else 6)
    with pytest.raises(ValueError, match="persistent"):
        tdec.sync_packages([dict(scans[0])], list(imu), point_notime=True)


# ---------------------------------------------------------------------------
# native bindings
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layout", ["livox_u4_ns", "hesai", "ouster_u4_ns"])
def test_decode_structured_matches_jax_native(layout):
    arr = _layout(layout, seed=11)
    tf = {"livox_u4_ns": ("offset_time",), "hesai": ("timestamp",),
          "ouster_u4_ns": ("t",)}[layout]
    kw = dict(time_fields=tf, t_scale=1.0 if layout == "hesai" else 1e-9,
              t_absolute=layout == "hesai", blind=1.0, point_filter_num=2,
              max_offset=0.11)
    a = tnative.decode_structured(arr, **kw)
    b = jnative.decode_structured(arr, **kw)
    assert len(a) == len(b) == 3
    for x, y in zip(a, b):
        assert np.array_equal(x, y)
    # a layout the decoder cannot read (no x/y/z of a known type)
    bad = np.zeros(4, [("x", "<f2"), ("y", "<f4"), ("z", "<f4")])
    assert tnative.decode_structured(bad) is None


def test_yaw_times_and_downsample_match_jax_native():
    rng = np.random.default_rng(2)
    ang = np.sort(rng.uniform(0, 2 * np.pi, 500))[::-1]
    pts = (np.stack([np.cos(ang), np.sin(ang), np.zeros_like(ang)], -1)
           * 10).astype(np.float32)
    a = tnative.yaw_times(pts)
    assert np.array_equal(a, jnative.yaw_times(pts))
    assert a[0] == 0.0 and np.all(np.diff(a) >= 0)
    cloud = rng.uniform(-8, 8, (20000, 3)).astype(np.float32)
    for voxel, cap in ((1.0, 1 << 20), (0.5, 1000)):
        d = tnative.voxel_downsample_host(cloud, voxel, cap)
        assert np.array_equal(d, jnative.voxel_downsample_host(cloud, voxel,
                                                               cap))
        assert 0 < len(d) <= cap


def test_native_available_and_build_errors(tmp_path, monkeypatch):
    """available() answers True once the ingest library is built; when its
    sources do not compile it raises with g++'s messages instead of
    answering False (nothing falls back to the numpy path)."""
    assert tnative.available() is True
    for name in tnative.SOURCES["ingest"]:
        (tmp_path / name).write_text("this is not C++\n")
    monkeypatch.setattr(tnative, "_CSRC", tmp_path)
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(tnative, "_libs", {})
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        tnative.available()
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        tdec.decode(_layout("hesai", n=10), "hesai")


# ---------------------------------------------------------------------------
# prefetching loader and iter_dataset
# ---------------------------------------------------------------------------

def _write_dataset(d, kind, n_scans=5, n_pts=3000, seed=7):
    """A dataset directory (imu.txt, scans.txt, one .npy per scan) whose
    scans are plain (N,3) or (N,4) float32 arrays, or Hesai records."""
    os.makedirs(d, exist_ok=True)
    rng = np.random.default_rng(seed)
    rows = []
    for k in range(n_scans):
        t0 = 10.0 + 0.1 * k
        if kind == "hesai":
            arr = _layout("hesai", n_pts, seed=seed + k)
            arr["timestamp"] = t0 + rng.uniform(0, 0.1, n_pts)
        else:
            arr = np.zeros((n_pts, kind), np.float32)
            arr[:, :3] = rng.uniform(-30, 30, (n_pts, 3))
            if kind == 4:
                arr[:, 3] = rng.uniform(0, 0.1, n_pts)
        np.save(os.path.join(d, f"scan_{k:04d}.npy"), arr)
        rows.append((t0, t0 + 0.1, f"scan_{k:04d}.npy"))
    with open(os.path.join(d, "scans.txt"), "w") as f:
        f.writelines(f"{tb:.3f} {te:.3f} {fn}\n" for tb, te, fn in rows)
    ts = np.arange(9.9, 10.0 + 0.1 * n_scans + 0.05, 1.0 / 200.0)
    np.savetxt(os.path.join(d, "imu.txt"),
               np.column_stack([ts, rng.normal(0, 0.1, (len(ts), 6))]))
    return rows


@pytest.mark.parametrize("kind", [3, 4, "hesai"])
def test_scan_loader_matches_jax_and_inline(tmp_path, kind):
    """The port's ScanLoader gives exactly the JAX ScanLoader's scans and
    the port's inline path's points and offsets."""
    d = str(tmp_path / "ds")
    rows = _write_dataset(d, kind)
    lt = "hesai" if kind == "hesai" else "tartanair"
    full = [(tb, te, os.path.join(d, fn)) for tb, te, fn in rows]
    kw = dict(blind=1.0, point_filter_num=2)
    tl = tnative.ScanLoader(full, lt, **kw)
    jl = jnative.ScanLoader(full, lt, **kw)
    assert len(tl) == len(jl) == len(rows)
    got = list(tl)
    for a, b, (tb, te, path) in zip(got, jl, full):
        assert sorted(a) == sorted(b) == ["offsets", "points", "t_beg",
                                          "t_end"]
        for k in a:
            assert np.array_equal(a[k], b[k]), k
        ref = tcli._load_scan_file(path, lt, **kw)
        assert np.array_equal(a["points"], ref["points"])
        assert np.array_equal(a["offsets"], ref["offsets"])
        assert (a["t_beg"], a["t_end"]) == (tb, te)
    assert len(got) == len(rows)
    tl.close()
    jl.close()
    with pytest.raises(ValueError, match="no native loader plan"):
        tnative.ScanLoader(full, "velodyne")


@pytest.mark.parametrize("use_native", [True, False])
@pytest.mark.parametrize("kind,lidar_type,notime",
                         [(4, "tartanair", False), (4, "tartanair", True),
                          ("hesai", "hesai", False),
                          ("hesai", "velodyne", False)])
def test_iter_dataset_matches_jax(tmp_path, kind, lidar_type, notime,
                                  use_native):
    """`cli.iter_dataset` yields exactly the JAX package's packets, through
    the native loader (types with a plan) and the inline path (velodyne,
    use_native=False); the two paths agree on points and offsets."""
    d = str(tmp_path / "ds")
    _write_dataset(d, kind, n_scans=4)
    kw = dict(blind=1.0, point_filter_num=1, use_native=use_native,
              point_notime=notime)
    out = list(tcli.iter_dataset(d, lidar_type, **kw))
    _same_packets(out, list(jcli.iter_dataset(d, lidar_type, **kw)))
    assert len(out) == (3 if notime else 4)
    other = list(tcli.iter_dataset(d, lidar_type,
                                   **dict(kw, use_native=not use_native)))
    for a, b in zip(out, other):
        assert np.array_equal(a["scan"]["points"], b["scan"]["points"])
        assert np.array_equal(a["scan"]["offsets"], b["scan"]["offsets"])
