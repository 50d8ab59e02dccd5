"""LiDAR point decoding — per-vendor normalization to a common scan form
(port of `voxelslam_tpu/io/decoders.py`, host numpy, copied).

Capability parity with the reference's `Features::process`
(feature_point.hpp:96-370 in the reference tree): the six supported
sensor families {LIVOX, VELODYNE, OUSTER, HESAI, ROBOSENSE, TARTANAIR}
are normalized to

    points  (N, 3) float32   sensor-frame coordinates (m)
    offsets (N,)  float32    per-point time from scan start (s)
    intensity (N,) float32

with the reference's behaviors: blind-radius filter, 1-in-N decimation
(`point_filter_num`), per-vendor time-unit conversion, the Velodyne
yaw-derived time fallback when per-point stamps are missing (omega =
3610 deg/s, feature_point.hpp:169-254), monotonic time sort, and the
0.11 s max-offset drop (voxelslam.hpp:76-103).

Inputs are numpy structured arrays (as produced by rosbag readers or
PCD/BIN loaders) — this is host-side preprocessing, not device code.

With `use_native=True`, a layout that has a native plan goes through the
C++ decoder (`native.decode_structured`, built with g++ at first use; a
failed build raises); layouts without one (velodyne, float stamps whose
unit is guessed) take the numpy path by choice of layout, as in the JAX
package.
"""

from __future__ import annotations

import numpy as np

LIDAR_TYPES = ("livox", "velodyne", "ouster", "hesai", "robosense", "tartanair")
MAX_OFFSET_S = 0.11          # voxelslam.hpp:96
VELODYNE_OMEGA_DEG_S = 3610.0  # feature_point.hpp:238


def _finalize(xyz, offs, inten, blind, filter_num):
    r2 = (xyz ** 2).sum(-1)
    keep = r2 > blind * blind
    keep &= np.isfinite(xyz).all(-1)
    idx = np.where(keep)[0][::max(1, int(filter_num))]
    xyz, offs, inten = xyz[idx], offs[idx], inten[idx]
    keep2 = offs <= MAX_OFFSET_S
    xyz, offs, inten = xyz[keep2], offs[keep2], inten[keep2]
    order = np.argsort(offs, kind="stable")
    out = dict(points=xyz[order].astype(np.float32),
               offsets=offs[order].astype(np.float32),
               intensity=inten[order].astype(np.float32))
    if len(out["points"]) == 0:
        # reference inserts dummy points for empty scans (voxelslam.hpp:82)
        out = dict(points=np.zeros((2, 3), np.float32),
                   offsets=np.zeros(2, np.float32),
                   intensity=np.zeros(2, np.float32))
    return out


def _get(arr, *names, default=None):
    for n in names:
        if n in (arr.dtype.names or ()):
            return np.asarray(arr[n], np.float64)
    return default


def _native_decode(arr, lt, blind, point_filter_num):
    """Fast path through the C++ ingest library (`native`); returns None
    when the layout needs the numpy path (unit auto-detection, yaw-derived
    times)."""
    from .. import native
    plans = {
        "livox": dict(time_fields=("offset_time",), t_scale=1e-9),
        "ouster": dict(time_fields=("t",), t_scale=1e-9),
        "hesai": dict(time_fields=("timestamp",), t_absolute=True),
        "robosense": dict(time_fields=("timestamp",), t_absolute=True),
        "tartanair": dict(time_fields=()),
    }
    plan = plans.get(lt)
    if plan is None:
        return None
    names = arr.dtype.names or ()
    tf = plan.get("time_fields", ())
    if tf and tf[0] not in names:
        return None
    if tf and tf[0] in names:
        # the u4/u8 ns layouts are safe; float layouts may be in other
        # units that the numpy path auto-detects
        kind = arr.dtype.fields[tf[0]][0].kind
        if plan.get("t_scale", 1.0) != 1.0 and kind not in "iu":
            return None
    out = native.decode_structured(
        arr, time_fields=tf or ("__none__",),
        t_scale=plan.get("t_scale", 1.0),
        t_absolute=plan.get("t_absolute", False),
        blind=blind, point_filter_num=point_filter_num,
        max_offset=MAX_OFFSET_S)
    if out is None:
        return None
    pts, offs, inten = out
    if len(pts) == 0:
        pts = np.zeros((2, 3), np.float32)
        offs = np.zeros(2, np.float32)
        inten = np.zeros(2, np.float32)
    return dict(points=pts, offsets=offs, intensity=inten)


def decode(arr: np.ndarray, lidar_type: str, blind: float = 0.5,
           point_filter_num: int = 1, scan_duration: float = 0.1,
           use_native: bool = True):
    """Decode one scan's structured array to the common form."""
    lt = lidar_type.lower()
    if lt not in LIDAR_TYPES:
        raise ValueError(f"unknown lidar type {lidar_type}")
    if use_native:
        out = _native_decode(arr, lt, blind, point_filter_num)
        if out is not None:
            return out
    xyz = np.stack([np.asarray(arr["x"], np.float64),
                    np.asarray(arr["y"], np.float64),
                    np.asarray(arr["z"], np.float64)], -1)
    inten = _get(arr, "intensity", "reflectivity",
                 default=np.zeros(len(arr)))

    if lt == "livox":
        # offset_time in ns (feature_point.hpp:142-167)
        offs = _get(arr, "offset_time", "time")
        offs = offs * 1e-9 if offs is not None and offs.max() > 1.0 \
            else (offs if offs is not None else np.zeros(len(arr)))
    elif lt == "velodyne":
        offs = _get(arr, "time", "t")
        if offs is None:
            # yaw-derived fallback (feature_point.hpp:219-254)
            yaw = np.degrees(np.arctan2(xyz[:, 1], xyz[:, 0]))
            yaw_first = yaw[0]
            rel = (yaw_first - yaw) % 360.0
            offs = rel / VELODYNE_OMEGA_DEG_S
        elif offs.max() > 1.0:  # us or ns
            offs = offs * (1e-6 if offs.max() < 1e6 else 1e-9)
        if offs.min() < 0:      # end-relative stamps
            offs = offs - offs.min()
    elif lt == "ouster":
        offs = _get(arr, "t", "time")
        offs = (offs * 1e-9) if offs is not None else np.zeros(len(arr))
    elif lt in ("hesai", "robosense"):
        ts = _get(arr, "timestamp", "time")
        if ts is None:
            offs = np.zeros(len(arr))
        else:
            offs = ts - ts.min()  # absolute stamps (s)
    else:  # tartanair: synthetic, no per-point time
        offs = np.zeros(len(arr))

    return _finalize(xyz, np.asarray(offs, np.float64), inten, blind,
                     point_filter_num)


def sync_packages(scan_queue: list, imu_queue: list, point_notime=False,
                  min_imu=5, state: dict | None = None):
    """Pair the oldest scan with all IMU samples up to its end time
    (reference sync_packages, voxelslam.hpp:112-177).

    scan_queue entries: dict with t_beg, t_end + decode() output.
    imu_queue entries: (t, gyr (3,), acc (3,)).
    Pops consumed items; returns None until a complete packet exists.

    point_notime (stamp-less LiDARs): the scan's nominal time becomes
    its END and the PREVIOUS scan's time its BEGIN (the reference
    rewrites pcl_beg/end the same way, voxelslam.hpp:131-140); the very
    first scan only anchors the clock and is consumed without a packet.
    Pass a persistent `state` dict so the anchor survives across calls.
    """
    if not scan_queue or not imu_queue:
        return None
    scan = scan_queue[0]
    if point_notime and not scan.get("_nt_adjusted"):
        if state is None:
            raise ValueError("point_notime requires a persistent `state`"
                             " dict across sync_packages calls")
        if state.get("last_time") is None:
            state["last_time"] = scan["t_beg"]
            scan_queue.pop(0)
            return None
        new_end = scan["t_beg"]
        scan["t_end"] = new_end
        scan["t_beg"] = state["last_time"]
        state["last_time"] = new_end
        scan["_nt_adjusted"] = True
    t_end = scan["t_end"]
    if imu_queue[-1][0] < t_end:
        return None  # IMU not caught up yet
    take = [s for s in imu_queue if s[0] <= t_end]
    if len(take) <= min_imu - 1:
        return None
    scan_queue.pop(0)
    # keep the last consumed sample for continuity of the next interval
    del imu_queue[:len(take) - 1]
    ts = np.array([s[0] for s in take])
    gyr = np.stack([s[1] for s in take])
    acc = np.stack([s[2] for s in take])
    return dict(scan=scan, imu_ts=ts, imu_gyr=gyr, imu_acc=acc)
