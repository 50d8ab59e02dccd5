"""Native host code bound with ctypes (port of
`voxelslam_tpu/native/__init__.py`): the BTC descriptor store
(`csrc/btcdb.cpp`), and the scan ingest (`csrc/ingest.cpp`: structured-field
decode, yaw times, host voxel downsample) with the prefetching dataset loader
(`csrc/loader.cpp`).

Each library is compiled with g++ at first use into `build/torch_kernels/`
(once per source content, like `ops.moments`' kernel). A failed build raises
with the compiler's messages: nothing falls back to a numpy or dict path.
Which sensor layouts have a native decode plan is decided before any build
(`LOADER_PLANS`, `decode_structured`'s field check); the rest go through
`io.decoders`' numpy path by choice of layout.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build" / "torch_kernels"
GXX_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-std=c++17"]
# library name -> its sources in csrc/
SOURCES = {"btcdb": ("btcdb.cpp",), "ingest": ("ingest.cpp", "loader.cpp")}

_p, _i64, _f64, _int = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_double,
                        ctypes.c_int)
# function -> (restype, argtypes), per library
_SIGNATURES = {
    "btcdb": {
        "vs_btcdb_new": (_p, [_f64, _i64]),
        "vs_btcdb_free": (None, [_p]),
        "vs_btcdb_add": (None, [_p, _i64, _i64, _p, _p, _p]),
        "vs_btcdb_search": (_i64, [_p, _i64, _p, _p, _p, _i64, _i64, _f64,
                                   _i64, _i64, _i64, _p, _p, _p, _p]),
    },
    "ingest": {
        "vs_decode": (_i64, [_p, _i64, _i64, _i64, _int, _i64, _int, _i64,
                             _int, _i64, _int, _f64, _int, _i64, _int, _f64,
                             _i64, _f64, _p, _p, _p]),
        "vs_yaw_times": (None, [_p, _i64, _f64, _p]),
        "vs_voxel_downsample": (_i64, [_p, _i64, _f64, _i64, _p]),
        "vs_loader_open": (_p, [ctypes.c_char_p, ctypes.c_char_p, _f64, _int,
                                _f64, _i64, _f64, _i64]),
        "vs_loader_count": (_i64, [_p]),
        "vs_loader_next": (_i64, [_p, _p, _p, _i64, _p, _p]),
        "vs_loader_close": (None, [_p]),
    },
}

_lock = threading.Lock()
_libs: dict = {}


def build(name: str) -> Path:
    """Compile library `name` (see SOURCES) once per source content and
    return its path; raises RuntimeError with g++'s stderr on failure."""
    srcs = [_CSRC / f for f in SOURCES[name]]
    blob = b"".join(p.read_bytes() for p in srcs)
    tag = hashlib.sha1(blob + " ".join(GXX_FLAGS).encode()).hexdigest()[:12]
    lib = BUILD_DIR / f"libvs_{name}_{tag}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *GXX_FLAGS, *map(str, srcs), "-o", str(tmp), "-lpthread"]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except FileNotFoundError as e:
        raise RuntimeError(f"g++ not found: the native {name} library cannot "
                           f"be built ({e})") from e
    if res.returncode != 0:
        raise RuntimeError(f"g++ failed ({res.returncode}):\n{res.stderr}")
    os.replace(tmp, lib)
    return lib


def library(name: str):
    """The loaded library `name`, built on first call."""
    with _lock:
        if name not in _libs:
            lib = ctypes.CDLL(str(build(name)))
            for fn, (res, args) in _SIGNATURES[name].items():
                getattr(lib, fn).restype = res
                getattr(lib, fn).argtypes = args
            _libs[name] = lib
        return _libs[name]


def available() -> bool:
    """True once the ingest library is built and loaded. A failed build
    raises (with g++'s messages) rather than answering False."""
    library("ingest")
    return True


# ---------------------------------------------------------------------------
# ingest
# ---------------------------------------------------------------------------

# field type codes matching ingest.cpp read_field
_TYPE_CODES = {"f4": 0, "f8": 1, "u4": 2, "i4": 3, "u2": 4, "u1": 5,
               "i8": 6, "u8": 7}


def _field_desc(arr: np.ndarray, *names):
    """(byte offset, type code) of the first present field, or (-1, 0)."""
    for n in names:
        if n in (arr.dtype.names or ()):
            off = arr.dtype.fields[n][1]
            code = _TYPE_CODES.get(arr.dtype.fields[n][0].str[1:])
            if code is not None:
                return off, code
    return -1, 0


def decode_structured(arr: np.ndarray, time_fields=("time",),
                      t_scale: float = 1.0, t_absolute: bool = False,
                      blind: float = 0.5, point_filter_num: int = 1,
                      max_offset: float = 0.11):
    """Native decode of one scan's structured record array. Returns
    (points (N,3) f32, offsets (N,) f32, intensity (N,) f32) sorted by
    offset, or None when the layout has no x/y/z fields of a type the
    decoder reads (the caller's numpy path takes those)."""
    if arr.dtype.names is None:
        return None
    ox, tx = _field_desc(arr, "x")
    oy, ty = _field_desc(arr, "y")
    oz, tz = _field_desc(arr, "z")
    if ox < 0 or oy < 0 or oz < 0:
        return None
    ot, tt = _field_desc(arr, *time_fields)
    oi, ti = _field_desc(arr, "intensity", "reflectivity")
    lib = library("ingest")
    raw = np.ascontiguousarray(arr)
    n = len(raw)
    out_xyz = np.empty((n, 3), np.float32)
    out_off = np.empty((n,), np.float32)
    out_int = np.empty((n,), np.float32)
    m = lib.vs_decode(
        raw.ctypes.data, n, raw.dtype.itemsize,
        ox, tx, oy, ty, oz, tz,
        ot, tt, float(t_scale), int(bool(t_absolute)),
        oi, ti,
        float(blind), int(point_filter_num), float(max_offset),
        out_xyz.ctypes.data, out_off.ctypes.data, out_int.ctypes.data)
    return out_xyz[:m].copy(), out_off[:m].copy(), out_int[:m].copy()


def yaw_times(xyz: np.ndarray, omega_deg_s: float = 3610.0):
    """Velodyne yaw-derived time fallback (native)."""
    lib = library("ingest")
    pts = np.ascontiguousarray(xyz, np.float32).reshape(-1, 3)
    out = np.empty((len(pts),), np.float32)
    lib.vs_yaw_times(pts.ctypes.data, len(pts), float(omega_deg_s),
                     out.ctypes.data)
    return out


def voxel_downsample_host(xyz: np.ndarray, voxel: float,
                          cap: int = 1 << 20):
    """Native centroid voxel downsample for host-side merges."""
    lib = library("ingest")
    pts = np.ascontiguousarray(xyz, np.float32).reshape(-1, 3)
    out = np.empty((min(cap, len(pts)), 3), np.float32)
    m = lib.vs_voxel_downsample(pts.ctypes.data, len(pts), float(voxel),
                                min(cap, len(pts)), out.ctypes.data)
    return out[:m].copy()


# per-sensor decode plans for the prefetching loader (same rules as the
# decoders' native path; types needing unit auto-detection or the yaw-time
# fallback use the Python path instead)
LOADER_PLANS = {
    "livox": dict(time_fields="offset_time", t_scale=1e-9, t_absolute=False),
    "ouster": dict(time_fields="t", t_scale=1e-9, t_absolute=False),
    "hesai": dict(time_fields="timestamp", t_scale=1.0, t_absolute=True),
    "robosense": dict(time_fields="timestamp", t_scale=1.0, t_absolute=True),
    "tartanair": dict(time_fields="", t_scale=1.0, t_absolute=False),
}


class ScanLoader:
    """Prefetching dataset scan reader backed by the C++ producer thread
    (loader.cpp): .npy scan files are read, decoded, filtered, and
    time-sorted ahead of consumption, overlapping host IO with device
    compute — the recorded-dataset equivalent of the reference's ROS
    subscriber threads feeding `sync_packages` (voxelslam.hpp:52-177).

    rows: [(t_beg, t_end, abs_path)]; point_cap bounds the copy-out
    buffers. Iterate to get dicts(points, offsets, t_beg, t_end).
    Decode-failed files raise (matching the strict Python path). A lidar
    type without a plan in LOADER_PLANS raises ValueError.
    """

    def __init__(self, rows, lidar_type: str, blind: float = 0.5,
                 point_filter_num: int = 1, max_offset: float = 0.11,
                 prefetch: int = 4, point_cap: int = 1 << 20):
        plan = LOADER_PLANS.get(lidar_type.lower())
        if plan is None:
            raise ValueError(f"no native loader plan for {lidar_type}")
        self._lib = library("ingest")
        index = "\n".join(f"{tb:.17g} {te:.17g} {path}"
                          for tb, te, path in rows)
        self._h = self._lib.vs_loader_open(
            index.encode(), plan["time_fields"].encode(),
            float(plan["t_scale"]), int(plan["t_absolute"]), float(blind),
            int(point_filter_num), float(max_offset), int(prefetch))
        if not self._h:
            raise RuntimeError("vs_loader_open failed")
        self._cap = point_cap
        self._xyz = np.empty((point_cap, 3), np.float32)
        self._off = np.empty((point_cap,), np.float32)

    def __len__(self):
        return int(self._lib.vs_loader_count(self._h))

    def __iter__(self):
        return self

    def __next__(self):
        tb = ctypes.c_double()
        te = ctypes.c_double()
        m = self._lib.vs_loader_next(
            self._h, self._xyz.ctypes.data, self._off.ctypes.data,
            self._cap, ctypes.byref(tb), ctypes.byref(te))
        if m == -1:
            raise StopIteration
        if m == -2:
            raise IOError(f"native loader: decode failed for scan at "
                          f"t=[{tb.value}, {te.value}]")
        pts = self._xyz[:m].copy()
        offs = self._off[:m].copy()
        if m == 0:
            # reference inserts dummy points for empty scans
            # (voxelslam.hpp:82)
            pts = np.zeros((2, 3), np.float32)
            offs = np.zeros(2, np.float32)
        return dict(points=pts, offsets=offs,
                    t_beg=tb.value, t_end=te.value)

    def close(self):
        """Stop and join the producer thread."""
        if getattr(self, "_h", None):
            self._lib.vs_loader_close(self._h)
            self._h = None

    def __del__(self):
        self.close()


# ---------------------------------------------------------------------------
# descriptor store
# ---------------------------------------------------------------------------

class BtcDb:
    """Native triangle-descriptor hash: the host half of the reference's
    STDescManager DB, with the dict path's semantics."""

    def __init__(self, side_quant: float, code_len: int):
        self._lib = library("btcdb")
        self._code_len = int(code_len)
        self._h = self._lib.vs_btcdb_new(float(side_quant), self._code_len)
        if not self._h:
            raise RuntimeError("vs_btcdb_new failed")

    def _arrays(self, sides, codes, valid):
        n = len(sides)
        s = np.ascontiguousarray(sides, np.float32)
        c = np.ascontiguousarray(np.reshape(codes, (n, -1)), np.float32)
        v = np.ascontiguousarray(valid, np.uint8)
        if s.shape != (n, 3) or c.shape[1] != self._code_len or v.shape != (n,):
            raise ValueError(f"need sides (n, 3), codes (n, {self._code_len})"
                             f" and valid (n,); got {s.shape}, {c.shape}, "
                             f"{v.shape}")
        return n, s, c, v

    def add(self, frame_id: int, sides: np.ndarray, codes: np.ndarray,
            valid: np.ndarray) -> None:
        n, s, c, v = self._arrays(sides, codes, valid)
        self._lib.vs_btcdb_add(self._h, int(frame_id), n, s.ctypes.data,
                               c.ctypes.data, v.ctypes.data)

    def search(self, sides: np.ndarray, codes: np.ndarray, valid: np.ndarray,
               skip_near: int, current_frame: int, binary_thr: float,
               min_votes: int, max_matches: int, max_out: int = 64):
        """[(frame, votes, [(q_tri, t_tri), ...])] sorted by votes."""
        n, s, c, v = self._arrays(sides, codes, valid)
        out_f = np.empty(max_out, np.int64)
        out_v = np.empty(max_out, np.int64)
        out_k = np.empty(max_out, np.int64)
        out_p = np.empty((max_out, max_matches, 2), np.int32)
        m = self._lib.vs_btcdb_search(
            self._h, n, s.ctypes.data, c.ctypes.data, v.ctypes.data,
            int(skip_near), int(current_frame), float(binary_thr),
            int(min_votes), int(max_matches), int(max_out),
            out_f.ctypes.data, out_v.ctypes.data, out_k.ctypes.data,
            out_p.ctypes.data)
        return [(int(out_f[i]), int(out_v[i]),
                 [tuple(map(int, p)) for p in out_p[i, :out_k[i]]])
                for i in range(m)]

    def close(self):
        if getattr(self, "_h", None):
            self._lib.vs_btcdb_free(self._h)
            self._h = None

    def __del__(self):
        self.close()
