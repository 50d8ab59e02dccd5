"""The native BTC descriptor store (`csrc/btcdb.cpp`) bound with ctypes
(port of the `BtcDb` binding of `voxelslam_tpu/native/__init__.py`).

The library is compiled with g++ at first use into `build/torch_kernels/`
(once per source content, like `ops.moments`' kernel). A failed build
raises with the compiler's messages: the loop pipeline does not fall back
to the dict implementation.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent / "csrc" / "btcdb.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build" / "torch_kernels"
GXX_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-std=c++17"]

_lock = threading.Lock()
_lib = None


def build() -> Path:
    """Compile csrc/btcdb.cpp (once per source content) and return the
    library path; raises RuntimeError with g++'s stderr on failure."""
    src = _SRC.read_bytes()
    tag = hashlib.sha1(src + " ".join(GXX_FLAGS).encode()).hexdigest()[:12]
    lib = BUILD_DIR / f"libvs_btcdb_{tag}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *GXX_FLAGS, str(_SRC), "-o", str(tmp)]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except FileNotFoundError as e:
        raise RuntimeError(f"g++ not found: the descriptor store cannot be "
                           f"built ({e})") from e
    if res.returncode != 0:
        raise RuntimeError(f"g++ failed ({res.returncode}):\n{res.stderr}")
    os.replace(tmp, lib)
    return lib


def library():
    """The loaded store library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            p, i64, f64 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_double
            lib.vs_btcdb_new.restype = p
            lib.vs_btcdb_new.argtypes = [f64, i64]
            lib.vs_btcdb_free.restype = None
            lib.vs_btcdb_free.argtypes = [p]
            lib.vs_btcdb_add.restype = None
            lib.vs_btcdb_add.argtypes = [p, i64, i64, p, p, p]
            lib.vs_btcdb_search.restype = i64
            lib.vs_btcdb_search.argtypes = [p, i64, p, p, p, i64, i64, f64,
                                            i64, i64, i64, p, p, p, p]
            _lib = lib
        return _lib


class BtcDb:
    """Native triangle-descriptor hash: the host half of the reference's
    STDescManager DB, with the dict path's semantics."""

    def __init__(self, side_quant: float, code_len: int):
        self._lib = library()
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
