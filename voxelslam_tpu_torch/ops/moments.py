"""Per-point voxel moment accumulation, the insert hot kernel (port of
`voxelslam_tpu/ops/moments.py`).

Each (point, level) contributes one packed 16-channel row

    upd16 = w * [1, q (3), q q^T packed (6), nv (5), pad]

with q the point relative to its voxel centre, summed into a (C_l, 16)
table per level. On a CUDA tensor `accumulate` launches the hand-written
kernel in `csrc/moments.cu` (built with nvcc for sm_90a at first use into
`build/torch_kernels/`, bound with ctypes); on a CPU tensor it runs
`accumulate_ref`, one drop-mode `index_add_` per level — the same sums,
which the tests hold against the JAX package. A CUDA tensor never falls
back to the plain version: a failed build or launch raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from ..utils import telemetry

CH = 16              # channels per slot (1 + 3 + 6 + 5 + 1 pad)
SLOTS_PER_ROW = 8    # table capacities must be multiples of this
MAX_LEVELS = 8       # levels one launch can take (csrc MAX_LEVELS)

_SRC = Path(__file__).resolve().parent.parent / "csrc" / "moments.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ["-gencode=arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC"]


class _Counter:
    """Kernel executions of one wrapper's kernels. A launch made while the
    current stream is being captured into a CUDA graph counts in
    `captured` (its bytes in `captured_bytes`), not in `launches`:
    `pipeline.graphs.StepGraph` adds what its capture recorded at every
    replay (`replayed`), so `launches` counts the kernels' runs on the
    card. Each run also counts in the telemetry counters
    `<name>.launches` and `<name>.bytes` (`utils.telemetry`)."""

    def __init__(self, name: str):
        self.name = name
        self.launches = 0
        self.captured = 0
        self.captured_bytes = 0

    def reset(self):
        self.launches = 0

    def add(self, nbytes: int = 0):
        if torch.cuda.is_current_stream_capturing():
            self.captured += 1
            self.captured_bytes += nbytes
        else:
            self.replayed(1, nbytes)

    def replayed(self, launches: int, nbytes: int = 0):
        self.launches += launches
        telemetry.count(self.name + ".launches", launches)
        if nbytes:
            telemetry.count(self.name + ".bytes", nbytes)


counter = _Counter("kernel.moments")
_lib = None


def pack_updates(q: torch.Tensor, nv: torch.Tensor,
                 w: torch.Tensor) -> torch.Tensor:
    """(P,3) voxel-relative coords, (P,5) noise records, (P,) weights ->
    (P, CH) rows; the second moment packed (xx, yy, zz, xy, xz, yz)."""
    qq = torch.stack([q[:, 0] * q[:, 0], q[:, 1] * q[:, 1],
                      q[:, 2] * q[:, 2], q[:, 0] * q[:, 1],
                      q[:, 0] * q[:, 2], q[:, 1] * q[:, 2]], dim=1)
    pad = q.new_zeros((q.shape[0], 1))
    return torch.cat([torch.ones_like(w)[:, None], q, qq, nv, pad],
                     dim=1) * w[:, None]


def unpack_sym6(m6: torch.Tensor) -> torch.Tensor:
    """(..., 6) packed symmetric -> (..., 3, 3)."""
    xx, yy, zz, xy, xz, yz = [m6[..., i] for i in range(6)]
    return torch.stack([torch.stack([xx, xy, xz], dim=-1),
                        torch.stack([xy, yy, yz], dim=-1),
                        torch.stack([xz, yz, zz], dim=-1)], dim=-2)


def _check(slots: torch.Tensor, upds: torch.Tensor, caps) -> None:
    if slots.dim() != 2:
        raise ValueError(f"slots must be (L, P), got {tuple(slots.shape)}")
    L, P = slots.shape
    if tuple(upds.shape) != (L, P, CH):
        raise ValueError(f"upds must be {(L, P, CH)}, got {tuple(upds.shape)}")
    if slots.dtype != torch.int32 or upds.dtype != torch.float32:
        raise TypeError(f"need int32 slots and float32 upds, got "
                        f"{slots.dtype} and {upds.dtype}")
    if slots.device != upds.device:
        raise ValueError("slots and upds lie on different devices")
    if not (slots.is_contiguous() and upds.is_contiguous()):
        raise ValueError("slots and upds must be contiguous")
    if len(caps) != L or not 1 <= L <= MAX_LEVELS or P < 1:
        raise ValueError(f"need 1 <= L = len(caps) <= {MAX_LEVELS} and P >= 1")
    for c in caps:
        if c <= 0 or c % SLOTS_PER_ROW:
            raise ValueError(f"capacity {c} is not a positive multiple "
                             f"of {SLOTS_PER_ROW}")


def accumulate_ref(slots: torch.Tensor, upds: torch.Tensor, caps):
    """Plain version: per level a zero (C_l, CH) table plus every row added
    at its slot (one `index_add_`; out-of-range slots dropped, as XLA's
    mode="drop" does)."""
    outs = []
    for l, c in enumerate(caps):
        s = slots[l].to(torch.int64)
        s = torch.where((s >= 0) & (s < c), s, c)
        t = upds.new_zeros((c + 1, CH))
        t.index_add_(0, s, upds[l])
        outs.append(t[:c])
    return outs


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def build() -> Path:
    """Compile csrc/moments.cu into build/torch_kernels (once per source
    content) and return the library path."""
    return nvcc_build(_SRC, "libvs_moments")


def nvcc_build(source: Path, stem: str) -> Path:
    """Compile one CUDA source into build/torch_kernels/{stem}_{tag}.so
    (tag: a hash of the source and flags) unless it is there; returns the
    library path."""
    src = source.read_bytes()
    tag = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    lib = BUILD_DIR / f"{stem}_{tag}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    os.replace(tmp, lib)
    return lib


def _library():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        fn = lib.vs_accumulate
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int,
                       ctypes.POINTER(ctypes.c_int), ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def launch(slots: torch.Tensor, upds: torch.Tensor, caps,
           out: torch.Tensor) -> None:
    """Run the CUDA kernel into `out` (sum(caps), CH) on the current
    stream. Inputs must already pass `_check`."""
    L, P = slots.shape
    if (out.device != slots.device or out.dtype != torch.float32
            or tuple(out.shape) != (sum(caps), CH) or not out.is_contiguous()):
        raise ValueError("out must be a contiguous float32 "
                         f"({sum(caps)}, {CH}) tensor on {slots.device}")
    if (upds.data_ptr() | out.data_ptr()) % 16:
        raise ValueError("upds and out must be 16-byte aligned (float4 rows)")
    if slots.device.type != "cuda":
        raise ValueError(f"the kernel needs CUDA tensors, got {slots.device}")
    caps_arr = (ctypes.c_int * L)(*caps)
    with torch.cuda.device(slots.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _library().vs_accumulate(
            slots.data_ptr(), upds.data_ptr(), out.data_ptr(), P, L,
            caps_arr, stream)
    if err != 0:
        raise RuntimeError(f"moments kernel launch failed: cudaError {err}")
    counter.add()


def accumulate(slots: torch.Tensor, upds: torch.Tensor, caps):
    """slots (L, P) int32 in [0, C_l) (invalid points: any in-range slot
    with an all-zero row); upds (L, P, CH) f32. Returns a list of L
    (C_l, CH) f32 tables. CUDA: the kernel; CPU: `accumulate_ref`."""
    caps = tuple(int(c) for c in caps)
    _check(slots, upds, caps)
    if slots.device.type == "cpu":
        return accumulate_ref(slots, upds, caps)
    if slots.device.type != "cuda":
        raise ValueError(f"unsupported device {slots.device}")
    out = torch.empty((sum(caps), CH), dtype=torch.float32,
                      device=slots.device)
    launch(slots, upds, caps, out)
    offs = [0]
    for c in caps:
        offs.append(offs[-1] + c)
    return [out[offs[l]:offs[l + 1]] for l in range(len(caps))]
