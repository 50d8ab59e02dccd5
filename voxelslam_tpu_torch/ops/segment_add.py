"""Scatter-add in a fixed order: XLA's `buf.at[idx].add(val, mode="drop")`
along dim 0, the port's counterpart of the JAX package's scatter-adds
(whose order on the TPU is fixed; no Pallas kernel).

On a CUDA tensor `segment_add` launches the hand-written kernels in
`csrc/segment_add.cu` (nvcc for sm_90a at first use into
`build/torch_kernels/`, bound with ctypes), which add each row's sources in
ascending source index with no sort: bitwise the CPU's sequential
`index_add_`, run to run, where `index_add_` on the card adds with atomics
in no fixed order. `plan` picks, from the shapes alone, one launch (a block
a tile of rows reads all of idx) or two (a partition by tile, then the
sums); a call reads nothing back to the host and allocates by shape only,
so it captures into a CUDA graph. On a CPU tensor it runs
`segment_add_ref`. A CUDA tensor never falls back to the plain version: a
failed build or launch raises.
"""

from __future__ import annotations

import ctypes
import functools
import math
from pathlib import Path
from typing import NamedTuple

import torch

from .moments import _Counter, nvcc_build

_SRC = Path(__file__).resolve().parent.parent / "csrc" / "segment_add.cu"

# csrc/segment_add.cu's constants
THREADS, WARPS, ITEMS = 256, 8, 16
CHUNK = THREADS * ITEMS      # list entries a block streams per pass
PMAX, BMAX = 256, 4096       # partition chunks, buckets (path 2)
RMAX = 1024                  # tile rows (the batch sort's)
SMEM_MAX = 232448            # shared bytes a block can use (H100)
# the plan's choices
SMS = 132                    # H100 SXM's streaming multiprocessors
TARGET = 32                  # sources a path-1 block aims at
BUCKET_TARGET = 128          # sources a path-2 bucket aims at
PART_SOURCES = 2048          # sources a partition block aims at
TILE_BYTES = 64 << 10        # most bytes of a block's tile
STASH_BYTES = 16 << 10       # bytes of staged val rows a block aims at
ONE_LAUNCH_IDX_BYTES = 16 << 20   # idx bytes all path-1 blocks may read

counter = _Counter("kernel.segment_add")
_lib = None


class Plan(NamedTuple):
    """How `launch` runs one call. path 1: one launch, block b sums rows
    [b R, (b + 1) R) reading all of idx; path 2: a partition into `blocks`
    buckets of Rs rows (P chunks of S sources), then the sums, a bucket a
    block and a tile of R rows at a time."""
    path: int
    R: int
    Rs: int
    blocks: int
    sub: int          # staged list entries a block
    lg: int           # lanes a row group: the power of two >= D, <= 32
    P: int
    S: int
    smem: int         # the sum kernel's shared bytes
    smem_part: int    # the partition kernel's (0 on path 1)

    @property
    def launches(self) -> int:
        return self.path


def _align16(x: int) -> int:
    return (x + 15) // 16 * 16


def _smem_sum(R: int, D: int, esz: int, sub: int) -> int:
    """csrc/segment_add.cu `layout(...).total`."""
    o = _align16(R * D * esz)                 # tile
    o = _align16(o + sub * D * esz)           # stash
    o = _align16(o + CHUNK * 4)               # list sources
    o = _align16(o + CHUNK * 2)               # list rows
    o = _align16(o + (2 * PMAX + 1) * 4)      # chunk starts and offsets
    o = _align16(o + WARPS * 4)               # warp sums
    o = _align16(o + R * 4)                   # a batch's rows: counts,
    o = _align16(o + (R + 1) * 4)             # starts,
    o = _align16(o + WARPS * R)               # per-warp counts,
    return _align16(o + sub * 4)              # sources in row order


def _smem_part(B: int) -> int:
    """csrc/segment_add.cu `part_smem(B)`."""
    return _align16(_align16(B * 4 + WARPS * B) + WARPS * 4)


def _up8(x: int) -> int:
    return -(-x // 8) * 8


@functools.lru_cache(maxsize=256)
def plan(C: int, N: int, D: int, dtype=torch.float32, index_size: int = 8,
         path: int | None = None) -> Plan:
    """The launch plan for buf (C, D), idx (N,) of `index_size` bytes and
    val (N, D) of `dtype`, from the shapes alone. Path 1 (one launch) while
    its blocks together read at most max(ONE_LAUNCH_IDX_BYTES, the call's
    own bytes) of idx; else path 2 (two launches). `path` forces one."""
    esz = torch.empty((), dtype=dtype).element_size()
    if esz not in (4, 8) or index_size not in (4, 8):
        raise TypeError("segment_add takes float32/float64 values and "
                        "int32/int64 indices")
    if not (0 < C < 2 ** 31 and D > 0 and 0 <= N <= 2 ** 31 - 1 - CHUNK):
        raise ValueError(f"unsupported shape C={C}, N={N}, D={D}")
    rmax = min(RMAX, TILE_BYTES // (D * esz) // 8 * 8)
    if rmax < 8:
        raise ValueError(f"rows of {D} x {esz} bytes are too wide for a "
                         f"tile of 8 rows in {TILE_BYTES} bytes")
    sub = min(THREADS, max(32, STASH_BYTES // (D * esz) // 32 * 32))
    lg = 1 << min(5, (D - 1).bit_length())
    # path 1: about TARGET sources a block, at most two blocks an SM
    # where rows allow, so that fewer blocks read idx
    R = min(max(C * TARGET // max(N, 1) // 8 * 8, 8), rmax)
    if -(-C // R) > 2 * SMS:
        R = min(rmax, max(R, _up8(-(-C // (2 * SMS)))))
    blocks = -(-C // R)
    own_bytes = (2 * C * D + N * D) * esz + N * index_size
    one = blocks * N * index_size <= max(ONE_LAUNCH_IDX_BYTES, own_bytes)
    if path == 1 or (path is None and one):
        return Plan(1, R, R, blocks, sub, lg, 0, 0,
                    _smem_sum(R, D, esz, sub), 0)
    if N == 0:
        raise ValueError("path 2 needs sources")
    P = min(max(-(-N // PART_SOURCES), 1), PMAX)
    S = -(-N // P)
    Rs = max(C * BUCKET_TARGET // N // 8 * 8, 8, _up8(-(-C // BMAX)))
    B = -(-C // Rs)
    R = min(Rs, rmax)
    return Plan(2, R, Rs, B, sub, lg, P, S, _smem_sum(R, D, esz, sub),
                _smem_part(B))


def segment_add_ref(buf: torch.Tensor, idx: torch.Tensor,
                    val: torch.Tensor) -> torch.Tensor:
    """Plain version: `buf` plus every row of `val` added at its `idx`
    (one `index_add_` into a copy with a spare row at C, which is sliced
    away)."""
    C = buf.shape[0]
    out = torch.cat([buf, buf.new_zeros((1,) + tuple(buf.shape[1:]))])
    out.index_add_(0, idx, val.to(buf.dtype))
    return out[:C]


def build() -> Path:
    """Compile csrc/segment_add.cu (once per source content); returns the
    library path."""
    return nvcc_build(_SRC, "libvs_segment_add")


def _library():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        fn = lib.vs_segment_add
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_longlong]
                       + [ctypes.c_int] * 14 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def launch(buf2: torch.Tensor, idx: torch.Tensor, val2: torch.Tensor,
           out2: torch.Tensor, zero: bool = False,
           path: int | None = None) -> Plan:
    """Run the kernels: out2 (C, D) = buf2 (C, D) plus the rows of val2
    (N, D) at idx (N,), on the current stream. Every tensor must be a
    contiguous CUDA tensor; buf2, val2 and out2 of one float type, idx
    int32 or int64. With `zero`, buf2 is taken to be all +0.0 and is not
    read. `path` forces a path of `plan`. Returns the plan run."""
    C, D = buf2.shape
    N = idx.shape[0]
    if buf2.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"the kernel takes float32 or float64, got "
                        f"{buf2.dtype}")
    if val2.dtype != buf2.dtype or out2.dtype != buf2.dtype:
        raise TypeError("buf, val and out must share one dtype")
    if idx.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"idx must be int32 or int64, got {idx.dtype}")
    for x in (buf2, idx, val2, out2):
        if x.device != buf2.device or not x.is_contiguous():
            raise ValueError("every operand must be a contiguous tensor on "
                             f"{buf2.device}")
    if buf2.device.type != "cuda":
        raise ValueError(f"the kernel needs CUDA tensors, got {buf2.device}")
    if (idx.dim() != 1 or tuple(val2.shape) != (N, D)
            or tuple(out2.shape) != (C, D)):
        raise ValueError("operand shapes do not match")
    pl = plan(C, N, D, buf2.dtype, idx.element_size(), path)
    part = loff = None
    if pl.path == 2:
        part = torch.empty((N, 2), dtype=torch.int32, device=buf2.device)
        loff = torch.empty((pl.P * (pl.blocks + 1),), dtype=torch.int32,
                           device=buf2.device)
    with torch.cuda.device(buf2.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _library().vs_segment_add(
            buf2.data_ptr(), val2.data_ptr(), idx.data_ptr(),
            None if part is None else part.data_ptr(),
            None if loff is None else loff.data_ptr(), out2.data_ptr(),
            C, D, N, buf2.element_size(), idx.element_size(), pl.R, pl.Rs,
            pl.blocks, pl.sub, pl.lg, pl.P, pl.S, int(zero), pl.smem,
            pl.smem_part, stream)
    if err != 0:
        raise RuntimeError(f"segment_add kernel launch failed: cudaError "
                           f"{err}")
    counter.add(call_bytes(C, N, D, buf2.element_size(), idx.element_size(),
                           zero))
    for _ in range(pl.launches - 1):
        counter.add()
    return pl


def call_bytes(C: int, N: int, D: int, esz: int, isz: int,
               zero: bool = False) -> int:
    """Bytes one call needs at least: val (N, D) and idx (N,) read, buf
    (C, D) read unless `zero`, out (C, D) written, each once."""
    return (N * D + C * D * (1 if zero else 2)) * esz + N * isz


def segment_add(buf: torch.Tensor, idx: torch.Tensor, val: torch.Tensor,
                zero: bool = False) -> torch.Tensor:
    """buf (C, ...) float; idx (N,) integer in [0, C] (index C dropped);
    val (N, ...) with buf's trailing shape. Returns buf with every val row
    added at its idx, each row's sources in ascending source index. With
    `zero`, buf's values count as +0.0 and are not read: buf gives the
    shape, dtype and device, so a caller may pass `new_empty` and skip a
    fill. CUDA: the kernels; CPU: `segment_add_ref`."""
    C = buf.shape[0]
    N = idx.shape[0]
    if idx.dim() != 1 or tuple(val.shape) != (N,) + tuple(buf.shape[1:]):
        raise ValueError(f"need idx (N,) and val (N, *{tuple(buf.shape[1:])}),"
                         f" got {tuple(idx.shape)} and {tuple(val.shape)}")
    if buf.device.type == "cpu":
        return segment_add_ref(torch.zeros_like(buf) if zero else buf, idx,
                               val)
    if buf.device.type != "cuda":
        raise ValueError(f"unsupported device {buf.device}")
    D = math.prod(buf.shape[1:])
    if C == 0 or D == 0:
        return torch.zeros_like(buf) if zero else buf.clone()
    if idx.dtype not in (torch.int32, torch.int64):
        idx = idx.long()
    out = torch.empty((C, D), dtype=buf.dtype, device=buf.device)
    launch(out if zero else buf.reshape(C, D).contiguous(), idx.contiguous(),
           val.to(buf.dtype).reshape(N, D).contiguous(), out, zero=zero)
    return out.reshape(buf.shape)
