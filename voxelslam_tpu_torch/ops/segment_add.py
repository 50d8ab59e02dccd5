"""Scatter-add in a fixed order: XLA's `buf.at[idx].add(val, mode="drop")`
along dim 0, the port's counterpart of the JAX package's scatter-adds
(whose order on the TPU is fixed; no Pallas kernel).

On a CUDA tensor `segment_add` sorts `idx` stably, finds each row's
segment with `torch.searchsorted`, and launches the hand-written kernel in
`csrc/segment_add.cu` (nvcc for sm_90a at first use into
`build/torch_kernels/`, bound with ctypes), which adds each row's sources
in ascending source index: bitwise the CPU's sequential `index_add_`, run
to run, where `index_add_` on the card adds with atomics in no fixed
order. Sort, search and kernel capture into a CUDA graph (no host read).
On a CPU tensor it runs `segment_add_ref`. A CUDA tensor never falls back
to the plain version: a failed build or launch raises.
"""

from __future__ import annotations

import ctypes
import math
from pathlib import Path

import torch

from .moments import _Counter, nvcc_build

_SRC = Path(__file__).resolve().parent.parent / "csrc" / "segment_add.cu"

counter = _Counter()
_lib = None


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
        for name in ("vs_segment_add_f32", "vs_segment_add_f64"):
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int64,
                                                   ctypes.c_int,
                                                   ctypes.c_void_p]
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def segments(idx: torch.Tensor, C: int):
    """(perm (N,) int64, starts (C + 1,) int64): row r's sources are
    perm[starts[r]:starts[r + 1]], in ascending source index."""
    if idx.dtype not in (torch.int32, torch.int64):
        idx = idx.long()
    keys, perm = torch.sort(idx, stable=True)
    rows = torch.arange(C + 1, dtype=keys.dtype, device=keys.device)
    return perm, torch.searchsorted(keys, rows)


def launch(buf2, val2, perm, starts, out2) -> None:
    """Run the CUDA kernel: out2 (C, D) = buf2 (C, D) plus the rows of
    val2 (N, D) by segment, on the current stream. Every tensor must be a
    contiguous CUDA tensor; perm and starts int64, as `segments` gives."""
    C, D = buf2.shape
    fn = {torch.float32: "vs_segment_add_f32",
          torch.float64: "vs_segment_add_f64"}.get(buf2.dtype)
    if fn is None:
        raise TypeError(f"the kernel takes float32 or float64, got "
                        f"{buf2.dtype}")
    for t in (val2, out2):
        if t.dtype != buf2.dtype:
            raise TypeError("buf, val and out must share one dtype")
    for t in (buf2, val2, perm, starts, out2):
        if t.device != buf2.device or not t.is_contiguous():
            raise ValueError("every operand must be a contiguous tensor on "
                             f"{buf2.device}")
    if buf2.device.type != "cuda":
        raise ValueError(f"the kernel needs CUDA tensors, got {buf2.device}")
    if (val2.shape[1] != D or tuple(out2.shape) != (C, D)
            or perm.shape[0] != val2.shape[0] or starts.shape[0] != C + 1
            or perm.dtype != torch.int64 or starts.dtype != torch.int64):
        raise ValueError("operand shapes or index dtypes do not match")
    with torch.cuda.device(buf2.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(_library(), fn)(
            buf2.data_ptr(), val2.data_ptr(), perm.data_ptr(),
            starts.data_ptr(), out2.data_ptr(), C, D, stream)
    if err != 0:
        raise RuntimeError(f"segment_add kernel launch failed: cudaError "
                           f"{err}")
    counter.add()


def segment_add(buf: torch.Tensor, idx: torch.Tensor,
                val: torch.Tensor) -> torch.Tensor:
    """buf (C, ...) float; idx (N,) integer in [0, C] (index C dropped);
    val (N, ...) with buf's trailing shape. Returns buf with every val row
    added at its idx, each row's sources in ascending source index. CUDA:
    the kernel; CPU: `segment_add_ref`."""
    C = buf.shape[0]
    N = idx.shape[0]
    if idx.dim() != 1 or tuple(val.shape) != (N,) + tuple(buf.shape[1:]):
        raise ValueError(f"need idx (N,) and val (N, *{tuple(buf.shape[1:])}),"
                         f" got {tuple(idx.shape)} and {tuple(val.shape)}")
    if buf.device.type == "cpu":
        return segment_add_ref(buf, idx, val)
    if buf.device.type != "cuda":
        raise ValueError(f"unsupported device {buf.device}")
    D = math.prod(buf.shape[1:])
    if C == 0 or D == 0:
        return buf.clone()
    perm, starts = segments(idx, C)
    buf2 = buf.reshape(C, D).contiguous()
    out = torch.empty_like(buf2)
    launch(buf2, val.to(buf.dtype).reshape(N, D).contiguous(), perm, starts,
           out)
    return out.reshape(buf.shape)
