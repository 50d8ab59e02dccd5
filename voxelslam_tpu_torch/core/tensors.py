"""Small helpers that stand in for JAX's pytree and broadcasting idioms.

`tmap` is `jax.tree.map` over the port's dataclasses of tensors (and
tuples/lists of them); `mv` is the batched matrix-vector product that
`A @ v` means under `jax.vmap`; `cumsum0` is a float prefix sum that stays
deterministic on the GPU (torch's CUDA float cumsum is not); `per_window`
keeps an op's sums in their unbatched order under `torch.func.vmap`.
"""

from __future__ import annotations

import dataclasses
import math

import torch


def tmap(fn, *objs):
    """Apply `fn` leafwise over matching dataclass / tuple / list trees."""
    o = objs[0]
    if dataclasses.is_dataclass(o) and not isinstance(o, type):
        return type(o)(**{f.name: tmap(fn, *(getattr(x, f.name) for x in objs))
                          for f in dataclasses.fields(o)})
    if isinstance(o, (tuple, list)):
        return type(o)(tmap(fn, *xs) for xs in zip(*objs))
    return fn(*objs)


def stack(trees):
    """Stack a list of equally shaped trees along a new leading axis."""
    return tmap(lambda *xs: torch.stack(xs), *trees)


def mv(A: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Batched matrix-vector product: (..., m, n) x (..., n) -> (..., m)."""
    return (A @ v.unsqueeze(-1)).squeeze(-1)


def cumsum0(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum over dim 0 by log-depth doubling (Hillis-Steele).

    Fixed summation order on every device, so it is bitwise repeatable
    where `torch.cumsum` on CUDA floats is not (and raises under
    `torch.use_deterministic_algorithms(True)`)."""
    n = x.shape[0]
    s = 1
    while s < n:
        x = torch.cat([x[:s], x[s:] + x[:-s]], dim=0)
        s *= 2
    return x


def _interleave(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a0, b0, a1, b1, ... along dim 0 (len(a) == len(b) or len(b) + 1)."""
    nb = b.shape[0]
    ab = torch.stack([a[:nb], b], dim=1).reshape((2 * nb,) + tuple(a.shape[1:]))
    return torch.cat([ab, a[nb:]]) if a.shape[0] > nb else ab


def associative_scan(fn, elems):
    """Inclusive scan of a tuple of tensors along dim 0 with the associative
    `fn(earlier, later)`, by the same odd/even recursion as
    `jax.lax.associative_scan`, so the products are taken in the same
    order (log2(n) levels of batched combines)."""
    n = elems[0].shape[0]
    if n < 2:
        return tuple(elems)
    reduced = fn(tuple(e[0:-1:2] for e in elems), tuple(e[1::2] for e in elems))
    odd = associative_scan(fn, reduced)
    if n % 2 == 0:
        even = fn(tuple(e[:-1] for e in odd), tuple(e[2::2] for e in elems))
    else:
        even = fn(odd, tuple(e[2::2] for e in elems))
    even = tuple(torch.cat([e[:1], r]) for e, r in zip(elems, even))
    return tuple(_interleave(a, b) for a, b in zip(even, odd))


def searchsorted_right(arr: torch.Tensor, query: torch.Tensor) -> torch.Tensor:
    """`jnp.searchsorted(arr, query, side="right")` by the JAX default
    ("scan") binary search, step for step: it gives JAX's answer even
    where `arr` is not sorted (the de-skew pose table puts +inf at
    invalid intervals), where `torch.searchsorted` is undefined."""
    n = arr.shape[0]
    low = torch.zeros(query.shape, dtype=torch.int64, device=query.device)
    high = torch.full(query.shape, n, dtype=torch.int64, device=query.device)
    for _ in range(int(math.ceil(math.log2(n + 1)))):
        mid = (low + high) // 2
        go_left = query < arr[mid]
        low = torch.where(go_left, low, mid)
        high = torch.where(go_left, mid, high)
    return high


def take_row(a: torch.Tensor, i, dim: int = 0) -> torch.Tensor:
    """`a.select(dim, i)` for an int or a 0-dim integer tensor `i`. Python
    indexing with a 0-dim tensor reads it back to the host (`.item()`), a
    sync on the card that a CUDA graph cannot capture; a tensor index here
    stays on the device."""
    if torch.is_tensor(i):
        return a.index_select(dim, i.reshape(1).long()).squeeze(dim)
    return a.select(dim, i)


def put_row(a: torch.Tensor, i, b, dim: int = 0) -> torch.Tensor:
    """A copy of `a` with `a.select(dim, i)` set to `b` (a tensor, broadcast,
    or a Python scalar); `i` an int or a 0-dim integer tensor, which stays
    on the device (see `take_row`)."""
    if not torch.is_tensor(i):
        a = a.clone()
        a[(slice(None),) * dim + (i,)] = b
        return a
    at = i.reshape(1).long()
    if not torch.is_tensor(b):
        return a.index_fill(dim, at, b)
    row = b.to(a.dtype).expand(a.select(dim, 0).shape).unsqueeze(dim)
    return a.index_copy(dim, at, row)


def drop_set(buf: torch.Tensor, idx: torch.Tensor, val: torch.Tensor,
             dim: int = 0) -> torch.Tensor:
    """XLA's `buf.at[idx].set(val, mode="drop")` for indices in [0, C]:
    rows addressed with index C (= buf.shape[dim]) are dropped. Writes go
    to a copy with one spare row at C, which is sliced away."""
    C = buf.shape[dim]
    pad_shape = list(buf.shape)
    pad_shape[dim] = 1
    out = torch.cat([buf, buf.new_zeros(pad_shape)], dim=dim)
    index = [slice(None)] * dim + [idx]
    out[tuple(index)] = val.to(buf.dtype)
    return out.narrow(dim, 0, C)


def drop_add(buf: torch.Tensor, idx: torch.Tensor,
             val: torch.Tensor) -> torch.Tensor:
    """XLA's `buf.at[idx].add(val, mode="drop")` along dim 0 for indices in
    [0, C]; index C is dropped. Each row adds its sources in ascending
    source index on every device (`ops.segment_add`: the kernel on CUDA
    tensors, `index_add_` on CPU ones), so a caller may pack columns that
    share `idx` into one call: they sum independently."""
    from ..ops.segment_add import segment_add
    return segment_add(buf, idx, val.to(buf.dtype))


class _PerWindow(torch.autograd.Function):
    """`fn(*xs)`, which torch.func.vmap runs once per batch entry."""

    @staticmethod
    def forward(fn, *xs):
        return fn(*xs)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def vmap(info, in_dims, fn, *xs):
        rows = [[x] * info.batch_size if d is None else x.unbind(d)
                for x, d in zip(xs, in_dims[1:])]
        return torch.stack([fn(*r) for r in zip(*rows)]), 0


def per_window(fn, *xs):
    """`fn(*xs)` for tensors `xs`; under `torch.func.vmap` fn runs once per
    batch entry, at the unbatched shapes, so each entry's result is
    bitwise the one it gets alone. For the ops whose summation order the
    batch would change: library contractions (einsum, matmul), reductions
    to a few outputs and linear solves, whose CPU and CUDA kernels pick
    their blocking and split from the whole operand's shape. One launch
    per entry: keep it to those ops."""
    return _PerWindow.apply(fn, *xs)


def window_einsum(eq: str, *xs):
    """torch.einsum(eq, *xs) as one `per_window` op."""
    return per_window(lambda *ys: torch.einsum(eq, *ys), *xs)


def window_bmm(a, b):
    """torch.bmm(a, b) as one `per_window` op."""
    return per_window(torch.bmm, a, b)


def window_wsum(x, m):
    """torch.einsum("w...,w->...", x, m), the sum over the leading axis
    weighted by m (W,), as the one bmm the einsum makes of it: one
    `per_window` op."""
    W = x.shape[0]
    return window_bmm(x.reshape(W, -1).T[None], m.reshape(1, W, 1)).reshape(
        x.shape[1:])
