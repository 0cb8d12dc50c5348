"""Ordered segment sums: CUDA kernels and plain versions.

The JAX package sums the COO residual with ``jax.ops.segment_sum`` over
sorted ids (``parallel_gcn_tpu/ops/graphsum.py:45-66``), which XLA runs
deterministically on the TPU. PyTorch's ``index_add_`` on the card adds in
the order its atomics land, so two card runs of one training differed in
the last bits. The kernels of ``csrc/segment_sum.cu`` add every segment's
items in item order, with no atomics:

- ``gather_sum`` (a): ``out[i] = Σ_{e: index[e] = i} val[e]·x[src[e]]``, the
  GCN's residual aggregation, without the [E, F] product the plain version
  builds;
- ``segment_sum_`` (b): ``out[i] += Σ_{e: index[e] = i} values[e]``, in
  place, for per-edge terms (the GAT residual's) and the halo's cotangent.

Both run over ``Segments``: the CSR of an index vector, built once with the
graph on its device (a host sync, never inside a captured epoch). Items
whose index is not sorted are walked through a stable permutation, so each
segment's items are added in item order. Both accumulate in float32 and
store once in the output's type. The plain versions compute the same
function: the terms in float32 (for bf16, (a)'s products of bf16 operands
are exact in f32), ``index_add_`` into a float32 accumulator on the CPU
(which adds in item order), one rounding to the output's type. So kernel
and plain version are one function bit for bit, in float32 and in bf16.
The JAX package rounds every bf16 product and partial sum instead
(``ops.graphsum`` states the distance). ``gather`` and ``segment_sum`` are
the two differentiable adjoints: each one's backward is the other.

Each wrapper launches its kernel for CUDA tensors and runs the plain
version for CPU tensors. ``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from parallel_gcn_tpu_torch.ops import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# kernel launches by wrapper: "gather_sum" (a) and "segment_sum" (b)
launches = {"gather_sum": 0, "segment_sum": 0}


@dataclass(frozen=True)
class Segments:
    """An index vector as CSR. ``index`` [E] int64 holds each item's
    segment in item order; the items of segment i are those at positions
    ``ptr[i]..ptr[i+1]`` of the stable sorted order, which is ``perm`` (int32)
    or, for a sorted index, the items themselves (``perm`` None). ``live``
    (int32) lists the segments that have items, in order: the kernels walk
    only those."""

    index: torch.Tensor
    ptr: torch.Tensor
    perm: torch.Tensor | None
    live: torch.Tensor
    n: int


def segments(index: torch.Tensor, n: int) -> Segments:
    """The ``Segments`` of ``index`` (values in [0, n)) on its device. Reads
    the index on the host once: build it with the graph, not in an epoch."""
    index = index.long().contiguous()
    if index.dim() != 1 or index.numel() >= 2**31 or n >= 2**31:
        raise ValueError(f"segments take a 1-d index of < 2^31 items into < 2^31 "
                         f"segments, got {tuple(index.shape)} into {n}")
    if index.numel() and not (0 <= int(index.min()) and int(index.max()) < n):
        raise ValueError(f"index values outside [0, {n})")
    if index.numel() < 2 or bool((index[1:] >= index[:-1]).all()):
        ordered, perm = index, None
    else:
        ordered, order = torch.sort(index, stable=True)
        perm = order.int()
    ptr = torch.searchsorted(ordered, torch.arange(n + 1, device=index.device)).int()
    live = torch.nonzero(ptr[1:] > ptr[:-1]).flatten().int()
    return Segments(index=index, ptr=ptr, perm=perm, live=live, n=n)


def group_layout(width: int) -> tuple[int, int]:
    """(G, chunks) of the kernels for rows of ``width`` columns: a group of G
    threads sums one (live segment, 2G-column chunk), each thread columns
    ``chunk·2G + lane`` and ``+ G``; G the smallest power of two that covers
    half the row, at most 32."""
    g = 1
    while g < 32 and 2 * g < width:
        g *= 2
    return g, -(-width // (2 * g))


def _launch_args(seg: Segments, device) -> list:
    if seg.ptr.device != device:
        raise ValueError(f"segments on {seg.ptr.device}, tensors on {device}")
    return [seg.ptr.data_ptr(), None if seg.perm is None else seg.perm.data_ptr(),
            seg.live.data_ptr(), seg.live.numel()]


def _check_dtype(t: torch.Tensor, what: str) -> None:
    if t.dtype not in _DTYPE_CODE:
        raise TypeError(f"{what} takes f32 or bf16, got {t.dtype}")


def gather_sum_plain(x: torch.Tensor, index: torch.Tensor, src: torch.Tensor,
                     val: torch.Tensor, n: int, n_chunks: int = 1) -> torch.Tensor:
    """Plain PyTorch version of ``gather_sum``: the products of ``val[e]``
    (rounded to x's dtype, as the JAX package casts it) and ``x[src[e]]`` in
    float32, ``index_add_`` by ``index`` into a float32 accumulator,
    ``n_chunks`` item chunks at a time (the last takes the remainder), then
    one rounding to x's dtype: kernel (a)'s numeric."""
    acc = torch.zeros((n, x.shape[1]), dtype=torch.float32, device=x.device)
    e_pad = index.shape[0]
    chunk = e_pad // n_chunks
    for c in range(n_chunks):
        lo = c * chunk
        hi = e_pad if c == n_chunks - 1 else lo + chunk
        gathered = val[lo:hi, None].to(x.dtype).float() * x[src[lo:hi]].float()
        # the CPU adds in item order; on the card this plain version runs only
        # beside the kernel, as its yardstick
        acc.index_add_(0, index[lo:hi], gathered)
    return acc.to(x.dtype)


def gather_sum(x: torch.Tensor, seg: Segments, src: torch.Tensor, val: torch.Tensor,
               n_chunks: int = 1) -> torch.Tensor:
    """``out[i] = Σ_{e: seg.index[e] = i} val[e]·x[src[e]]`` in item order,
    [seg.n, F] in x's dtype (f32 or bf16). Kernel (a) for CUDA tensors
    (float32 sums, ``n_chunks`` unused: it builds no [E, F] product), the
    plain version for CPU ones."""
    if x.device.type == "cpu":
        return gather_sum_plain(x, seg.index, src, val, seg.n, n_chunks)
    if x.device.type != "cuda":
        raise ValueError(f"gather_sum: unsupported device {x.device}")
    _check_dtype(x, "gather_sum")
    x = x.contiguous()
    src, val = src.long().contiguous(), val.float().contiguous()
    if src.shape != seg.index.shape or val.shape != seg.index.shape:
        raise ValueError(f"src {tuple(src.shape)} and val {tuple(val.shape)} must match the "
                         f"index {tuple(seg.index.shape)}")
    F = x.shape[1]
    out = torch.zeros((seg.n, F), dtype=x.dtype, device=x.device)  # rows without items
    if seg.live.numel() == 0 or F == 0:
        return out
    lib = _build.load_library()
    with torch.cuda.device(x.device):
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        rc = lib.pgcn_gather_sum(*_launch_args(seg, x.device), src.data_ptr(),
                                 val.data_ptr(), x.data_ptr(), _DTYPE_CODE[x.dtype],
                                 out.data_ptr(), F, stream)
    _build.check(rc, "ordered gather-sum kernel")
    launches["gather_sum"] += 1
    return out


def segment_sum_(out: torch.Tensor, index: Segments | torch.Tensor,
                 values: torch.Tensor) -> torch.Tensor:
    """``out[i] += Σ_{e: index[e] = i} values[e]`` in item order, in place;
    returns ``out``. ``values`` [E, ...] and ``out`` [n, ...] of one dtype
    (f32 or bf16); out's rows may lie apart (a column slice), each row
    contiguous. Kernel (b) for CUDA tensors (float32 sums from out's
    value, one store), ``index_add_`` for CPU ones (the CPU adds in item
    order; bf16 sums in a float32 copy of out, stored once, as the kernel
    does). ``index`` is ``Segments``; on the CPU a raw index does too."""
    if out.device.type == "cpu":
        index = index.index if isinstance(index, Segments) else index
        if out.dtype == torch.float32:
            return out.index_add_(0, index, values)
        return out.copy_(out.float().index_add_(0, index, values.float()))
    if out.device.type != "cuda":
        raise ValueError(f"segment_sum_: unsupported device {out.device}")
    if not isinstance(index, Segments):
        raise TypeError("segment_sum_ on the card takes Segments (ops.cuda_segment.segments)")
    seg = index
    _check_dtype(out, "segment_sum_")
    if values.dtype != out.dtype or values.shape[1:] != out.shape[1:]:
        raise ValueError(f"values {values.dtype} {tuple(values.shape)} do not fit out "
                         f"{out.dtype} {tuple(out.shape)}")
    if out.dim() < 2 or not out[0].is_contiguous():
        raise ValueError("segment_sum_ writes rows [n, ...] each contiguous (strided rows "
                         "are fine)")
    if seg.n != out.shape[0] or values.shape[0] != seg.index.shape[0]:
        raise ValueError(f"{seg.index.shape[0]} items into {seg.n} segments do not fit "
                         f"values {tuple(values.shape)} and out {tuple(out.shape)}")
    W = out[0].numel() if out.shape[0] else 0
    if seg.live.numel() == 0 or W == 0:
        return out
    values = values.contiguous()
    lib = _build.load_library()
    with torch.cuda.device(out.device):
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        rc = lib.pgcn_segment_sum(*_launch_args(seg, out.device), values.data_ptr(),
                                  _DTYPE_CODE[out.dtype], out.data_ptr(), out.stride(0), W,
                                  stream)
    _build.check(rc, "ordered segment-sum kernel")
    launches["segment_sum"] += 1
    return out


class _SegmentSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, values, seg):
        ctx.seg = seg
        out = values.new_zeros((seg.n, *values.shape[1:]))
        return segment_sum_(out, seg, values)

    @staticmethod
    def backward(ctx, g):
        return g.index_select(0, ctx.seg.index), None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, seg):
        ctx.seg = seg
        return x.index_select(0, seg.index)

    @staticmethod
    def backward(ctx, g):
        seg = ctx.seg
        return segment_sum_(g.new_zeros((seg.n, *g.shape[1:])), seg, g.contiguous()), None


def segment_sum(values: torch.Tensor, seg: Segments) -> torch.Tensor:
    """Differentiable ``Σ_{e: index[e] = i} values[e]`` [seg.n, ...] (kernel
    (b) on the card); the backward gathers the cotangent's rows."""
    return _SegmentSum.apply(values, seg)


def gather(x: torch.Tensor, seg: Segments) -> torch.Tensor:
    """Differentiable ``x[seg.index]``; the backward sums the cotangent's
    items into their rows with kernel (b) on the card, not with atomics."""
    if x.shape[0] != seg.n:
        raise ValueError(f"gather of {x.shape[0]} rows by segments over {seg.n}")
    return _Gather.apply(x, seg)


class _GatherSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, seg, src, val, seg_t):
        ctx.seg, ctx.val, ctx.seg_t = seg, val, seg_t
        return gather_sum(x, seg, src, val)

    @staticmethod
    def backward(ctx, g):
        # the transpose: Σ over the items with src = j of val·g[index]
        dx = gather_sum(g.contiguous(), ctx.seg_t, ctx.seg.index, ctx.val)
        return dx, None, None, None, None


def gather_sum_t(x: torch.Tensor, seg: Segments, src: torch.Tensor, val: torch.Tensor,
                 seg_t: Segments) -> torch.Tensor:
    """Differentiable ``gather_sum(x, seg, src, val)``: the backward is the
    transposed sum over ``seg_t``, the ``Segments`` of ``src`` over x's
    rows."""
    if seg_t.n != x.shape[0]:
        raise ValueError(f"transposed segments over {seg_t.n} rows for x of {x.shape[0]}")
    return _GatherSum.apply(x, seg, src, val, seg_t)
