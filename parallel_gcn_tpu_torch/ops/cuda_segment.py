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
graph on its device (a host sync, never inside a captured epoch), with the
kernels' work list and, for (a), the items' ``src`` and ``val`` packed in
segment order: the ``Segments`` own the gather's operands. Items whose index is not
sorted are walked through a stable permutation, so each segment's items
are added in item order. Both accumulate in float32 and store once in the
output's type. The plain versions compute the same function: the terms in
float32 (for bf16, (a)'s products of bf16 operands are exact in f32),
``index_add_`` into a float32 accumulator on the CPU (which adds in item
order), one rounding to the output's type. So kernel and plain version are
one function bit for bit, in float32 and in bf16. The JAX package rounds
every bf16 product and partial sum instead (``ops.graphsum`` states the
distance). ``gather`` and ``segment_sum`` are the two differentiable
adjoints: each one's backward is the other.

Each wrapper launches its kernels for CUDA tensors and runs the plain
version for CPU tensors. ``launches`` counts kernel launches: a call's walk
kernel under the wrapper's name, its hub kernel (where the call has hubs)
under the name with ``_hub``. ``layout`` is the kernels' division of the
work, which ``tests/test_torch_segment.py`` models in numpy.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from dataclasses import dataclass

import torch

from parallel_gcn_tpu_torch.ops import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# kernel launches by wrapper: "gather_sum" (a) and "segment_sum" (b) their
# walk kernels, "..._hub" their hub kernels
launches = {"gather_sum": 0, "segment_sum": 0, "gather_sum_hub": 0, "segment_sum_hub": 0}

# The kernels' layout knobs (settled on the card by ``kernel_variants.py
# segment``): the widest vector a lane loads, in bytes; the items from which
# a segment is a hub (read when ``Segments`` are built: the hubs lead the
# work list and go to the hub kernel, a team of warps one vector a lane,
# with a deeper ring).
MAX_VEC_BYTES = 16
HUB_ITEMS = 512
# the widest vector of a hub lane: a hub takes the narrowest vectors whose
# team fits in 8 warps (narrower vectors spread a hub over more lanes, each
# with a ring as deep); rows of at most HALF_WARP_VECS vectors go to half
# warps
HUB_VEC_BYTES = 16
HALF_WARP_VECS = 16
WARP_ROW_BYTES = 512  # rows of at most this many bytes go to one warp (up to 4 passes)
# rows of at most ITEM_WIDTH elements are summed by the item walker (lanes
# take items, not columns); the widest row a launch takes, in vectors
# (wider rows: one launch a column chunk): 8 warps of 32 lanes, 4 passes.
# A call's launches are made once a shape (``_plan``): a change of these
# knobs after a call takes ``_plan.cache_clear()``.
ITEM_WIDTH = 8
_TEAM_VECS = 32 * 8 * 4


@dataclass(frozen=True)
class Segments:
    """An index vector as CSR. ``index`` [E] int64 holds each item's
    segment in item order; the items of segment i are those at positions
    ``ptr[i]..ptr[i+1]`` of the stable sorted order, which is ``perm`` (int32)
    or, for a sorted index, the items themselves (``perm`` None). ``work``
    [n, 4] int32 is the kernels' work list: every segment as (segment,
    begin, end, 0): first the ``n_hub`` hubs (``HUB_ITEMS`` items or more),
    longest first, then the other live segments (longest first where there
    are fewer items than segments, as in a sparse residual, whose long rows
    would otherwise set the tail; else in segment order, which keeps the
    gathers of neighbouring rows together), then the empty ones, so its
    first ``n_live`` rows are the segments that have items. ``src`` and
    ``val``, when given, are the gather-sum's operands (kernel (a)) and
    ``items`` [E, 2] int32 them packed in segment order: (src, the bits of
    val as float32)."""

    index: torch.Tensor
    ptr: torch.Tensor
    perm: torch.Tensor | None
    n: int
    work: torch.Tensor
    n_hub: int
    n_live: int
    src: torch.Tensor | None = None
    val: torch.Tensor | None = None
    items: torch.Tensor | None = None


def _pack_items(seg: Segments, src: torch.Tensor, val: torch.Tensor) -> torch.Tensor:
    """(src, val) of every item in segment order as [E, 2] int32: src and
    the bits of val as float32, one 8-byte load an item for kernel (a)."""
    if src.shape != seg.index.shape or val.shape != seg.index.shape:
        raise ValueError(f"src {tuple(src.shape)} and val {tuple(val.shape)} must match the "
                         f"index {tuple(seg.index.shape)}")
    src, val = src.int(), val.float()
    if seg.perm is not None:
        order = seg.perm.long()
        src, val = src[order], val[order]
    return torch.stack([src, val.view(torch.int32)], 1).contiguous()


def segments(index: torch.Tensor, n: int, src: torch.Tensor | None = None,
             val: torch.Tensor | None = None) -> Segments:
    """The ``Segments`` of ``index`` (values in [0, n)) on its device, with
    the gather-sum's ``src`` and ``val`` packed when given (both or
    neither). Reads the index on the host once: build it with the graph, not
    in an epoch."""
    index = index.long().contiguous()
    if index.dim() != 1 or index.numel() >= 2**31 or n >= 2**31:
        raise ValueError(f"segments take a 1-d index of < 2^31 items into < 2^31 "
                         f"segments, got {tuple(index.shape)} into {n}")
    if index.numel() and not (0 <= int(index.min()) and int(index.max()) < n):
        raise ValueError(f"index values outside [0, {n})")
    if (src is None) != (val is None):
        raise ValueError("segments pack src and val together")
    if index.numel() < 2 or bool((index[1:] >= index[:-1]).all()):
        ordered, perm = index, None
    else:
        ordered, order = torch.sort(index, stable=True)
        perm = order.int()
    ptr = torch.searchsorted(ordered, torch.arange(n + 1, device=index.device)).int()
    lengths = (ptr[1:] - ptr[:-1]).long()
    # the work list: hubs longest first, the other live segments, the empty ones
    group = torch.where(lengths >= HUB_ITEMS, 0, torch.where(lengths > 0, 1, 2))
    ids = torch.arange(n, device=index.device)
    longest = index.numel() < n
    key = torch.where((group == 0) | ((group == 1) & longest), -lengths, ids)
    order = torch.sort(key, stable=True).indices
    order = order[torch.sort(group[order], stable=True).indices]
    work = torch.stack([order, ptr[:-1].long()[order], ptr[1:].long()[order],
                        torch.zeros_like(order)], 1).int().contiguous()
    seg = Segments(index=index, ptr=ptr, perm=perm, n=n, work=work,
                   n_hub=int((group == 0).sum()), n_live=int((group < 2).sum()))
    if src is None:
        return seg
    return dataclasses.replace(seg, src=src, val=val, items=_pack_items(seg, src, val))


@dataclass(frozen=True)
class Layout:
    """The kernels' division of one call's work (``layout``).
    ``vec_bytes`` 0: the item walker, a group of 8 lanes a segment (a warp
    for a hub), lane j loading item k + j's row. Else the column walker:
    rows of ``nvec`` vectors of ``vec_bytes``; a segment is owned by a
    group of ``group`` lanes of a warp (``team`` 1) or by a team of
    ``team`` warps, lane t holding vectors t + p·lanes for p < ``passes``;
    with ``hubs``, the work list's hubs go to teams of ``hub_team`` warps,
    one vector of ``hub_vec_bytes`` a lane (else the rest's units walk them
    too)."""

    vec_bytes: int
    nvec: int
    group: int
    passes: int
    team: int
    hub_team: int
    hubs: bool
    hub_vec_bytes: int


def _vec_bytes(width: int, esize: int, align: int) -> int:
    """The widest vector (at most ``MAX_VEC_BYTES``) that divides a row of
    ``width`` elements of ``esize`` bytes and ``align``, the alignment of
    the call's addresses and row strides."""
    vb = MAX_VEC_BYTES
    while vb > esize and (align % vb or width * esize % vb):
        vb //= 2
    return vb


def layout(width: int, esize: int, align: int) -> Layout:
    """The layout of a call over rows of ``width`` elements of ``esize``
    bytes whose addresses and row strides are multiples of ``align`` bytes:
    rows of up to ``HALF_WARP_VECS`` vectors to half warps, rows of up to
    ``WARP_ROW_BYTES`` (and 128 vectors) to a warp (up to 4 passes), up to
    256 vectors to a team of warps one vector a lane, up
    to ``_TEAM_VECS`` to a team of 8 warps or fewer, 2 or 4 passes; hubs to
    teams of up to 8 warps, one vector a lane, the narrowest (at most
    ``HUB_VEC_BYTES``) that fits (wider rows: no hub kernel). The wrapper cuts rows wider than
    ``_TEAM_VECS`` vectors into column chunks."""
    if width <= ITEM_WIDTH:
        return Layout(0, width, 8, 1, 1, 1, True, 0)
    vb = _vec_bytes(width, esize, align)
    nvec = width * esize // vb
    if nvec > _TEAM_VECS:
        raise ValueError(f"{nvec} vectors a row exceed a launch's {_TEAM_VECS}")
    hub_vb = esize
    while hub_vb < min(vb, HUB_VEC_BYTES) and width * esize > 32 * 8 * hub_vb:
        hub_vb *= 2
    hub_team = -(-(width * esize // hub_vb) // 32)
    hub = (hub_team, True, hub_vb) if hub_team <= 8 else (1, False, vb)

    def passes_for(lanes):
        return next(p for p in (1, 2, 4) if lanes * p >= nvec)

    if nvec <= HALF_WARP_VECS:
        return Layout(vb, nvec, 16, passes_for(16), 1, *hub)
    if nvec <= 128 and width * esize <= WARP_ROW_BYTES:
        return Layout(vb, nvec, 32, passes_for(32), 1, *hub)
    if nvec <= 256:
        return Layout(vb, nvec, 32, 1, -(-nvec // 32), *hub)
    passes = 2 if nvec <= 512 else 4
    return Layout(vb, nvec, 32, passes, -(-nvec // (32 * passes)), *hub)


def _column_chunks(width: int, esize: int, align: int) -> list[tuple[int, int]]:
    """(first column, columns) of each launch over rows of ``width``: at
    most ``_TEAM_VECS`` vectors a launch (one launch for every width the
    models use)."""
    step = _TEAM_VECS * _vec_bytes(width, esize, align) // esize
    return [(c, min(step, width - c)) for c in range(0, width, step)]


@functools.cache
def _plan(width: int, esize: int, align: int) -> tuple:
    """The launches of a call over rows of ``width`` elements of ``esize``
    bytes aligned to ``align`` bytes, made once a shape: per column chunk
    (its byte offset, whether it takes the hub kernel, the layout's
    arguments from the width on)."""
    plan = []
    for c0, cols in _column_chunks(width, esize, align):
        lay = layout(cols, esize, align)
        plan.append((c0 * esize, lay.hubs, (cols, lay.vec_bytes, lay.group, lay.passes,
                                            lay.team, lay.hub_team, lay.hub_vec_bytes)))
    return tuple(plan)


def _launch(fn, what: str, key: str, seg: Segments, n_work: int, first, base: torch.Tensor,
            ld_in: int, out: torch.Tensor, width: int) -> None:
    """Launch kernel ``fn`` (``pgcn_gather_sum`` or ``pgcn_segment_sum``)
    over the first ``n_work`` entries of ``seg``'s work list: ``first`` its
    leading arguments, ``base`` the row source (x or values, rows ``ld_in``
    apart), once a column chunk of out's rows of ``width``."""
    if seg.work.device != out.device:
        raise ValueError(f"segments on {seg.work.device}, tensors on {out.device}")
    ld_out, esize = out.stride(0), out.element_size()
    base_ptr, out_ptr = base.data_ptr(), out.data_ptr()
    # the alignment (a power of two, at most 16) of both addresses and row strides
    align = math.gcd(16, base_ptr, out_ptr, ld_in * esize, ld_out * esize)
    work, code = seg.work.data_ptr(), _DTYPE_CODE[out.dtype]
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream().cuda_stream
        for off, hubs, args in _plan(width, esize, align):
            n_hub = seg.n_hub if hubs else 0
            _build.check(fn(work, n_hub, seg.n_live, n_work, *first, base_ptr + off, ld_in, code,
                            out_ptr + off, ld_out, *args, stream), what)
            # the hub kernel runs where there are hubs, the walk kernel where
            # other entries are left
            launches[key + "_hub"] += n_hub > 0
            launches[key] += n_work > n_hub


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


def gather_sum(x: torch.Tensor, seg: Segments, n_chunks: int = 1) -> torch.Tensor:
    """``out[i] = Σ_{e: seg.index[e] = i} val[e]·x[src[e]]`` in item order,
    [seg.n, F] in x's dtype (f32 or bf16), over the ``src`` and ``val``
    that ``seg`` was built with. Kernel (a) for CUDA tensors (float32 sums
    over ``seg.items``; ``n_chunks`` unused: it builds no [E, F] product),
    the plain version for CPU ones."""
    if seg.items is None:
        raise ValueError("gather_sum takes Segments built with src and val "
                         "(segments(index, n, src, val))")
    if x.device.type == "cpu":
        return gather_sum_plain(x, seg.index, seg.src, seg.val, seg.n, n_chunks)
    if x.device.type != "cuda":
        raise ValueError(f"gather_sum: unsupported device {x.device}")
    _check_dtype(x, "gather_sum")
    x = x.contiguous()
    F = x.shape[1]
    out = torch.empty((seg.n, F), dtype=x.dtype, device=x.device)  # every row is written
    if seg.n == 0 or F == 0:
        return out.zero_()
    _launch(_build.load_library().pgcn_gather_sum, "ordered gather-sum kernel", "gather_sum",
            seg, seg.n, (seg.items.data_ptr(),), x, F, out, F)
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
    if seg.n_live == 0 or W == 0:
        return out
    values = values.contiguous()
    perm = seg.perm.data_ptr() if seg.perm is not None else None
    _launch(_build.load_library().pgcn_segment_sum, "ordered segment-sum kernel",
            "segment_sum", seg, seg.n_live, (perm,), values, W, out, W)
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
    def forward(ctx, x, seg, seg_t):
        ctx.seg_t = seg_t
        return gather_sum(x, seg)

    @staticmethod
    def backward(ctx, g):
        # the transpose: Σ over the items with src = j of val·g[index]
        return gather_sum(g.contiguous(), ctx.seg_t), None, None


def gather_sum_t(x: torch.Tensor, seg: Segments, seg_t: Segments) -> torch.Tensor:
    """Differentiable ``gather_sum(x, seg)``: the backward is the
    transposed sum over ``seg_t``, the ``Segments`` of seg's src over x's
    rows, built with ``seg.index`` and the same val as its src and val."""
    if seg_t.n != x.shape[0]:
        raise ValueError(f"transposed segments over {seg_t.n} rows for x of {x.shape[0]}")
    return _GatherSum.apply(x, seg, seg_t)
