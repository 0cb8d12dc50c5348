"""Block-sparse tile attention for the GAT: CUDA kernels and plain versions.

Port of ``parallel_gcn_tpu/ops/tile_attention.py``: the softmax-attended
aggregation

    out_i = Σ_j softmax_j(LeakyReLU(s_i + t_j)) · v_j,   j ∈ N(i) ∪ {i}

over a tile-packed graph (the BCSR pattern, plus the COO residual of hybrid
builds), differentiable in (s, t, v), in two forms: ``gat_attend_tiles``
(one card, square symmetric packs) and ``gat_attend_rect`` (a mesh rank's
slab: local dest rows × the source buffer, ``RectAttention``). The kernels
in ``csrc/tile_attention.cu`` and ``csrc/tile_attention_rect.cu`` run the
tile part:

- K5 (``gat_fwd_tiles``, ``gat_fwd_rect``; replaces ``_fwd_kernel``): one
  walk over the pack's live entries gives the unnormalized numerator
  ``acc`` and the online-softmax statistics (m, den) per destination row;
- K6 (``gat_bwd_tiles``, replaces ``_bwd_kernel``): from the saved
  (m, den, ρ = Σ g·out), the forward orientation of each tile entry gives
  ds and the mirrored orientation gives dt and dv. The mirror trick needs a
  symmetric edge set, which ``data.graph.split_dense_tiles`` guarantees for
  the tiles and the residual alike;
- K7 (``gat_bwd_rect``; replaces ``_bwd_rect_row_kernel`` and
  ``_bwd_rect_col_kernel``): a slab is not symmetric, so a row sweep over
  the slab gives ds and a sweep over its transposed column-sorted copy
  gives dt and dv in buffer space.

K5, K6 and both K7 sweeps read the live entries from the pack's
``attn_index``, listed once per pack, not from its tiles.

The COO residual's statistics merge with the tiles' by the flash rescale
(``den = den_t·e^{m_t−m} + den_r``) in plain torch, as the JAX package leaves
them to XLA; its per-edge terms are summed in edge order by the ordered
segment sums of ``ops.cuda_segment`` (by destination; on a slab dt and dv
by source, through a source-sorted permutation built with the slab). Attention dropout (``rate`` > 0) drops the numerator terms with
the undropped denominator; the mask is ``hash_keep`` of (dest, src, head,
int32 seed), bit-identical to the JAX package's, so no mask is ever stored.
The kernels read the seed from device memory (a slot the trainer rewrites
each epoch, or an int the wrapper writes there), so a captured launch draws
a new mask each replay.

The JAX package view-splits tiles wider than 512 columns (a TPU VMEM limit);
the kernels here take whole tiles. The mask hashes global ids, so the result
is the same either way.

Each wrapper runs the kernel for CUDA tensors and the plain PyTorch version
(``gat_fwd_tiles_plain``, ``gat_bwd_tiles_plain``, ``gat_bwd_rect_row_plain``,
``gat_bwd_rect_col_plain``: the same per-edge formulas as the residual code,
over the pack's live entries) for CPU tensors.
``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from parallel_gcn_tpu_torch.ops import _build
from parallel_gcn_tpu_torch.ops.cuda_bcsr import _DTYPE_CODE, BCSR, slab_pack
from parallel_gcn_tpu_torch.ops.cuda_dropout import Seed, _mulhilo, seed_tensor
from parallel_gcn_tpu_torch.ops.cuda_segment import Segments, segment_sum_, segments

_NEG = -1e9  # masked-logit fill (finite: empty rows stay finite, exp -> 0)
_M32 = 0xFFFFFFFF
_EDGE_CHUNK = 1 << 22  # edges per step of the plain versions

# the CUDA kernels' limits (register arrays sized at compile time)
MAX_HEADS = 8
MAX_HD = 256

# kernel launches by wrapper: "gat_fwd" (K5), "gat_bwd" (K6), "gat_fwd_rect"
# (K5 over a mesh slab), "gat_bwd_rect_row" and "gat_bwd_rect_col" (K7)
launches = {"gat_fwd": 0, "gat_bwd": 0, "gat_fwd_rect": 0, "gat_bwd_rect_row": 0,
            "gat_bwd_rect_col": 0}


# ---------------------------------------------------------------------------
# attention dropout: the stateless per-edge hash mask
# ---------------------------------------------------------------------------


def rate_to_threshold(rate: float) -> int:
    """uint32 threshold with P(hash < thr) = 1 − rate (Python's round, as the
    JAX package computes it)."""
    return min(int(round((1.0 - rate) * 2.0**32)), 2**32 - 1)


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """Low 32 bits of x·c for int64 x holding a uint32 and a uint32 c."""
    return _mulhilo(c, x)[1]


def hash_keep(dest: torch.Tensor, src: torch.Tensor, h: int, seed: Seed,
              threshold: int) -> torch.Tensor:
    """Boolean keep-mask of the murmur3-style mix of (dest, src, head, seed),
    bit-identical to the JAX package's ``_hash_keep``; ``dest``/``src`` are
    integer id tensors (broadcastable), ``seed`` an int32 or a slot holding
    one (not read on the host)."""
    if isinstance(seed, torch.Tensor):
        seed_word = seed.reshape(()).to(device=dest.device, dtype=torch.int64) & _M32
    else:
        seed_word = int(seed) & _M32
    k = (
        _mul32(dest.long() & _M32, 0x9E3779B1)
        + _mul32(src.long() & _M32, 0x85EBCA6B)
        + ((h * 0xC2B2AE35) & _M32)
        + seed_word
    ) & _M32
    k = k ^ (k >> 16)
    k = _mul32(k, 0x7FEB352D)
    k = k ^ (k >> 15)
    k = _mul32(k, 0x846CA68B)
    k = k ^ (k >> 16)
    return k < threshold


def edge_keep(rrow: torch.Tensor, rcol: torch.Tensor, H: int, seed: Seed,
              rate: float) -> torch.Tensor:
    """[E, H] keep-mask for edges with dest ``rrow`` and src ``rcol``."""
    thr = rate_to_threshold(rate)
    return torch.stack([hash_keep(rrow, rcol, h, seed, thr) for h in range(H)], dim=1)


def _inv_keep(rate: float) -> float:
    """1/(1 − rate) rounded to float32, as the kernels multiply by it."""
    return float(np.float32(1.0 / (1.0 - rate)))


def _leaky(x: torch.Tensor, slope: float) -> torch.Tensor:
    return torch.where(x >= 0, x, slope * x)


def _leaky_grad(x: torch.Tensor, slope: float) -> torch.Tensor:
    return torch.where(x >= 0, 1.0, slope)


# ---------------------------------------------------------------------------
# per-edge formulas: the COO residual and the plain tile versions
# ---------------------------------------------------------------------------


def _masked(live: torch.Tensor | None, x: torch.Tensor, fill: float) -> torch.Tensor:
    return x if live is None else torch.where(live, x, fill)


def _edge_logits(sf, tf, dest, src, live, slope):
    """[E, H] logits LeakyReLU(s_dest + t_src), _NEG where not ``live``."""
    return _masked(live, _leaky(sf[dest] + tf[src], slope), _NEG)


def _edge_max(m: torch.Tensor, dest: torch.Tensor, e: torch.Tensor) -> None:
    """m[dest] = max(m[dest], e), in place (a max is exact in any order)."""
    m.scatter_reduce_(0, dest[:, None].expand_as(e), e, "amax", include_self=True)


def _sums(seg: Segments | None, index: torch.Tensor, n: int):
    """What ``segment_sum_`` sums ``index``'s terms by: ``seg`` where the
    caller built it (the residual's, with its graph); else the raw index on
    the CPU, or its segments built here (a host sync: the plain versions)."""
    if seg is not None:
        return seg
    return index if index.device.type == "cpu" else segments(index, n)


def _edge_accumulate(dest, src, live, e, m, v32, rate, seed, den, acc,
                     seg: Segments | None = None) -> None:
    """den += Σ w, acc += Σ w̃·v over the edges, w = exp(e − m_dest) (masked
    before the exp via e = _NEG, re-masked after), w̃ = w·keep/(1 − rate),
    summed by ``dest`` in edge order (``seg``: dest's segments)."""
    by = _sums(seg, dest, den.shape[0])
    w = _masked(live, torch.exp(e - m[dest]), 0.0)
    segment_sum_(den, by, w)
    if rate > 0.0:
        keep = edge_keep(dest, src, w.shape[1], seed, rate)
        w = torch.where(keep, w * _inv_keep(rate), 0.0)
    segment_sum_(acc, by, w[:, :, None] * v32[src])


def _edge_bwd(dest, src, live, sf, tf, v32, g, m, den_g, rho, slope, rate,
              seed, ds, dt, dv, seg: Segments | None = None) -> None:
    """Gradient contributions of the edges (dest, src), in place. The forward
    orientation gives ds[dest]; the mirrored orientation (the edge (src, dest),
    present by symmetry) gives dt[dest] and dv[dest], so every sum is over
    ``dest``, in edge order (``seg``: dest's segments). Logits are masked to
    _NEG before the exp: padding edges point at padding rows whose m is
    _NEG."""
    by = _sums(seg, dest, ds.shape[0])
    inv = _inv_keep(rate) if rate > 0.0 else 1.0
    pre = sf[dest] + tf[src]
    a = _masked(live, torch.exp(_masked(live, _leaky(pre, slope), _NEG) - m[dest])
                / den_g[dest], 0.0)
    dot_a = torch.sum(g[dest] * v32[src], dim=-1)
    if rate > 0.0:
        dot_a = torch.where(edge_keep(dest, src, a.shape[1], seed, rate), dot_a * inv, 0.0)
    segment_sum_(ds, by, a * (dot_a - rho[dest]) * _leaky_grad(pre, slope))

    pre_m = sf[src] + tf[dest]
    a_m = _masked(live, torch.exp(_masked(live, _leaky(pre_m, slope), _NEG) - m[src])
                  / den_g[src], 0.0)
    dot_b = torch.sum(g[src] * v32[dest], dim=-1)
    a_mn = a_m
    if rate > 0.0:
        # the mirror edge's own ids: dest = src, src = dest
        keep_m = edge_keep(src, dest, a.shape[1], seed, rate)
        dot_b = torch.where(keep_m, dot_b * inv, 0.0)
        a_mn = torch.where(keep_m, a_m * inv, 0.0)
    segment_sum_(dt, by, a_m * (dot_b - rho[src]) * _leaky_grad(pre_m, slope))
    segment_sum_(dv, by, a_mn[:, :, None] * g[src])


def _edge_chunks(dest: torch.Tensor, src: torch.Tensor):
    for e0 in range(0, dest.shape[0], _EDGE_CHUNK):
        yield dest[e0 : e0 + _EDGE_CHUNK], src[e0 : e0 + _EDGE_CHUNK]


def gat_fwd_tiles_plain(pack: BCSR, s, t, v, *, slope: float, rate: float = 0.0,
                        seed: Seed = 0):
    """Plain PyTorch version of K5: (acc [n, H, D], m [n, H], den [n, H]),
    all float32, over the pack's edges; rows without edges keep m = _NEG,
    den = 0, acc = 0. ``s`` is indexed by the pack's rows, ``t`` and ``v``
    by its columns (the same nodes for a square pack)."""
    n, H = s.shape
    sf, tf, v32 = s.float(), t.float(), v.float()
    dest, src = pack.live_entries
    m = torch.full((n, H), _NEG, dtype=torch.float32, device=s.device)
    for d, c in _edge_chunks(dest, src):
        _edge_max(m, d, _edge_logits(sf, tf, d, c, None, slope))
    den = torch.zeros_like(m)
    acc = torch.zeros((n, H, v.shape[2]), dtype=torch.float32, device=v.device)
    for d, c in _edge_chunks(dest, src):
        _edge_accumulate(d, c, None, _edge_logits(sf, tf, d, c, None, slope),
                         m, v32, rate, seed, den, acc)
    return acc, m, den


def gat_bwd_tiles_plain(pack: BCSR, s, t, v, g, m, den, rho, *, slope: float,
                        rate: float = 0.0, seed: Seed = 0):
    """Plain PyTorch version of K6: (ds [n, H], dt [n, H], dv [n, H, D]),
    float32, the pack's part of the gradient from the forward's (m, den) and
    ρ = Σ_d g·out."""
    sf, tf, v32, g = s.float(), t.float(), v.float(), g.float()
    den_g = torch.clamp(den, min=1e-16)
    ds = torch.zeros_like(m)
    dt = torch.zeros_like(m)
    dv = torch.zeros_like(v32)
    dest, src = pack.live_entries
    for d, c in _edge_chunks(dest, src):
        _edge_bwd(d, c, None, sf, tf, v32, g, m, den_g, rho, slope, rate, seed,
                  ds, dt, dv)
    return ds, dt, dv


# ---------------------------------------------------------------------------
# the kernels' wrappers
# ---------------------------------------------------------------------------


def _check_shapes(pack: BCSR, s: torch.Tensor, v: torch.Tensor) -> None:
    """``s`` by the pack's rows, ``v`` by its columns."""
    n, H = s.shape
    if H > MAX_HEADS or H * v.shape[2] > MAX_HD:
        raise ValueError(f"tile attention kernels take heads <= {MAX_HEADS} and "
                         f"heads·d <= {MAX_HD}, got {H} heads of {v.shape[2]}")
    if v.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"tile attention kernels take f32 or bf16 v, got {v.dtype}")
    if pack.n_rows != n or pack.n_nodes != v.shape[0]:
        raise ValueError(f"pack is [{pack.n_rows}, {pack.n_nodes}], tensors have "
                         f"{n} rows and {v.shape[0]} columns")


def _check_on_device(tensors, device) -> None:
    for x in tensors:
        if x.device != device or not x.is_contiguous():
            raise ValueError("tile pack must be contiguous and on the inputs' device")


def _check_walk_args(pack: BCSR, s: torch.Tensor, v: torch.Tensor) -> None:
    """The arguments of K5/K6/K7, which walk the pack's ``attn_index`` and
    schedule, not its tiles."""
    _check_shapes(pack, s, v)
    if pack.tile_r % 8:
        raise ValueError(f"tile attention kernels need tile_r % 8 == 0, got {pack.tile_r}")
    sched = pack.schedule
    _check_on_device((pack.tiles, sched.seg_row, sched.seg_slot, sched.multi_row,
                      sched.multi_slot_ptr), s.device)


def _walk_args(pack: BCSR) -> list:
    """The pack's AttnIndex (built on first use) and schedule, as K5/K6/K7
    take them."""
    idx, sched = pack.attn_index, pack.schedule
    return [idx.ptr.data_ptr(), idx.col.data_ptr(), sched.seg_row.data_ptr(),
            sched.seg_slot.data_ptr(), sched.n_seg, sched.multi_row.data_ptr(),
            sched.multi_slot_ptr.data_ptr(), sched.multi_row.shape[0], pack.tile_r]


def _dropout_args(rate: float, seed: Seed, device) -> tuple[list, torch.Tensor | None]:
    """The kernels' attention-dropout arguments (on, seed pointer, threshold,
    1/keep) and the int32 seed tensor the pointer points into (keep it alive
    until the launch); an int seed is reduced to 32 bits."""
    if rate <= 0.0:
        return [0, None, 0, 1.0], None
    slot = seed_tensor(seed if isinstance(seed, torch.Tensor) else int(seed) & _M32, device,
                       torch.int32)
    return [1, slot.data_ptr(), rate_to_threshold(rate), _inv_keep(rate)], slot


def _padded_width(H: int, D: int) -> tuple[int, int]:
    """The kernels' padded row layout: each head's D features in P (D
    rounded up to 8) slots, rows S values apart, S an odd multiple of 8
    (16-byte vectors, no power-of-two row stride)."""
    P = -(-D // 8) * 8
    S = H * P
    return P, S + 8 if (S // 8) % 2 == 0 else S


def _node_records(s, t, m, den, rho) -> torch.Tensor:
    """K6's per-node records [n, R] f32: head h's s | t | m | max(den, 1e-16)
    | ρ at [5h, 5h + 5), R = 5H rounded up to 4 (16-byte records)."""
    n, H = m.shape
    rec = torch.zeros((n, -(-5 * H // 4) * 4), dtype=torch.float32, device=m.device)
    rec[:, : 5 * H] = torch.stack(
        [s.float(), t.float(), m, torch.clamp(den, min=1e-16), rho], dim=2).reshape(n, 5 * H)
    return rec


def _fwd(pack: BCSR, s, t, v, slope: float, rate: float, seed: Seed, key: str):
    """K5 (CUDA tensors) or its plain version (CPU tensors); a launch
    counts under ``launches[key]``."""
    if s.device.type == "cpu":
        return gat_fwd_tiles_plain(pack, s, t, v, slope=slope, rate=rate, seed=seed)
    if s.device.type != "cuda":
        raise ValueError(f"tile attention forward: unsupported device {s.device}")
    _check_walk_args(pack, s, v)
    n, H = s.shape
    D = v.shape[2]
    HD = H * D
    P, S = _padded_width(H, D)
    sf, tf = s.float().contiguous(), t.float().contiguous()
    vf = v.reshape(v.shape[0], HD).contiguous()
    vp = torch.empty((v.shape[0], S), dtype=v.dtype, device=v.device)  # the kernel pads v
    width = HD + 2 * H  # out rows: acc | m | den
    out = torch.empty((n, width), dtype=torch.float32, device=s.device)
    ws = torch.empty((pack.schedule.n_slots, pack.tile_r, width),
                     dtype=torch.float32, device=s.device)
    walk = _walk_args(pack)
    drop, _slot = _dropout_args(rate, seed, s.device)
    lib = _build.load_library()
    with torch.cuda.device(s.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.pgcn_gat_fwd(
            *walk, sf.data_ptr(), tf.data_ptr(), vf.data_ptr(), v.shape[0],
            _DTYPE_CODE[v.dtype], vp.data_ptr(), P, S, out.data_ptr(), ws.data_ptr(), H, D,
            float(slope), *drop, ctypes.c_void_p(stream),
        )
    _build.check(rc, "tile attention forward kernel")
    launches[key] += 1
    return out[:, :HD].view(n, H, D), out[:, HD : HD + H], out[:, HD + H :]


def gat_fwd_tiles(pack: BCSR, s, t, v, *, slope: float, rate: float = 0.0,
                  seed: Seed = 0):
    """The pack's part of the attention forward: (acc [n, H, D], m [n, H],
    den [n, H]) float32. K5 for CUDA tensors, the plain version for CPU
    ones."""
    return _fwd(pack, s, t, v, slope, rate, seed, "gat_fwd")


def gat_bwd_tiles(pack: BCSR, s, t, v, g, m, den, rho, *, slope: float,
                  rate: float = 0.0, seed: Seed = 0):
    """The pack's part of the attention backward: (ds [n, H], dt [n, H],
    dv [n, H, D]) float32 from the forward's (m, den) and ρ = Σ_d g·out. K6
    for CUDA tensors, the plain version for CPU ones."""
    if s.device.type == "cpu":
        return gat_bwd_tiles_plain(pack, s, t, v, g, m, den, rho, slope=slope,
                                   rate=rate, seed=seed)
    if s.device.type != "cuda":
        raise ValueError(f"gat_bwd_tiles: unsupported device {s.device}")
    _check_walk_args(pack, s, v)
    n, H, D = v.shape
    HD = H * D
    node = _node_records(s, t, m, den, rho)
    P, S = _padded_width(H, D)
    gf = g.reshape(n, HD).float().contiguous()
    vf = v.reshape(n, HD).contiguous()
    # the kernel pads g and v into these
    gp = torch.empty((n, S), dtype=torch.float32, device=v.device)
    vp = torch.empty((n, S), dtype=v.dtype, device=v.device)
    width = HD + 2 * H  # out rows: dv | ds | dt
    out = torch.empty((n, width), dtype=torch.float32, device=s.device)
    ws = torch.empty((pack.schedule.n_slots, pack.tile_r, width),
                     dtype=torch.float32, device=s.device)
    walk = _walk_args(pack)
    drop, _slot = _dropout_args(rate, seed, s.device)
    lib = _build.load_library()
    with torch.cuda.device(s.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.pgcn_gat_bwd(
            *walk, node.data_ptr(), gf.data_ptr(), vf.data_ptr(), n, _DTYPE_CODE[v.dtype],
            gp.data_ptr(), vp.data_ptr(), P, S, out.data_ptr(), ws.data_ptr(), H, D,
            float(slope), *drop, ctypes.c_void_p(stream),
        )
    _build.check(rc, "tile attention backward kernel")
    launches["gat_bwd"] += 1
    return out[:, HD : HD + H], out[:, HD + H :], out[:, :HD].view(n, H, D)


# ---------------------------------------------------------------------------
# mesh slabs: local dest rows × the source buffer (K5 rect, K7)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class RectAttention:
    """A mesh rank's attention packs on its device (from
    ``parallel.partition.gat_mesh_pack``): ``rows`` is the row-sorted slab
    (local dest rows × buffer columns); ``cols`` is the column-sorted copy
    stored TRANSPOSED (rows: buffer rows, columns: local dest rows), so the
    K7 column sweep walks a buffer row's entries as one unit of its
    ``attn_index``. Zero tiles are dropped from both. ``residual`` is the
    COO residual (rrow, rcol, rlive [E, 1], the ``Segments`` of rrow over the
    rows and of rcol over the buffer) or None when no rank has one."""

    rows: BCSR
    cols: BCSR
    residual: tuple | None

    @property
    def n_rows(self) -> int:
        return self.rows.n_rows

    @property
    def n_buf(self) -> int:
        return self.rows.n_nodes


def rect_attention(tiles_r, trow_r, tcol_r, tiles_c, trow_c, tcol_c, res_row, res_col,
                   res_val, has_res: bool, n_rows: int, n_buf: int, dtype,
                   device) -> RectAttention:
    """One rank's ``RectAttention`` on ``device`` from its host arrays (one
    rank's slice of a ``GATMeshPack``; tiles converted to ``dtype``)."""
    rows = slab_pack(tiles_r, trow_r, tcol_r, n_rows, n_buf, dtype, device)
    live = tiles_c.reshape(tiles_c.shape[0], -1).any(axis=1)
    cols = slab_pack(np.ascontiguousarray(tiles_c[live].transpose(0, 2, 1)),
                     tcol_c[live], trow_c[live], n_buf, n_rows, dtype, device)
    residual = None
    if has_res:
        rval = torch.from_numpy(np.asarray(res_val, np.float32)).to(device)
        rrow = torch.from_numpy(res_row.astype(np.int64)).to(device)
        rcol = torch.from_numpy(res_col.astype(np.int64)).to(device)
        residual = (rrow, rcol, (rval != 0.0)[:, None], segments(rrow, n_rows),
                    segments(rcol, n_buf))
    return RectAttention(rows=rows, cols=cols, residual=residual)


def _edge_rect_bwd(dest, src, live, sf, tf, v32, g, m, den_g, rho, slope, rate, seed,
                   ds=None, dt=None, dv=None, dest_seg: Segments | None = None,
                   src_seg: Segments | None = None) -> None:
    """Gradient terms of the edges (dest, src) in the forward orientation
    only (a slab is not symmetric), in place: ds at ``dest``; dt and dv at
    ``src`` (buffer space), each summed in edge order (``dest_seg``,
    ``src_seg``: their segments). Logits are masked to _NEG before the
    exp."""
    inv = _inv_keep(rate) if rate > 0.0 else 1.0
    pre = sf[dest] + tf[src]
    a = _masked(live, torch.exp(_masked(live, _leaky(pre, slope), _NEG) - m[dest])
                / den_g[dest], 0.0)
    dot = torch.sum(g[dest] * v32[src], dim=-1)
    an = a
    if rate > 0.0:
        keep = edge_keep(dest, src, a.shape[1], seed, rate)
        dot = torch.where(keep, dot * inv, 0.0)
        an = torch.where(keep, a * inv, 0.0)
    term = a * (dot - rho[dest]) * _leaky_grad(pre, slope)
    if ds is not None:
        segment_sum_(ds, _sums(dest_seg, dest, ds.shape[0]), term)
    if dt is not None:
        by_src = _sums(src_seg, src, dt.shape[0])
        segment_sum_(dt, by_src, term)
        segment_sum_(dv, by_src, an[:, :, None] * g[dest])


def gat_bwd_rect_row_plain(rows: BCSR, s, t_buf, v_buf, g, m, den, rho, *,
                           slope: float, rate: float = 0.0, seed: Seed = 0):
    """Plain PyTorch version of the K7 row sweep: ds [n_rows, H] float32 of
    the slab's entries."""
    ds = torch.zeros_like(m)
    dest, src = rows.live_entries
    for d, c in _edge_chunks(dest, src):
        _edge_rect_bwd(d, c, None, s.float(), t_buf.float(), v_buf.float(), g.float(),
                       m, torch.clamp(den, min=1e-16), rho, slope, rate, seed, ds=ds)
    return ds


def gat_bwd_rect_col_plain(cols: BCSR, s, t_buf, v_buf, g, m, den, rho, *,
                           slope: float, rate: float = 0.0, seed: Seed = 0):
    """Plain PyTorch version of the K7 column sweep over the transposed copy
    ``cols``: (dt [n_buf, H], dv [n_buf, H, D]) float32."""
    v32 = v_buf.float()
    dt = torch.zeros((v32.shape[0], m.shape[1]), dtype=torch.float32, device=m.device)
    dv = torch.zeros_like(v32)
    src, dest = cols.live_entries  # transposed: rows are buffer ids
    for c, d in _edge_chunks(src, dest):
        _edge_rect_bwd(d, c, None, s.float(), t_buf.float(), v32, g.float(), m,
                       torch.clamp(den, min=1e-16), rho, slope, rate, seed, dt=dt, dv=dv)
    return dt, dv


def gat_fwd_rect(rows: BCSR, s, t_buf, v_buf, *, slope: float, rate: float = 0.0,
                 seed: Seed = 0):
    """The slab's part of the mesh attention forward: (acc [n_rows, H, D],
    m, den [n_rows, H]) float32; s by local row, t_buf and v_buf by buffer
    row. K5 for CUDA tensors, the plain version for CPU ones."""
    return _fwd(rows, s, t_buf, v_buf, slope, rate, seed, "gat_fwd_rect")


def _rect_records(s, m, den, rho) -> torch.Tensor:
    """K7's per-destination-row records [n, 4H] f32: head h's s | m |
    max(den, 1e-16) | ρ at [4h, 4h + 4) (16-byte records)."""
    n, H = m.shape
    return torch.stack([s.float(), m, torch.clamp(den, min=1e-16), rho],
                       dim=2).reshape(n, 4 * H).contiguous()


def _pad_rows(lib, x: torch.Tensor, H: int, D: int, P: int, S: int) -> torch.Tensor:
    """[n, H·D] → [n, S] in K6's padded layout, by the library's pad kernel."""
    x = x.contiguous()
    xp = torch.empty((x.shape[0], S), dtype=x.dtype, device=x.device)
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    _build.check(lib.pgcn_pad_heads(x.data_ptr(), xp.data_ptr(), _DTYPE_CODE[x.dtype],
                                    x.shape[0], H, D, P, S, stream), "pad_heads kernel")
    return xp


def _rect_bwd_args(s, t_buf, v_buf, g, m, den, rho) -> dict:
    """K7's inputs, shared by both sweeps: per destination row the records
    (``_rect_records``) and g padded per head (f32), per buffer row t (f32)
    and v padded per head (v's dtype)."""
    H = s.shape[1]
    n_buf, _, D = v_buf.shape
    P, S = _padded_width(H, D)
    lib = _build.load_library()
    with torch.cuda.device(s.device):
        return dict(
            nd=_rect_records(s, m, den, rho), tf=t_buf.float().contiguous(),
            gp=_pad_rows(lib, g.reshape(g.shape[0], H * D).float(), H, D, P, S),
            vp=_pad_rows(lib, v_buf.reshape(n_buf, H * D), H, D, P, S), H=H, D=D, P=P, S=S)


def _launch_rect(sweep: str, pack: BCSR, a: dict, slope: float, rate: float,
                 seed: Seed) -> torch.Tensor:
    """One K7 sweep over ``pack``'s live-column index: "row" writes ds
    [n_rows, H]; "col" (over the transposed column copy) writes dv | dt
    [n_buf, H·D + H]."""
    H, D, P, S = a["H"], a["D"], a["P"], a["S"]
    width = H if sweep == "row" else H * D + H
    dev = a["nd"].device
    out = torch.empty((pack.n_rows, width), dtype=torch.float32, device=dev)
    ws = torch.empty((pack.schedule.n_slots, pack.tile_r, width), dtype=torch.float32,
                     device=dev)
    walk = _walk_args(pack)
    drop, _slot = _dropout_args(rate, seed, dev)
    lib = _build.load_library()
    fn = lib.pgcn_gat_bwd_rect_row if sweep == "row" else lib.pgcn_gat_bwd_rect_col
    with torch.cuda.device(dev):
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        rc = fn(*walk, a["nd"].data_ptr(), a["tf"].data_ptr(), a["gp"].data_ptr(),
                a["vp"].data_ptr(), _DTYPE_CODE[a["vp"].dtype], P, S, out.data_ptr(),
                ws.data_ptr(), H, D, float(slope), *drop, stream)
    _build.check(rc, f"rect attention backward kernel ({sweep} sweep)")
    launches[f"gat_bwd_rect_{sweep}"] += 1
    return out


def gat_bwd_rect_row(rows: BCSR, s, t_buf, v_buf, g, m, den, rho, *, slope: float,
                     rate: float = 0.0, seed: Seed = 0):
    """The K7 row sweep: ds [n_rows, H] float32 of the slab's entries, from
    the forward's (m, den) and ρ = Σ_d g·out. The kernel for CUDA tensors,
    the plain version for CPU ones."""
    if s.device.type == "cpu":
        return gat_bwd_rect_row_plain(rows, s, t_buf, v_buf, g, m, den, rho, slope=slope,
                                      rate=rate, seed=seed)
    _check_rect_args(rows, None, s, t_buf, v_buf, g)
    return _launch_rect("row", rows, _rect_bwd_args(s, t_buf, v_buf, g, m, den, rho),
                        slope, rate, seed)


def gat_bwd_rect_col(cols: BCSR, s, t_buf, v_buf, g, m, den, rho, *, slope: float,
                     rate: float = 0.0, seed: Seed = 0):
    """The K7 column sweep over the transposed copy ``cols``: (dt [n_buf, H],
    dv [n_buf, H, D]) float32. The kernel for CUDA tensors, the plain version
    for CPU ones."""
    if s.device.type == "cpu":
        return gat_bwd_rect_col_plain(cols, s, t_buf, v_buf, g, m, den, rho, slope=slope,
                                      rate=rate, seed=seed)
    _check_rect_args(None, cols, s, t_buf, v_buf, g)
    dvt = _launch_rect("col", cols, _rect_bwd_args(s, t_buf, v_buf, g, m, den, rho),
                       slope, rate, seed)
    return _split_dvt(dvt, s.shape[1], v_buf.shape[2])


def _split_dvt(dvt: torch.Tensor, H: int, D: int):
    return dvt[:, H * D :], dvt[:, : H * D].view(-1, H, D)


def _check_rect_args(rows: BCSR | None, cols: BCSR | None, s, t_buf, v_buf, g) -> None:
    if s.device.type != "cuda":
        raise ValueError(f"rect attention backward: unsupported device {s.device}")
    if rows is not None:
        _check_walk_args(rows, s, v_buf)
    if cols is not None:
        _check_walk_args(cols, t_buf, g)


def gat_bwd_rect(attn: RectAttention, s, t_buf, v_buf, g, m, den, rho, *,
                 slope: float, rate: float = 0.0, seed: Seed = 0):
    """The slab's part of the mesh attention backward: ds [n_rows, H],
    dt [n_buf, H], dv [n_buf, H, D] float32, from the forward's (m, den) and
    ρ = Σ_d g·out. K7's row and column sweeps for CUDA tensors, their plain
    versions for CPU ones."""
    kw = dict(slope=slope, rate=rate, seed=seed)
    if s.device.type == "cpu":
        ds = gat_bwd_rect_row_plain(attn.rows, s, t_buf, v_buf, g, m, den, rho, **kw)
        return (ds, *gat_bwd_rect_col_plain(attn.cols, s, t_buf, v_buf, g, m, den, rho,
                                            **kw))
    _check_rect_args(attn.rows, attn.cols, s, t_buf, v_buf, g)
    a = _rect_bwd_args(s, t_buf, v_buf, g, m, den, rho)
    ds = _launch_rect("row", attn.rows, a, slope, rate, seed)
    dvt = _launch_rect("col", attn.cols, a, slope, rate, seed)
    return (ds, *_split_dvt(dvt, a["H"], a["D"]))


# ---------------------------------------------------------------------------
# the differentiable op: tiles (+ COO residual) -> attended aggregation
# ---------------------------------------------------------------------------


def _residual(graph):
    """(rrow, rcol, rlive [E, 1], rrow's segments, None) of a hybrid graph's
    COO residual: on a square pack every sum is by destination."""
    return graph.row, graph.col, (graph.val != 0.0)[:, None], graph.row_seg, None


def _attend_impl(fwd, pack, residual, s, t, v, slope, rate, seed):
    """Forward evaluation: ``fwd`` (K5 square or rect) over ``pack``, then
    the COO ``residual`` (or None) merged by the flash rescale: (out [n, H,
    D], m, den [n, H]), float32, n = s's rows."""
    acc, m, den = fwd(pack, s, t, v, slope=slope, rate=rate, seed=seed)
    if residual is not None:
        rrow, rcol, rlive, row_seg, _ = residual
        sf, tf = s.float(), t.float()
        e_r = _edge_logits(sf, tf, rrow, rcol, rlive, slope)
        m_r = torch.full_like(m, _NEG)
        _edge_max(m_r, rrow, e_r)
        m_all = torch.maximum(m, m_r)
        scale = torch.exp(m - m_all)
        den = den * scale
        acc = acc * scale[:, :, None]
        _edge_accumulate(rrow, rcol, rlive, e_r, m_all, v.float(), rate, seed, den, acc,
                         seg=row_seg)
        m = m_all
    out = acc / torch.clamp(den, min=1e-16)[:, :, None]
    return out, m, den


class _GatAttend(torch.autograd.Function):
    @staticmethod
    def forward(ctx, s, t, v, graph, slope, rate, seed):
        out, m, den = _attend_impl(gat_fwd_tiles, graph.bcsr,
                                   _residual(graph) if graph.is_hybrid else None,
                                   s, t, v, slope, rate, seed)
        ctx.save_for_backward(s, t, v, m, den, out)
        ctx.graph, ctx.slope, ctx.rate, ctx.seed = graph, slope, rate, seed
        return out

    @staticmethod
    def backward(ctx, g):
        s, t, v, m, den, out = ctx.saved_tensors
        graph, slope, rate, seed = ctx.graph, ctx.slope, ctx.rate, ctx.seed
        g = g.float()
        rho = torch.sum(g * out, dim=-1)  # [n, H]
        ds, dt, dv = gat_bwd_tiles(graph.bcsr, s, t, v, g, m, den, rho,
                                   slope=slope, rate=rate, seed=seed)
        if graph.is_hybrid:
            rrow, rcol, rlive, row_seg, _ = _residual(graph)
            _edge_bwd(rrow, rcol, rlive, s.float(), t.float(), v.float(), g, m,
                      torch.clamp(den, min=1e-16), rho, slope, rate, seed, ds, dt, dv,
                      seg=row_seg)
        return ds.to(s.dtype), dt.to(t.dtype), dv.to(v.dtype), None, None, None, None


def gat_attend_tiles(graph, s: torch.Tensor, t: torch.Tensor, v: torch.Tensor, *,
                     slope: float, attn_dropout: float = 0.0,
                     seed: Seed | None = None) -> torch.Tensor:
    """Softmax attention aggregation over a tile-packed graph:
    ``out_i = Σ_j softmax_j(LeakyReLU(s_i + t_j)) · v_j`` over the BCSR
    pattern plus (hybrid builds) the COO residual.

    s, t: [n_nodes, heads]; v: [n_nodes, heads, d]. Returns [n_nodes, heads,
    d] float32, differentiable in s, t and v (gradients in their dtypes); the
    backward saves only (m, den, out), never a per-edge tensor.
    ``attn_dropout`` > 0 drops the numerator terms by the hash mask of
    (dest, src, head, ``seed``), an int32 that the rate then requires. The
    edge set must be symmetric (the repo's graph invariant)."""
    pack = graph.bcsr
    if pack is None:
        raise ValueError("gat_attend_tiles needs a tile pack (bcsr/hybrid build)")
    n, H = s.shape
    if t.shape != (n, H) or v.dim() != 3 or v.shape[:2] != (n, H):
        raise ValueError(f"shapes s {tuple(s.shape)}, t {tuple(t.shape)}, "
                         f"v {tuple(v.shape)} do not agree")
    if n != pack.n_nodes:
        raise ValueError(f"{n} rows for a pack of {pack.n_nodes} nodes")
    rate = float(attn_dropout)
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"attn_dropout must be in [0, 1), got {rate}")
    if rate > 0.0 and seed is None:
        raise ValueError("attn_dropout > 0 needs a seed")
    return _GatAttend.apply(s, t, v, graph, float(slope), rate,
                            0 if seed is None else seed)


class _GatAttendRect(torch.autograd.Function):
    @staticmethod
    def forward(ctx, s, t_buf, v_buf, attn, slope, rate, seed):
        out, m, den = _attend_impl(gat_fwd_rect, attn.rows, attn.residual, s, t_buf,
                                   v_buf, slope, rate, seed)
        ctx.save_for_backward(s, t_buf, v_buf, m, den, out)
        ctx.attn, ctx.slope, ctx.rate, ctx.seed = attn, slope, rate, seed
        return out

    @staticmethod
    def backward(ctx, g):
        s, t_buf, v_buf, m, den, out = ctx.saved_tensors
        attn, slope, rate, seed = ctx.attn, ctx.slope, ctx.rate, ctx.seed
        g = g.float()
        rho = torch.sum(g * out, dim=-1)  # [n_rows, H]
        ds, dt, dv = gat_bwd_rect(attn, s, t_buf, v_buf, g, m, den, rho,
                                  slope=slope, rate=rate, seed=seed)
        if attn.residual is not None:
            rrow, rcol, rlive, row_seg, col_seg = attn.residual
            _edge_rect_bwd(rrow, rcol, rlive, s.float(), t_buf.float(), v_buf.float(),
                           g, m, torch.clamp(den, min=1e-16), rho, slope, rate, seed,
                           ds=ds, dt=dt, dv=dv, dest_seg=row_seg, src_seg=col_seg)
        return (ds.to(s.dtype), dt.to(t_buf.dtype), dv.to(v_buf.dtype),
                None, None, None, None)


def gat_attend_rect(s: torch.Tensor, t_buf: torch.Tensor, v_buf: torch.Tensor,
                    attn: RectAttention, *, slope: float, attn_dropout: float = 0.0,
                    seed: Seed | None = None) -> torch.Tensor:
    """Mesh-slab softmax attention: ``out_i = Σ_j α_ij v_j`` for the local
    destination rows i over the source buffer (the slab's tiles plus its COO
    residual hold every edge of i, so the softmax is complete on the rank).

    s: [n_rows, H] by local row; t_buf: [n_buf, H] and v_buf: [n_buf, H, D]
    by buffer row. Returns [n_rows, H, D] float32, differentiable in (s,
    t_buf, v_buf); the (dt, dv) gradients are in buffer space and the
    caller's halo exchange carries them back to their owners. K5 forward and
    the two K7 sweeps on the card. ``attn_dropout`` > 0 drops numerator
    terms by the hash of (local dest id, buffer src id, head, ``seed``)."""
    n, H = s.shape
    if (t_buf.shape != (attn.n_buf, H) or v_buf.dim() != 3
            or v_buf.shape[:2] != (attn.n_buf, H) or n != attn.n_rows):
        raise ValueError(f"shapes s {tuple(s.shape)}, t_buf {tuple(t_buf.shape)}, "
                         f"v_buf {tuple(v_buf.shape)} do not fit a [{attn.n_rows}, "
                         f"{attn.n_buf}] slab")
    rate = float(attn_dropout)
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"attn_dropout must be in [0, 1), got {rate}")
    if rate > 0.0 and seed is None:
        raise ValueError("attn_dropout > 0 needs a seed")
    return _GatAttendRect.apply(s, t_buf, v_buf, attn, float(slope), rate,
                                0 if seed is None else seed)
