"""Block-sparse (BCSR) tile SpMM ``out = Â · x``: CUDA kernel and plain version.

Port of ``parallel_gcn_tpu/ops/pallas_bcsr.py``: the ``BCSR`` pack, its numpy
packer ``build_bcsr``, and the two kernels, K3 ``_bcsr_kernel`` (value
tiles) and K4 ``_bcsr_kernel_scaled`` (int8 pattern tiles with the symmetric
normalization ``diag(d)·B·diag(d)`` rebuilt per tile), both in
``csrc/bcsr_spmm.cu``: tensor cores over the tiles for a bf16 compute dtype
(K4 at wide F on its own ``wgmma`` body, ``spmm_body``); for f32, CUDA-core
FMAs over the pack's live entries only (``spmm_index``, built once a pack),
or over every entry of dense value tiles (``dense_tiles=True``, K8's
backward).

The pack holds only the nonempty tile_r×tile_c blocks of Â, sorted by
tile-row; its ``TileSchedule`` cuts each tile-row's tiles into short
segments, the kernel's units of work. The packed matrix is
symmetric (square tiles of a symmetric Â, or a symmetric edge split for
rectangular tiles, see ``data.graph.split_dense_tiles``), so the backward is
the same product on the cotangent.

A mesh rank's slab (``parallel.partition``) is a rectangular pack: its rows
are the rank's local rows, its columns the source buffer (the gathered
features or the compact local+halo buffer); ``slab_pack`` builds it on the
device and ``bcsr_matmul_rect`` is K3 over it, the counterpart of the JAX
package's ``bcsr_matmul_rect``.

The GAT attention kernels (``ops.tile_attention``) do not read the tiles:
they walk the pack's ``attn_index``, its live columns listed once per (segment,
row) of ``schedule``.

``bcsr_matmul_impl`` runs the kernel for CUDA tensors and
``bcsr_matmul_plain`` for CPU tensors; ``launches`` counts kernel launches.
For a bf16 compute dtype the kernel reads x as one bf16 buffer whose rows
are padded to a multiple of 16 features (``pad_features``), so that every
row is 16-byte aligned for its copy pipeline; K4's wide body reads x in
place where its rows already are whole 16-byte pieces (``wide_features``).
"""

from __future__ import annotations

import ctypes
import dataclasses
from dataclasses import dataclass
from functools import cached_property

import numpy as np
import torch

from parallel_gcn_tpu_torch.device import torch_dtype
from parallel_gcn_tpu_torch.ops import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}

# kernel launches by wrapper: "bcsr" (K3, value tiles), "bcsr_scaled" (K4),
# "bcsr_rect" (K3 over a mesh slab); the f32 body over the live-entry index
# counts under the same names with "_f32", K4's wide body as
# "bcsr_scaled_wide" (the bf16 body and the dense f32 body of K8's backward
# under the names alone)
launches = {"bcsr": 0, "bcsr_scaled": 0, "bcsr_rect": 0,
            "bcsr_f32": 0, "bcsr_scaled_f32": 0, "bcsr_rect_f32": 0, "bcsr_scaled_wide": 0}


# Tiles per segment of a tile-row's work (see tile_schedule) for the tile
# attention kernels: about the mean tiles per tile-row of the synth-reddit
# pack (5.7), so ordinary rows stay one segment and only hub rows are split.
SEGMENT_TILES = 8
# The same for the SpMM kernel, whose CTAs cover 256 tile rows: the grid's
# balance knob, with the CTA shape (csrc/bcsr_spmm.cu CtaShape), chosen by
# measurement on the H100 (PERF.md).
SPMM_SEGMENT_TILES = 4
# The bf16 kernel's x rows are padded to a multiple of this many features.
F_ALIGN = 16
# The f32 body's index (csrc/bcsr_spmm.cu kWalkChunk): tile columns a staged
# chunk of x.
SPMM_CHUNK = 128
# F above which the f32 body takes 16 rows × 128 features a warp (else 32
# rows × 64 features); chosen by measurement on the H100 (PERF.md).
SPMM_WALK_WIDE = 64
# F from which K4's bf16 body is the wide one (csrc/bcsr_spmm.cu
# spmm_pipe_kernel_wgmma, 208 features a CTA): a width between the GCN's
# (41, 82 and its lanes' 164, 328), which stay on the pipe body, and SAGE's
# and GIN's (600, 602 and their lanes'), which take the wide one. Not the
# measured crossover: on the H100 the two bodies tie at 82 columns and the
# wide one is faster from 164 up (PERF.md). 416 keeps every GCN width, solo
# and laned, on the pipe body, so the GCN's runs keep their kernel.
SPMM_WIDE_F = 416


@dataclass(frozen=True)
class TileSchedule:
    """How the kernel splits the pack's work: segments of at most
    ``SEGMENT_TILES`` consecutive tiles of one tile-row. A tile-row with
    one segment is written straight to the output; the segments of a split
    row write workspace slots that a second pass sums in segment order."""

    seg_tile_ptr: torch.Tensor  # int32 [n_seg + 1]: segment s = tiles [ptr[s], ptr[s+1])
    seg_row: torch.Tensor  # int32 [n_seg]: its tile-row
    seg_slot: torch.Tensor  # int32 [n_seg]: workspace slot, -1 = write out directly
    multi_row: torch.Tensor  # int32 [n_multi]: tile-rows with several segments
    multi_slot_ptr: torch.Tensor  # int32 [n_multi + 1]: their slot ranges
    n_tile_rows: int
    n_slots: int

    @property
    def n_seg(self) -> int:
        return self.seg_row.shape[0]

    def to(self, device) -> "TileSchedule":
        return dataclasses.replace(
            self, **{f: getattr(self, f).to(device) for f in (
                "seg_tile_ptr", "seg_row", "seg_slot", "multi_row", "multi_slot_ptr")}
        )


def tile_schedule(tile_rows: np.ndarray, n_tile_rows: int,
                  segment_tiles: int = SEGMENT_TILES) -> TileSchedule:
    """Cut each tile-row's tiles (``tile_rows`` sorted ascending) into
    segments of at most ``segment_tiles``; a tile-row without tiles gets one
    empty segment (it writes zeros)."""
    ptr = np.searchsorted(tile_rows, np.arange(n_tile_rows + 1), side="left")
    counts = np.diff(ptr)
    nseg = np.maximum(1, -(-counts // segment_tiles))
    seg_row = np.repeat(np.arange(n_tile_rows), nseg)
    first = np.concatenate([[0], np.cumsum(nseg)[:-1]])
    j = np.arange(len(seg_row)) - first[seg_row]
    begin = np.minimum(ptr[seg_row] + j * segment_tiles, ptr[seg_row + 1])
    multi = nseg > 1
    seg_slot = np.full(len(seg_row), -1, dtype=np.int64)
    in_multi = multi[seg_row]
    seg_slot[in_multi] = np.arange(int(in_multi.sum()))
    i32 = lambda a: torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32))
    return TileSchedule(
        seg_tile_ptr=i32(np.concatenate([begin, [ptr[-1]]])),
        seg_row=i32(seg_row),
        seg_slot=i32(seg_slot),
        multi_row=i32(np.flatnonzero(multi)),
        multi_slot_ptr=i32(np.concatenate([[0], np.cumsum(nseg[multi])])),
        n_tile_rows=n_tile_rows,
        n_slots=int(in_multi.sum()),
    )


@dataclass(frozen=True)
class AttnIndex:
    """The live columns of a pack, listed per unit of the attention
    kernels' work: unit u = seg·tile_r + r is row r (local to the tile) of
    segment ``seg`` of ``BCSR.schedule``. Its entries are
    ``col[ptr[u] : ptr[u + 1]]``, global column ids in the order of the
    segment's tiles and, within a tile, of the column."""

    ptr: torch.Tensor  # int32 [n_seg·tile_r + 1]
    col: torch.Tensor  # int32 [live entries]


def attn_index(pack: "BCSR") -> AttnIndex:
    """``pack``'s ``AttnIndex``, built on the pack's device from its tiles
    (nonzero entries; -0.0 is zero), 64 tiles at a time."""
    sched = pack.schedule
    dev = pack.tiles.device
    tile_r, tile_c = pack.tile_r, pack.tile_c
    seg_len = (sched.seg_tile_ptr[1:] - sched.seg_tile_ptr[:-1]).long()
    seg_of_tile = torch.repeat_interleave(torch.arange(sched.n_seg, device=dev), seg_len)
    keys, cols = [], []
    for b0 in range(0, pack.n_tiles, 64):
        t, r, c = (pack.tiles[b0 : b0 + 64] != 0).nonzero(as_tuple=True)
        t = t + b0
        keys.append(seg_of_tile[t] * tile_r + r)
        cols.append(pack.tile_cols[t].long() * tile_c + c)
    key = torch.cat(keys) if keys else torch.zeros(0, dtype=torch.long, device=dev)
    col = torch.cat(cols) if cols else torch.zeros(0, dtype=torch.long, device=dev)
    # nonzero lists (tile, row, column) in order and a segment's tiles are
    # consecutive, so a stable sort by unit leaves (tile, column) within each
    order = torch.sort(key, stable=True).indices
    counts = torch.bincount(key, minlength=sched.n_seg * tile_r)
    ptr = torch.zeros(sched.n_seg * tile_r + 1, dtype=torch.int32, device=dev)
    ptr[1:] = torch.cumsum(counts, 0)
    return AttnIndex(ptr=ptr, col=col[order].to(torch.int32))


@dataclass(frozen=True)
class SpmmIndex:
    """The live entries of a pack as the f32 SpMM body walks them: in
    (tile, chunk of ``SPMM_CHUNK`` columns, row position, column) order,
    entry e is ``ent[e] = (value bits, row << 16 | column in the chunk)``
    with the value in f32 as the Pallas kernel rounds it (a scaled pack's
    fl(fl(k·d_c)·d_r), else the tile's value). Row r sits at position
    ``spmm_position(r, tile_r)``: the kernel's warps take consecutive
    positions, so each takes rows 16 apart and a block of dense rows spreads
    over all of them. Position q of chunk ch of tile t is entries
    ``rptr[i] : rptr[i + 1]``, i = (t·n_chunks + ch)·tile_r + q."""

    ent: torch.Tensor  # int32 [E, 2]
    rptr: torch.Tensor  # int32 [T·n_chunks·tile_r + 1]


def spmm_position(r, tile_r: int):
    """The walk's position of tile row r: rows 16 apart are neighbours
    (r = 16·g + m sits at m·(tile_r / 16) + g)."""
    return (r % 16) * (tile_r // 16) + r // 16


def spmm_row(q, tile_r: int):
    """The tile row at walk position q (``spmm_position``'s inverse)."""
    g = tile_r // 16
    return (q % g) * 16 + q // g


def spmm_index(pack: "BCSR", batch_bytes: int = 1 << 28) -> SpmmIndex:
    """``pack``'s ``SpmmIndex``, built on the pack's device from its tiles
    (nonzero entries; -0.0 is zero), about ``batch_bytes`` of tiles at a
    time."""
    tr, tc = pack.tile_r, pack.tile_c
    if tc % SPMM_CHUNK or tr % 16 or tr > 1 << 15:
        raise ValueError(f"the f32 SpMM index needs tile_c a multiple of {SPMM_CHUNK} and "
                         f"tile_r of 16 (at most 32768), got ({tr}, {tc})")
    nch = tc // SPMM_CHUNK
    dev = pack.tiles.device
    d = pack.sym_scale
    step = max(1, batch_bytes // (tr * tc * pack.tiles.element_size()))
    ents, keys = [], []
    for b0 in range(0, pack.n_tiles, step):
        # the tiles as [t, chunk, row % 16, row // 16, column in the chunk]:
        # nonzero lists the entries in the kernel's order
        blk = pack.tiles[b0 : b0 + step].view(-1, tr // 16, 16, nch, SPMM_CHUNK)
        t, ch, m, g, c = blk.permute(0, 3, 2, 1, 4).nonzero(as_tuple=True)
        v = blk[t, g, m, ch, c].float()
        r = g * 16 + m
        t = t + b0
        if d is not None:
            col = pack.tile_cols[t].long() * tc + ch * SPMM_CHUNK + c
            v = (v * d[col]) * d[pack.tile_rows[t].long() * tr + r]
        keys.append(((t * nch + ch) * tr + m * (tr // 16) + g).to(torch.int32))
        ents.append(torch.stack([v.view(torch.int32), ((r << 16) | c).int()], 1))
    n_keys = pack.n_tiles * nch * tr
    rptr = torch.zeros(n_keys + 1, dtype=torch.int32, device=dev)
    if keys:
        rptr[1:] = torch.cumsum(torch.bincount(torch.cat(keys).long(), minlength=n_keys), 0)
    ent = torch.cat(ents) if ents else torch.zeros((0, 2), dtype=torch.int32, device=dev)
    return SpmmIndex(ent=ent.contiguous(), rptr=rptr)


@dataclass(frozen=True)
class BCSR:
    """Row-sorted pack of the nonempty tile_r×tile_c blocks of Â, or of a
    mesh rank's slab (rows: ``n_rows`` local rows; columns: the
    ``n_nodes``-row source buffer)."""

    tiles: torch.Tensor  # [T, tile_r, tile_c] float32 / bfloat16 / int8
    tile_rows: torch.Tensor  # int32 [T], ascending
    tile_cols: torch.Tensor  # int32 [T]
    schedule: TileSchedule  # the attention kernels' split of the work
    spmm_schedule: TileSchedule  # the SpMM kernel's split (SPMM_SEGMENT_TILES)
    n_nodes: int  # padded node count (columns; also the rows of a square pack)
    n_tiles_real: int
    # int8 pattern packs: d ([n_nodes] f32) with v_ij = k_ij·d_i·d_j; None
    # for value packs
    sym_scale: torch.Tensor | None = None
    # mirror_perm[t] = t' with (rows[t'], cols[t']) == (cols[t], rows[t]);
    # square tiles with a symmetric position set only
    mirror_perm: torch.Tensor | None = None

    @property
    def n_tiles(self) -> int:
        return self.tiles.shape[0]

    @property
    def tile_r(self) -> int:
        return self.tiles.shape[1]

    @property
    def tile_c(self) -> int:
        return self.tiles.shape[2]

    @property
    def n_tile_rows(self) -> int:
        return self.schedule.n_tile_rows

    @property
    def n_rows(self) -> int:
        return self.n_tile_rows * self.tile_r

    @cached_property
    def live_entries(self) -> tuple[torch.Tensor, torch.Tensor]:
        """The nonzero entries as int64 global (row, col) ids, in tile order;
        listed once per pack (about 256 MB of tiles at a time) and kept."""
        rows, cols = [], []
        step = max(64, (1 << 28) // (self.tile_r * self.tile_c * self.tiles.element_size()))
        for b0 in range(0, self.n_tiles, step):
            t, r, c = (self.tiles[b0 : b0 + step] != 0).nonzero(as_tuple=True)
            t = t + b0
            rows.append(self.tile_rows[t].long() * self.tile_r + r)
            cols.append(self.tile_cols[t].long() * self.tile_c + c)
        return torch.cat(rows), torch.cat(cols)

    @cached_property
    def attn_index(self) -> AttnIndex:
        """The live columns per (segment, row) that the attention kernels
        walk (``AttnIndex``); built once per pack on its device and kept."""
        return attn_index(self)

    @cached_property
    def spmm_index(self) -> SpmmIndex:
        """The live entries the f32 SpMM body walks (``SpmmIndex``); built
        once per pack on its device and kept."""
        return spmm_index(self)

    @cached_property
    def nonneg_tiles(self) -> bool:
        """Whether every int8 tile entry is ≥ 0 (a multiplicity pattern):
        the SpMM kernel then converts with shorter exact sequences. One
        reduction over the tiles, once per pack."""
        return self.tiles.dtype == torch.int8 and int(self.tiles.min()) >= 0

    def to(self, device) -> "BCSR":
        move = lambda t: None if t is None else t.to(device)
        return dataclasses.replace(
            self, tiles=move(self.tiles), tile_rows=move(self.tile_rows),
            tile_cols=move(self.tile_cols), schedule=self.schedule.to(device),
            spmm_schedule=self.spmm_schedule.to(device),
            sym_scale=move(self.sym_scale), mirror_perm=move(self.mirror_perm),
        )


def build_bcsr(
    rows: np.ndarray,
    cols: np.ndarray,
    vals: np.ndarray,
    n_nodes: int,
    dtype=torch.float32,
    tile: int = 128,
    tile_c: int | None = None,
    sym_scale: np.ndarray | None = None,
) -> BCSR:
    """Pack COO triplets into a CPU ``BCSR`` (same tiles, order and
    mirror permutation as the JAX package's ``build_bcsr``).

    ``n_nodes`` is rounded up to a tile-column multiple. Every tile-row gets
    at least one tile (a zero tile on the diagonal for square tiles).
    ``dtype=int8`` stores the exact edge multiplicity k with
    v_ij = k·d_i·d_j and needs ``sym_scale`` = d."""
    dtype = torch_dtype(dtype)
    tile_r = tile
    tile_c = tile_c or tile_r
    if tile_r % 128 or tile_c % tile_r:
        raise ValueError(f"tile ({tile_r}, {tile_c}): rows a multiple of 128, "
                         "columns a multiple of rows")
    binary = dtype == torch.int8
    if binary and (sym_scale is None or len(sym_scale) < n_nodes):
        raise ValueError("an int8 pattern pack needs sym_scale (d) for every node")
    n_pad = ((n_nodes + tile_c - 1) // tile_c) * tile_c
    live = vals != 0
    rows = rows[live].astype(np.int64)
    cols = cols[live].astype(np.int64)
    vals = vals[live]
    n_tile_cols = n_pad // tile_c
    tile_id = (rows // tile_r) * n_tile_cols + cols // tile_c
    uniq, inverse = np.unique(tile_id, return_inverse=True)
    covered = np.unique(uniq // n_tile_cols)
    missing = np.setdiff1d(np.arange(n_pad // tile_r, dtype=np.int64), covered)
    tile_rows = np.concatenate([uniq // n_tile_cols, missing]).astype(np.int32)
    miss_cols = missing if tile_r == tile_c else np.zeros(len(missing), np.int64)
    tile_cols = np.concatenate([uniq % n_tile_cols, miss_cols]).astype(np.int32)
    order = np.argsort(tile_rows, kind="stable")
    tile_rows = tile_rows[order]
    tile_cols = tile_cols[order]
    T = len(tile_rows)
    # scatter straight into each tile's final (row-sorted) slot: no second
    # copy of a multi-GB pack
    slot = np.empty(T, dtype=np.int64)
    slot[order] = np.arange(T)
    if binary:
        d = np.asarray(sym_scale, np.float64)
        entries = torch.from_numpy(
            np.rint(vals / np.maximum(d[rows] * d[cols], 1e-30)).astype(np.int8)
        )
    else:
        entries = torch.from_numpy(vals.astype(np.float32)).to(dtype)
    tiles = torch.zeros((T, tile_r, tile_c), dtype=dtype)
    tiles[(torch.from_numpy(slot[inverse]), torch.from_numpy(rows % tile_r),
           torch.from_numpy(cols % tile_c))] = entries

    mirror_perm = None
    if tile_r == tile_c:
        pos = tile_rows.astype(np.int64) * n_tile_cols + tile_cols
        mirror = tile_cols.astype(np.int64) * n_tile_cols + tile_rows
        lookup = np.argsort(pos, kind="stable")
        idx = np.clip(np.searchsorted(pos[lookup], mirror), 0, T - 1)
        cand = lookup[idx]
        if np.array_equal(pos[cand], mirror):
            mirror_perm = torch.from_numpy(cand.astype(np.int32))
    return BCSR(
        tiles=tiles,
        tile_rows=torch.from_numpy(tile_rows),
        tile_cols=torch.from_numpy(tile_cols),
        schedule=tile_schedule(tile_rows, n_pad // tile_r),
        spmm_schedule=tile_schedule(tile_rows, n_pad // tile_r, SPMM_SEGMENT_TILES),
        n_nodes=n_pad,
        n_tiles_real=T,
        sym_scale=(
            None if not binary else torch.from_numpy(
                np.pad(np.asarray(sym_scale, np.float32)[:n_nodes],
                       (0, n_pad - n_nodes))
            )
        ),
        mirror_perm=mirror_perm,
    )


def spmm_body(tile_dtype: torch.dtype, scaled: bool, n_feat: int) -> str:
    """The bf16 body of the tile SpMM that a call takes: "wide" (``wgmma``
    over TMA stages, 208 features a CTA) for int8 pattern tiles with
    ``sym_scale`` at F >= ``SPMM_WIDE_F``, else "pipe" (``mma.sync``, 64
    features a CTA): K3's value tiles and the mesh's slabs at every F."""
    return "wide" if tile_dtype == torch.int8 and scaled and n_feat >= SPMM_WIDE_F else "pipe"


def _compute_dtype(bcsr: BCSR, x: torch.Tensor) -> torch.dtype:
    """The dtype both operands are rounded to before the f32-accumulated
    product: x's for int8 tiles (exact 0/k values), else the tile's."""
    return x.dtype if bcsr.tiles.dtype == torch.int8 else bcsr.tiles.dtype


def bcsr_matmul_plain(bcsr: BCSR, x: torch.Tensor, batch: int = 64) -> torch.Tensor:
    """Plain PyTorch version: f32 [n_nodes, F], tiles taken ``batch`` at a
    time so no f32 copy of the whole pack exists. Same operand rounding as
    the kernel; float32 sums in another order."""
    cd = _compute_dtype(bcsr, x)
    tr, tc, F = bcsr.tile_r, bcsr.tile_c, x.shape[1]
    xb = x.to(cd).float().view(bcsr.n_nodes // tc, tc, F)
    out = torch.zeros((bcsr.n_tile_rows, tr, F), dtype=torch.float32, device=x.device)
    rows_all = bcsr.tile_rows.long()
    cols_all = bcsr.tile_cols.long()
    d = bcsr.sym_scale
    for b0 in range(0, bcsr.n_tiles, batch):
        rows = rows_all[b0 : b0 + batch]
        cols = cols_all[b0 : b0 + batch]
        a = bcsr.tiles[b0 : b0 + batch].float()
        if d is not None:
            dc = d.view(-1, tc)[cols]  # [B, tc]
            dr = d.view(-1, tr)[rows]  # [B, tr]
            a = (a * dc[:, None, :]) * dr[:, :, None]
        a = a.to(cd).float()
        # a plain version: the CPU's path, and on the card only beside K3/K4
        # in a comparison (its tile rows repeat; the tolerance covers the order)
        out.index_add_(0, rows, torch.bmm(a, xb[cols]))
    return out.view(-1, F)


def pad_features(x: torch.Tensor) -> torch.Tensor:
    """x [n, F] as one contiguous bf16 buffer [n, F_pad], F_pad the next
    multiple of ``F_ALIGN``, columns F.. zero: x itself when it already is
    one, else one copy (rounding to bf16 on the way)."""
    n, F = x.shape
    f_pad = -(-F // F_ALIGN) * F_ALIGN
    if f_pad == F and x.dtype == torch.bfloat16 and x.is_contiguous():
        return x
    out = torch.zeros((n, f_pad), dtype=torch.bfloat16, device=x.device)
    out[:, :F] = x
    return out


def wide_features(x: torch.Tensor) -> torch.Tensor:
    """x as K4's wide body reads it by TMA: bf16 rows of whole 16-byte
    pieces at a 16-byte address. x itself where it is one (SAGE's 600
    columns), else ``pad_features``' copy (GIN's 602)."""
    if (x.dtype == torch.bfloat16 and x.is_contiguous() and x.shape[1] % 8 == 0
            and x.data_ptr() % 16 == 0):
        return x
    return pad_features(x)


def slab_pack(tiles: np.ndarray, tile_rows: np.ndarray, tile_cols: np.ndarray,
              n_rows: int, n_cols: int, dtype, device) -> BCSR:
    """A rank's tile slab as a rectangular pack on ``device``: ``tiles``
    [T, tile_r, tile_c] (host values, converted to ``dtype``), sorted by
    ``tile_rows`` (local tile-rows), ``tile_cols`` the blocks of the
    ``n_cols``-row source buffer. All-zero tiles (the partition's padding and
    coverage tiles) are dropped: a tile-row left without tiles gets an empty
    segment, whose kernel blocks write zeros."""
    live = tiles.reshape(tiles.shape[0], -1).any(axis=1)
    tile_rows = np.ascontiguousarray(tile_rows[live], dtype=np.int32)
    t = torch.from_numpy(np.ascontiguousarray(tiles[live]))
    return BCSR(
        tiles=t.to(device=device, dtype=torch_dtype(dtype)),
        tile_rows=torch.from_numpy(tile_rows).to(device),
        tile_cols=torch.from_numpy(
            np.ascontiguousarray(tile_cols[live], dtype=np.int32)).to(device),
        schedule=tile_schedule(tile_rows, n_rows // tiles.shape[1]).to(device),
        spmm_schedule=tile_schedule(tile_rows, n_rows // tiles.shape[1],
                                    SPMM_SEGMENT_TILES).to(device),
        n_nodes=n_cols,
        n_tiles_real=int(live.sum()),
    )


def bcsr_matmul_impl(bcsr: BCSR, x: torch.Tensor, launch_key: str | None = None,
                     dense_tiles: bool = False) -> torch.Tensor:
    """out = A·x, f32 [n_rows, F] (x [n_nodes, F]): the kernel for a CUDA
    tensor (K4 for an int8 pattern pack, K3 otherwise), the plain version for
    a CPU one. ``launch_key`` names the ``launches`` entry a launch counts
    under (default: "bcsr_scaled" or "bcsr"; the f32 body over the live
    entries adds "_f32", K4's wide body "_wide"). At an f32 compute dtype
    the kernel walks the pack's live entries (``BCSR.spmm_index``, built at
    the first such call), unless ``dense_tiles`` says the tiles are dense
    values made for this one call (K8's backward): then it multiplies every
    entry."""
    if x.dim() != 2 or x.shape[0] != bcsr.n_nodes:
        raise ValueError(f"x must be [{bcsr.n_nodes}, F], got {tuple(x.shape)}")
    if x.device.type == "cpu":
        return bcsr_matmul_plain(bcsr, x)
    if x.device.type != "cuda":
        raise ValueError(f"bcsr_matmul: unsupported device {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"bcsr kernel takes float32 or bfloat16 x, got {x.dtype}")
    if bcsr.tiles.dtype not in _DTYPE_CODE:
        raise TypeError(f"bcsr kernel takes f32/bf16/int8 tiles, got {bcsr.tiles.dtype}")
    if bcsr.tile_r % 64 or bcsr.tile_c % 64:
        raise ValueError(f"bcsr kernel needs tile_r and tile_c multiples of 64, "
                         f"got ({bcsr.tile_r}, {bcsr.tile_c})")
    sched = bcsr.spmm_schedule
    index = [bcsr.tile_cols, sched.seg_tile_ptr, sched.seg_row, sched.seg_slot,
             sched.multi_row, sched.multi_slot_ptr]
    tensors = [bcsr.tiles, *index]
    scaled = bcsr.sym_scale is not None
    if scaled:
        tensors.append(bcsr.sym_scale)
        if bcsr.tiles.dtype != torch.int8 or bcsr.sym_scale.dtype != torch.float32:
            raise TypeError("scaled bcsr kernel needs int8 tiles and f32 sym_scale")
    for t in tensors:
        if t.device != x.device or not t.is_contiguous():
            raise ValueError("bcsr pack must be contiguous and on x's device")
    if any(t.dtype != torch.int32 for t in index):
        raise TypeError("tile_cols and the schedule must be int32")
    F = x.shape[1]
    out = torch.empty((bcsr.n_tile_rows * bcsr.tile_r, F), dtype=torch.float32,
                      device=x.device)
    if F == 0 or bcsr.n_tile_rows == 0:
        return out
    key = launch_key or ("bcsr_scaled" if scaled else "bcsr")
    cd = _compute_dtype(bcsr, x)
    walk = cd == torch.float32 and not dense_tiles
    wide = cd == torch.bfloat16 and spmm_body(bcsr.tiles.dtype, scaled, F) == "wide"
    if walk:
        if bcsr.tile_c % SPMM_CHUNK:
            raise ValueError(f"the f32 bcsr kernel needs tile_c a multiple of {SPMM_CHUNK}, "
                             f"got {bcsr.tile_c}")
        idx = bcsr.spmm_index
        x = x.float().contiguous()
        # rows of whole 16-byte pieces at a 16-byte address for the staging
        # copies: a copy of x where they are not
        if F % 4:
            x = torch.nn.functional.pad(x, (0, -F % 4))
        elif x.data_ptr() % 16:
            x = x.clone()
    else:
        # a bf16 compute dtype runs a tensor-core body on padded bf16 rows
        # (the wide body on x in place where it can); dense f32 value tiles
        # the FMA kernel on f32 x
        if cd == torch.float32 and bcsr.tiles.dtype != torch.float32:
            raise ValueError("dense_tiles takes f32 value tiles")
        if wide:
            if bcsr.tile_r % 128:
                raise ValueError(f"K4's wide body needs tile_r a multiple of 128, "
                                 f"got {bcsr.tile_r}")
            x = wide_features(x)
        else:
            x = pad_features(x) if cd == torch.bfloat16 else x.float().contiguous()
        if bcsr.tiles.data_ptr() % 16 or x.data_ptr() % 16:
            raise ValueError("bcsr kernel needs 16-byte aligned tiles and x")
    ws = torch.empty((sched.n_slots, bcsr.tile_r, F), dtype=torch.float32,
                     device=x.device)
    lib = _build.load_library()
    with torch.cuda.device(x.device):
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        if walk:
            rc = lib.pgcn_bcsr_spmm_walk(
                idx.ent.data_ptr(), idx.rptr.data_ptr(), sched.seg_tile_ptr.data_ptr(),
                sched.seg_row.data_ptr(), sched.seg_slot.data_ptr(), sched.n_seg,
                sched.multi_row.data_ptr(), sched.multi_slot_ptr.data_ptr(),
                sched.multi_row.shape[0], bcsr.tile_cols.data_ptr(), x.data_ptr(),
                out.data_ptr(), ws.data_ptr(), bcsr.tile_r, bcsr.tile_c, F, x.shape[1],
                int(F > SPMM_WALK_WIDE), stream,
            )
            key += "_f32"
        elif wide:
            rc = lib.pgcn_bcsr_spmm_wide(
                bcsr.tiles.data_ptr(), bcsr.n_tiles, sched.seg_tile_ptr.data_ptr(),
                sched.seg_row.data_ptr(), sched.seg_slot.data_ptr(), sched.n_seg,
                sched.multi_row.data_ptr(), sched.multi_slot_ptr.data_ptr(),
                sched.multi_row.shape[0], bcsr.tile_cols.data_ptr(),
                bcsr.sym_scale.data_ptr(), x.data_ptr(), x.shape[0], x.shape[1],
                out.data_ptr(), ws.data_ptr(), bcsr.tile_r, bcsr.tile_c, F,
                int(bcsr.nonneg_tiles), stream,
            )
            key += "_wide"
        else:
            rc = lib.pgcn_bcsr_spmm(
                bcsr.tiles.data_ptr(), _DTYPE_CODE[bcsr.tiles.dtype],
                sched.seg_tile_ptr.data_ptr(), sched.seg_row.data_ptr(),
                sched.seg_slot.data_ptr(), sched.n_seg,
                sched.multi_row.data_ptr(), sched.multi_slot_ptr.data_ptr(),
                sched.multi_row.shape[0], bcsr.tile_cols.data_ptr(),
                bcsr.sym_scale.data_ptr() if scaled else None,
                x.data_ptr(), _DTYPE_CODE[x.dtype], out.data_ptr(), ws.data_ptr(),
                bcsr.tile_r, bcsr.tile_c, F, x.shape[1], int(bcsr.nonneg_tiles), stream,
            )
    _build.check(rc, "bcsr kernel")
    launches[key] += 1
    return out


class _BcsrMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, bcsr):
        ctx.bcsr, ctx.x_dtype = bcsr, x.dtype
        return bcsr_matmul_impl(bcsr, x)

    @staticmethod
    def backward(ctx, g):
        # the packed matrix is symmetric: Aᵀg = Ag
        return bcsr_matmul_impl(ctx.bcsr, g.contiguous()).to(ctx.x_dtype), None


def bcsr_matmul(bcsr: BCSR, x: torch.Tensor) -> torch.Tensor:
    """out = Â·x (f32 [n_nodes, F]) with Â in BCSR form, differentiable in
    x; the backward is the same product on the cotangent."""
    return _BcsrMatmul.apply(x, bcsr)


def bcsr_matmul_rect(slab: BCSR, x_buf: torch.Tensor) -> torch.Tensor:
    """K3 over a mesh rank's slab: out [n_rows, F] f32 = slab · x_buf
    ([n_nodes, F], the source buffer). Not differentiable: the mesh
    aggregation's backward is the same aggregation of the cotangent
    (``parallel.train_parallel``)."""
    if slab.sym_scale is not None:
        raise ValueError("a mesh slab scales its features outside the kernel (K3)")
    return bcsr_matmul_impl(slab, x_buf, launch_key="bcsr_rect")
