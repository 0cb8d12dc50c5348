"""Graph partitioning for node-partitioned training over several GPUs.

Numpy copy of ``parallel_gcn_tpu/parallel/partition.py`` (the port imports
nothing of the JAX package): contiguous row blocks of the CSR per rank, the
rank's edges (all edges whose destination row it owns) kept local, and the
remote source features fetched by a collective during aggregation
(``parallel.train_parallel``). Every rank gets arrays of the same shape,
padded to the largest rank's, and the arrays equal the JAX package's array
for array (``tests/test_torch_partition.py``).

Ported: the flat COO partition with the all_gather or boundary halo
(``partition_graph``), the tile-slab partition (``partition_graph_hybrid``,
with slab balancing and int8 pattern slabs) and the mesh GAT's rect packs
(``gat_mesh_pack``). Not ported: the ring (``partition_graph_ring``) and the
adaptive push/pull halo (``adaptive=True`` raises NotImplementedError).
"""

from __future__ import annotations

import math
import warnings
from dataclasses import dataclass

import numpy as np
import torch

from parallel_gcn_tpu_torch.data.graph import HostCSR, pad_to_multiple
from parallel_gcn_tpu_torch.device import torch_dtype


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not yet ported to parallel_gcn_tpu_torch (use halo=all_gather "
        "or halo=boundary)"
    )


@dataclass(frozen=True)
class ShardedGraph:
    """Per-rank COO slabs, stacked on a leading rank axis.

    ``row_local[d, e]`` is the destination row within rank d's shard (rows
    [d·n_local, (d+1)·n_local) of the padded graph); ``col[d, e]`` is the
    global source node id (all_gather halo) or, with ``send_idx`` (boundary
    halo), the row of the compact ``[x_local ; received halo rows]`` buffer.
    ``send_idx[d]`` lists, in ``n_dev`` chunks of ``halo_size``, the local
    rows rank d sends to each peer. Padding entries carry val 0 and
    in-bounds indices."""

    row_local: np.ndarray  # int32 [n_dev, e_local]
    col: np.ndarray  # int32 [n_dev, e_local]
    val: np.ndarray  # float32 [n_dev, e_local]
    n_dev: int
    n_local: int  # rows per rank
    n_real_nodes: int
    n_real_edges: int
    send_idx: np.ndarray | None = None  # int32 [n_dev, n_dev*halo_size]
    halo_size: int = 0  # rows per (src-rank, dst-rank) exchange slab

    @property
    def n_nodes_pad(self) -> int:
        return self.n_dev * self.n_local

    @property
    def n_buf(self) -> int:
        """Rows of the per-rank source buffer the column indices resolve
        against: the gathered matrix or the compact local+halo buffer."""
        if self.send_idx is not None:
            return self.n_local + self.n_dev * self.halo_size
        return self.n_nodes_pad


def _slice_coo_by_dest(rows, cols, vals, n_dev, n_local, n_pad):
    """Cut row-sorted COO triplets into per-dest-rank slabs of equal shape
    (padding: val 0, row n_local-1, col n_pad-1)."""
    rows = np.asarray(rows, dtype=np.int64)
    bounds = np.searchsorted(rows, np.arange(1, n_dev) * n_local)
    starts = np.concatenate([[0], bounds])
    ends = np.concatenate([bounds, [len(rows)]])
    e_local = pad_to_multiple(max(int((ends - starts).max()), 1), 128)
    row_s = np.full((n_dev, e_local), n_local - 1, dtype=np.int32)
    col_s = np.full((n_dev, e_local), n_pad - 1, dtype=np.int32)
    val_s = np.zeros((n_dev, e_local), dtype=np.float32)
    for d in range(n_dev):
        s, e = int(starts[d]), int(ends[d])
        cnt = e - s
        row_s[d, :cnt] = (rows[s:e] - d * n_local).astype(np.int32)
        col_s[d, :cnt] = cols[s:e]
        val_s[d, :cnt] = vals[s:e]
    return row_s, col_s, val_s


def _build_boundary_exchange(needed, n_dev, n_local, block: int = 1):
    """The all_to_all send schedule of a boundary halo.

    ``needed[d][b]``: GLOBAL row ids (owned by rank b, b≠d) that rank d must
    fetch, in the order they take in d's halo slab for b. Returns
    ``(send_idx, H)``: ``H`` the per-(src, dst) slab size (the longest
    request, rounded up to ``block``) and ``send_idx[b]`` the LOCAL rows rank
    b sends to each destination d (chunk d). Padding slots send local row
    0; receivers never index them."""
    H = 1
    for d in range(n_dev):
        for b in range(n_dev):
            H = max(H, len(needed[d][b]))
    H = pad_to_multiple(H, block)
    send_idx = np.zeros((n_dev, n_dev * H), np.int32)
    for b in range(n_dev):
        for d in range(n_dev):
            req = np.asarray(needed[d][b], dtype=np.int64)
            if len(req):
                send_idx[b, d * H : d * H + len(req)] = req - b * n_local
    return send_idx, H


def _remap_cols_boundary(col_s, val_s, n_dev, n_local):
    """Row-granular boundary remap of flat COO slabs: each rank's remote
    boundary set from its live columns, and ``col`` rewritten against the
    compact ``[local ; halo]`` buffer. Returns (col_new, send_idx, H)."""
    needed = [[np.empty(0, np.int64)] * n_dev for _ in range(n_dev)]
    for d in range(n_dev):
        g = col_s[d].astype(np.int64)[val_s[d] != 0]
        owner = g // n_local
        for b in range(n_dev):
            if b != d:
                needed[d][b] = np.unique(g[owner == b])
    send_idx, H = _build_boundary_exchange(needed, n_dev, n_local)
    col_new = np.zeros_like(col_s)
    for d in range(n_dev):
        g = col_s[d].astype(np.int64)
        owner = g // n_local
        res = np.zeros(len(g), np.int64)
        local = owner == d
        res[local] = g[local] - d * n_local
        for b in range(n_dev):
            m = (~local) & (owner == b)
            if m.any():
                res[m] = n_local + b * H + np.searchsorted(needed[d][b], g[m])
        res[val_s[d] == 0] = 0  # padding edges: val 0, point at local row 0
        col_new[d] = res.astype(np.int32)
    return col_new, send_idx, H


def _boundary_pays_off(n_local, n_dev, halo, n_pad, kind: str,
                       fallback: bool) -> bool:
    """True when the compact halo buffer is strictly smaller than the
    gathered matrix; otherwise warn (the all_to_all pads every (src, dst)
    slab to the largest pair, so one skewed pair can inflate all of them)
    and return False, and callers with ``fallback`` take the all_gather
    layout."""
    n_buf = n_local + n_dev * halo
    if n_buf < n_pad:
        return True
    warnings.warn(
        f"{kind} halo buffer ({n_buf} rows = {n_local} local + {n_dev} peers "
        f"x {halo}-row slabs) is not smaller than the all_gathered matrix "
        f"({n_pad} rows); the per-pair boundary sets are too uniform for the "
        "max-padded all_to_all slabs to pay off"
        + (" — falling back to the all_gather halo" if fallback else ""),
        stacklevel=3,
    )
    return False


def partition_graph(
    csr: HostCSR, n_dev: int, node_pad: int = 8, boundary: bool = False,
    adaptive: bool = False, boundary_fallback: bool = False,
) -> ShardedGraph:
    """Split a host CSR into ``n_dev`` contiguous row blocks.

    Rows are padded so every rank owns the same number (a multiple of
    ``node_pad``); edge slabs are padded to the largest rank's count rounded
    to 128. ``boundary=True`` rewrites columns against the compact
    local+halo buffer and builds the all_to_all schedule;
    ``boundary_fallback=True`` returns the all_gather layout instead when
    that buffer would not be smaller (``_boundary_pays_off``)."""
    if adaptive:
        raise _not_ported("the adaptive (push/pull) halo")
    n_local = pad_to_multiple(-(-csr.n_rows // n_dev), node_pad)
    n_pad = n_local * n_dev

    rows = csr.row_ids().astype(np.int64)
    cols = csr.indices.astype(np.int64)
    row_local, col, val = _slice_coo_by_dest(rows, cols, csr.values, n_dev,
                                             n_local, n_pad)
    send_idx, halo = None, 0
    if boundary:
        col_b, send_idx, halo = _remap_cols_boundary(col, val, n_dev, n_local)
        if _boundary_pays_off(n_local, n_dev, halo, n_pad, "boundary",
                              boundary_fallback):
            col = col_b
        elif boundary_fallback:
            send_idx, halo = None, 0
        else:
            col = col_b
    return ShardedGraph(
        row_local=row_local, col=col, val=val, n_dev=n_dev, n_local=n_local,
        n_real_nodes=csr.n_rows, n_real_edges=csr.nnz,
        send_idx=send_idx, halo_size=halo,
    )


@dataclass(frozen=True)
class HybridShardedGraph:
    """Row-block tile partition: per-rank tile slabs (local tile-rows ×
    tile-cols of the source buffer) plus a per-rank COO residual (local dest
    rows × buffer source cols), padded to identical shapes.

    ``tiles`` holds float32 or int8 values on the host; ``tile_dtype`` is
    the dtype they take on the device (bf16 tiles are kept as their
    bf16-rounded float32 values, which convert exactly)."""

    tiles: np.ndarray  # [n_dev, T, tile_r, tile_c] float32 or int8
    trow: np.ndarray  # int32 [n_dev, T] — LOCAL tile-row ids, ascending
    tcol: np.ndarray  # int32 [n_dev, T] — buffer tile-col ids
    res_row: np.ndarray  # int32 [n_dev, e_local] — local dest rows
    res_col: np.ndarray  # int32 [n_dev, e_local] — buffer source cols
    res_val: np.ndarray  # float32 [n_dev, e_local] (int8 mode: multiplicity, 0 pad)
    n_dev: int
    n_local: int
    n_real_nodes: int
    n_real_edges: int
    # int8 pattern slabs: row-sharded d (= deg^{-1/2}) [n_dev, n_local]; the
    # aggregation is d_local ⊙ (slab(halo(d_local ⊙ x)) + residual)
    sym_scale: np.ndarray | None = None
    send_idx: np.ndarray | None = None  # boundary halo, as ShardedGraph
    halo_size: int = 0
    # slab-balancing node permutation (new row -> old row) in whole tile_c
    # blocks; node-keyed arrays must be permuted the same way
    node_perm: np.ndarray | None = None
    tile_dtype: str = "float32"

    @property
    def n_nodes_pad(self) -> int:
        return self.n_dev * self.n_local

    @property
    def n_buf(self) -> int:
        if self.send_idx is not None:
            return self.n_local + self.n_dev * self.halo_size
        return self.n_nodes_pad


def _balance_block_perm(g_trow, n_blocks, blocks_per_dev, n_dev, rpt,
                        threshold: float = 1.2):
    """Greedy LPT assignment of tile_c-sized node blocks to ranks so the
    per-rank tile counts flatten (every rank pads its slab to the largest).
    Returns block_perm (new block -> old block), or None when the natural
    order is already within ``threshold``."""
    w = np.bincount(g_trow // rpt, minlength=n_blocks).astype(np.int64)
    cur = w.reshape(n_dev, blocks_per_dev).sum(axis=1)
    if cur.max() <= threshold * max(cur.mean(), 1.0):
        return None
    order = np.argsort(-w, kind="stable")
    loads = np.zeros(n_dev, np.int64)
    caps = np.full(n_dev, blocks_per_dev, np.int64)
    assign = np.empty(n_blocks, np.int64)
    for blk in order:
        open_devs = np.flatnonzero(caps > 0)
        d = open_devs[np.argmin(loads[open_devs])]
        assign[blk] = d
        loads[d] += w[blk]
        caps[d] -= 1
    # rank-major; within a rank ascending old block ids (keeps locality)
    return np.concatenate([np.flatnonzero(assign == d) for d in range(n_dev)])


def _hybrid_boundary(tiles, trow, tcol, res_col, res_val, n_dev, n_local,
                     tile_c):
    """Boundary exchange of tile slabs: rank d fetches whole remote
    tile-column blocks its tiles touch plus the remote residual source rows
    outside those blocks. Rewrites ``tcol``/``res_col`` in place to buffer
    coordinates; returns (send_idx, halo_size)."""
    Bl = n_local // tile_c
    blocks_req = [[None] * n_dev for _ in range(n_dev)]
    rows_req = [[None] * n_dev for _ in range(n_dev)]
    needed = [[np.empty(0, np.int64)] * n_dev for _ in range(n_dev)]
    for d in range(n_dev):
        # zero tiles (slab padding, coverage) point at the rank's own first
        # block so they never inflate the halo
        zero = ~tiles[d].reshape(tiles[d].shape[0], -1).any(axis=1)
        tcol[d][zero] = d * Bl
        blk = np.unique(tcol[d].astype(np.int64))
        g = res_col[d].astype(np.int64)[res_val[d] != 0]
        for b in range(n_dev):
            if b == d:
                continue
            bb = blk[blk // Bl == b]
            rr = np.unique(g[g // n_local == b])
            rr = rr[~np.isin(rr // tile_c, bb)]
            blocks_req[d][b] = bb
            rows_req[d][b] = rr
            needed[d][b] = np.concatenate([
                (bb[:, None] * tile_c + np.arange(tile_c)).reshape(-1), rr,
            ])
    send_idx, H = _build_boundary_exchange(needed, n_dev, n_local, block=tile_c)
    for d in range(n_dev):
        t = tcol[d].astype(np.int64)
        owner = t // Bl
        local = owner == d
        new_t = np.zeros_like(t)
        new_t[local] = t[local] - d * Bl
        for b in range(n_dev):
            m = (~local) & (owner == b)
            if m.any():
                new_t[m] = (n_local + b * H) // tile_c + np.searchsorted(
                    blocks_req[d][b], t[m]
                )
        tcol[d] = new_t.astype(np.int32)

        g = res_col[d].astype(np.int64)
        owner = g // n_local
        local = owner == d
        new_g = np.zeros_like(g)
        new_g[local] = g[local] - d * n_local
        for b in range(n_dev):
            m = (~local) & (owner == b)
            if not m.any():
                continue
            bb, rr = blocks_req[d][b], rows_req[d][b]
            gm = g[m]
            in_blk = np.isin(gm // tile_c, bb)
            base = n_local + b * H
            res = np.empty(len(gm), np.int64)
            res[in_blk] = (
                base
                + np.searchsorted(bb, gm[in_blk] // tile_c) * tile_c
                + gm[in_blk] % tile_c
            )
            res[~in_blk] = (
                base + len(bb) * tile_c + np.searchsorted(rr, gm[~in_blk])
            )
            new_g[m] = res
        new_g[res_val[d] == 0] = 0  # padding edges point at local row 0
        res_col[d] = new_g.astype(np.int32)
    return send_idx, H


@dataclass(frozen=True)
class GATMeshPack:
    """Per-rank rect tile packs of the mesh GAT's attention
    (``ops.tile_attention.gat_attend_rect``): local dest rows × the source
    buffer. The row-sorted pack is the partition's slab, wide tiles
    view-split to ≤ 512 columns; a column-sorted copy of the same tiles
    drives the backward's source-side sweep, with zero tiles covering every
    buffer block. Residual and boundary exchange as in the partition."""

    tiles_r: np.ndarray  # [n_dev, T, tile_r, tile_c] — sorted by trow_r
    trow_r: np.ndarray  # int32 [n_dev, T] LOCAL tile-row ids, ascending
    tcol_r: np.ndarray  # int32 [n_dev, T] buffer tile-col ids
    tiles_c: np.ndarray  # [n_dev, Tc, tile_r, tile_c] — sorted by tcol_c
    trow_c: np.ndarray  # int32 [n_dev, Tc]
    tcol_c: np.ndarray  # int32 [n_dev, Tc] ascending, covers every buffer block
    res_row: np.ndarray  # int32 [n_dev, e_local] — local dest rows
    res_col: np.ndarray  # int32 [n_dev, e_local] — buffer source cols
    res_val: np.ndarray  # float32 [n_dev, e_local] (0 = padding edge)
    n_dev: int
    n_local: int
    n_real_nodes: int
    n_real_edges: int
    has_res: bool  # any live residual edge on any rank
    send_idx: np.ndarray | None = None
    halo_size: int = 0
    node_perm: np.ndarray | None = None
    tile_dtype: str = "float32"

    @property
    def n_nodes_pad(self) -> int:
        return self.n_dev * self.n_local

    @property
    def n_buf(self) -> int:
        if self.send_idx is not None:
            return self.n_local + self.n_dev * self.halo_size
        return self.n_nodes_pad


def gat_mesh_pack(hsg: HybridShardedGraph, max_tile_c: int = 512) -> GATMeshPack:
    """The mesh attention packs of a hybrid row-block partition: the
    row-sorted slab with tiles wider than ``max_tile_c`` view-split into
    column strips (the same edge set; kept so the host layout equals the
    JAX package's), and the column-sorted copy with a zero tile for every
    buffer block no tile touches, padded with zero tiles at the last
    block."""
    tiles = np.asarray(hsg.tiles)
    trow = np.asarray(hsg.trow)
    tcol = np.asarray(hsg.tcol)
    n_dev, T, r, c = tiles.shape
    if c > max_tile_c:
        if c % max_tile_c:
            raise ValueError(f"tile_c {c} is not a multiple of {max_tile_c}")
        k = c // max_tile_c
        tiles = (
            tiles.reshape(n_dev, T, r, k, max_tile_c)
            .transpose(0, 1, 3, 2, 4)
            .reshape(n_dev, T * k, r, max_tile_c)
        )
        trow = np.repeat(trow, k, axis=1)
        tcol = (
            tcol[:, :, None] * k + np.arange(k, dtype=tcol.dtype)[None, None]
        ).reshape(n_dev, -1)
        T, c = T * k, max_tile_c
    n_buf = hsg.n_buf
    if n_buf % c:
        raise ValueError(f"buffer of {n_buf} rows is not a multiple of tile_c {c}")
    b_buf = n_buf // c
    rows_per_dev = hsg.n_local // r
    for d in range(n_dev):
        if not np.array_equal(np.unique(trow[d]), np.arange(rows_per_dev)):
            raise ValueError(f"rank {d}: row pack does not cover all local tile-rows")

    missing = [
        np.setdiff1d(np.arange(b_buf, dtype=np.int64),
                     np.unique(tcol[d].astype(np.int64)))
        for d in range(n_dev)
    ]
    Tc = T + max(len(m) for m in missing)
    tiles_c = np.zeros((n_dev, Tc, r, c), tiles.dtype)
    trow_c = np.zeros((n_dev, Tc), np.int32)
    tcol_c = np.full((n_dev, Tc), b_buf - 1, np.int32)
    for d in range(n_dev):
        miss = missing[d]
        tt = np.concatenate([tcol[d].astype(np.int64), miss])
        rr = np.concatenate([trow[d], np.zeros(len(miss), np.int32)])
        dd = np.concatenate([tiles[d], np.zeros((len(miss), r, c), tiles.dtype)])
        pad = Tc - len(tt)
        if pad:
            tt = np.concatenate([tt, np.full(pad, b_buf - 1, np.int64)])
            rr = np.concatenate([rr, np.zeros(pad, np.int32)])
            dd = np.concatenate([dd, np.zeros((pad, r, c), tiles.dtype)])
        o = np.argsort(tt, kind="stable")
        tiles_c[d] = dd[o]
        trow_c[d] = rr[o]
        tcol_c[d] = tt[o].astype(np.int32)

    return GATMeshPack(
        tiles_r=tiles, trow_r=trow.astype(np.int32), tcol_r=tcol.astype(np.int32),
        tiles_c=tiles_c, trow_c=trow_c, tcol_c=tcol_c,
        res_row=hsg.res_row, res_col=hsg.res_col, res_val=hsg.res_val,
        n_dev=n_dev, n_local=hsg.n_local,
        n_real_nodes=hsg.n_real_nodes, n_real_edges=hsg.n_real_edges,
        has_res=bool((np.asarray(hsg.res_val) != 0).any()),
        send_idx=hsg.send_idx, halo_size=hsg.halo_size,
        node_perm=hsg.node_perm, tile_dtype=hsg.tile_dtype,
    )


def _dtype_name(tile_dtype) -> str:
    return {torch.float32: "float32", torch.bfloat16: "bfloat16",
            torch.int8: "int8"}[torch_dtype(tile_dtype)]


def partition_graph_hybrid(
    csr: HostCSR,
    n_dev: int,
    node_pad: int = 8,
    tile_r: int = 128,
    tile_c: int = 0,
    tile_dtype="float32",
    tile_budget_bytes: int = 3 * 1024 * 1024 * 1024,
    min_tile_nnz: int | None = None,
    boundary: bool = False,
    adaptive: bool = False,
    balance: bool = True,
    boundary_fallback: bool = False,
) -> HybridShardedGraph:
    """Tile-slab row-block partition.

    The global symmetric edge split (``data.graph.split_dense_tiles``) is
    packed once (``ops.cuda_bcsr.build_bcsr``), then cut into per-rank slabs
    at tile-row-block boundaries; zero tiles at the slab's last tile-row pad
    every rank to the same count. The residual COO is sliced per dest rank.
    ``balance=True`` permutes whole tile_c node blocks when the natural
    order concentrates tiles on few ranks (``node_perm``). ``boundary=True``
    builds the boundary exchange of remote blocks and rows. int8
    ``tile_dtype`` keeps the 0/k pattern and ``sym_scale`` = d, with
    residual values the edge multiplicity."""
    from parallel_gcn_tpu_torch.data.graph import split_dense_tiles, sym_scale_for
    from parallel_gcn_tpu_torch.ops.cuda_bcsr import build_bcsr

    if adaptive:
        raise _not_ported("the adaptive (push/pull) halo")
    dtype_name = _dtype_name(tile_dtype)
    tdtype = torch_dtype(dtype_name)
    tile_c = tile_c or tile_r
    if tile_c % tile_r:
        raise ValueError(f"tile_c {tile_c} must be a multiple of tile_r {tile_r}")
    # rows per rank: a whole number of tile_c blocks that honours node_pad
    n_local = pad_to_multiple(-(-csr.n_rows // n_dev), math.lcm(node_pad, tile_c))
    n_pad = n_local * n_dev

    rows = csr.row_ids()
    cols = csr.indices
    vals = csr.values
    sym_scale = None
    if tdtype == torch.int8:
        sym_scale = sym_scale_for(csr, rows, cols, vals, n_pad)
    in_tiles = split_dense_tiles(
        rows, cols, n_pad, min_tile_nnz, tile_budget_bytes,
        tile=tile_r, bytes_per_elem=tdtype.itemsize, tile_c=tile_c,
    )
    pack = build_bcsr(
        rows[in_tiles], cols[in_tiles], vals[in_tiles], n_pad,
        dtype=tdtype, tile=tile_r, tile_c=tile_c, sym_scale=sym_scale,
    )
    g_trow = pack.tile_rows.numpy()
    g_tcol = pack.tile_cols.numpy()
    g_tiles = (pack.tiles.float() if tdtype == torch.bfloat16 else pack.tiles).numpy()
    del pack
    r_rows = rows[~in_tiles].astype(np.int64)
    r_cols = cols[~in_tiles].astype(np.int64)
    r_vals = vals[~in_tiles]
    if sym_scale is not None:
        # residual values become the edge multiplicity k (k·d_i·d_j == v): the
        # residual rides the same d-scaled features as the slabs
        d = np.asarray(sym_scale, np.float64)
        r_vals = np.where(
            r_vals != 0,
            np.rint(r_vals / np.maximum(d[r_rows] * d[r_cols], 1e-30)),
            0.0,
        ).astype(np.float32)

    node_perm = None
    rpt = tile_c // tile_r  # tile-rows per node block
    if balance and n_dev > 1:
        block_perm = _balance_block_perm(
            g_trow, n_pad // tile_c, n_local // tile_c, n_dev, rpt
        )
        if block_perm is not None:
            inv = np.empty_like(block_perm)
            inv[block_perm] = np.arange(len(block_perm))
            g_trow = (inv[g_trow // rpt] * rpt + g_trow % rpt).astype(np.int32)
            g_tcol = inv[g_tcol].astype(np.int32)
            o = np.argsort(g_trow, kind="stable")
            g_trow, g_tcol, g_tiles = g_trow[o], g_tcol[o], g_tiles[o]
            remap = lambda g: inv[g // tile_c] * tile_c + g % tile_c  # noqa: E731
            r_rows, r_cols = remap(r_rows), remap(r_cols)
            o = np.argsort(r_rows, kind="stable")
            r_rows, r_cols, r_vals = r_rows[o], r_cols[o], r_vals[o]
            node_perm = (block_perm[:, None] * tile_c + np.arange(tile_c)).reshape(-1)
            if sym_scale is not None:
                sym_scale = np.asarray(sym_scale)[node_perm]

    rows_per_dev = n_local // tile_r
    dev_of_tile = g_trow // rows_per_dev
    counts = np.bincount(dev_of_tile, minlength=n_dev)
    T = int(counts.max())
    mean_t = max(counts.mean(), 1.0)
    if T > 1.5 * mean_t:
        warnings.warn(
            f"hybrid partition tile imbalance: max {T} vs mean {mean_t:.0f} "
            f"tiles/rank — all ranks pad to {T}."
            + ("" if balance else " Set balance=True to spread hot blocks."),
            stacklevel=2,
        )
    tiles = np.zeros((n_dev, T, tile_r, tile_c), dtype=g_tiles.dtype)
    trow = np.full((n_dev, T), rows_per_dev - 1, dtype=np.int32)
    tcol = np.zeros((n_dev, T), dtype=np.int32)
    for d in range(n_dev):
        sel = dev_of_tile == d
        k = int(sel.sum())
        tiles[d, :k] = g_tiles[sel]
        trow[d, :k] = g_trow[sel] - d * rows_per_dev  # ascending; pads keep order
        tcol[d, :k] = g_tcol[sel]

    res_row, res_col, res_val = _slice_coo_by_dest(
        r_rows, r_cols, r_vals, n_dev, n_local, n_pad
    )

    send_idx, halo = None, 0
    if boundary:
        tcol0, res_col0 = tcol.copy(), res_col.copy()
        send_idx, halo = _hybrid_boundary(
            tiles, trow, tcol, res_col, res_val, n_dev, n_local, tile_c
        )
        if not _boundary_pays_off(n_local, n_dev, halo, n_pad, "hybrid-boundary",
                                  boundary_fallback) and boundary_fallback:
            # _hybrid_boundary rewrote tcol/res_col in place: restore the
            # global layout (= the all_gather halo)
            tcol, res_col = tcol0, res_col0
            send_idx, halo = None, 0

    return HybridShardedGraph(
        tiles=tiles, trow=trow, tcol=tcol,
        res_row=res_row, res_col=res_col, res_val=res_val,
        n_dev=n_dev, n_local=n_local,
        n_real_nodes=csr.n_rows, n_real_edges=csr.nnz,
        sym_scale=None if sym_scale is None else
        np.asarray(sym_scale)[:n_pad].reshape(n_dev, n_local),
        send_idx=send_idx, halo_size=halo, node_perm=node_perm,
        tile_dtype=dtype_name,
    )
