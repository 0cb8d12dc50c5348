"""Graph partitioning for node-partitioned training over several GPUs.

Numpy copy of ``parallel_gcn_tpu/parallel/partition.py`` (the port imports
nothing of the JAX package): contiguous row blocks of the CSR per rank, the
rank's edges (all edges whose destination row it owns) kept local, and the
remote source features fetched by a collective during aggregation
(``parallel.train_parallel``). Every rank gets arrays of the same shape,
padded to the largest rank's, and the arrays equal the JAX package's array
for array (``tests/test_torch_partition.py``).

Layouts: the flat COO partition with the all_gather, boundary or adaptive
push/pull halo (``partition_graph``), the ring of the ``ppermute`` rotation
(``partition_graph_ring``), the tile-slab partition
(``partition_graph_hybrid``, with slab balancing, int8 pattern slabs and
the adaptive halo) and the mesh GAT's rect packs (``gat_mesh_pack``).
"""

from __future__ import annotations

import math
import warnings
from dataclasses import dataclass

import numpy as np
import torch

from parallel_gcn_tpu_torch.data.graph import HostCSR, pad_to_multiple
from parallel_gcn_tpu_torch.device import torch_dtype


@dataclass(frozen=True)
class ShardedGraph:
    """Per-rank COO slabs, stacked on a leading rank axis.

    ``row_local[d, e]`` is the destination row within rank d's shard (rows
    [d·n_local, (d+1)·n_local) of the padded graph); ``col[d, e]`` is the
    global source node id (all_gather halo) or, with ``send_idx`` (boundary
    halo), the row of the compact ``[x_local ; received halo rows]`` buffer.
    ``send_idx[d]`` lists, in ``n_dev`` chunks of ``halo_size``, the local
    rows rank d sends to each peer. Padding entries carry val 0 and
    in-bounds indices.

    Ring layout (``ring``, ``partition_graph_ring``): the arrays are
    [n_dev, n_dev, e_slab]; slab s of rank d holds the edges whose source
    lies in the block of rank (d − s) mod n_dev, the block d holds after s
    rotations, with ``col`` the source's row within that block.

    Adaptive halo (``push_*``, ``partition_graph(adaptive=True)``): each
    off-diagonal rank pair moves its edges in the direction that ships
    fewer rows. Pull pairs stay in row_local/col/val against the boundary
    buffer; push pairs live on the SOURCE rank: ``push_col`` its local
    source row, ``push_row`` the slot d·push_slab + k of the partial-sum
    slab for destination rank d (slot-sorted), and the receiver adds slot k
    of the slab from rank s at local row ``push_recv[s·push_slab + k]``
    (n_local: an unused slot)."""

    row_local: np.ndarray  # int32 [n_dev, e_local] | [n_dev, n_dev, e_slab]
    col: np.ndarray  # int32, as row_local
    val: np.ndarray  # float32, as row_local
    n_dev: int
    n_local: int  # rows per rank
    n_real_nodes: int
    n_real_edges: int
    ring: bool = False
    send_idx: np.ndarray | None = None  # int32 [n_dev, n_dev*halo_size]
    halo_size: int = 0  # rows per (src-rank, dst-rank) exchange slab
    push_row: np.ndarray | None = None  # int32 [n_dev, e_push]
    push_col: np.ndarray | None = None  # int32 [n_dev, e_push]
    push_val: np.ndarray | None = None  # float32 [n_dev, e_push]
    push_recv: np.ndarray | None = None  # int32 [n_dev, n_dev*push_slab]
    push_slab: int = 0

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


def _adaptive_pair_modes(rows, cols, n_dev, n_local):
    """Push or pull per off-diagonal (source rank s, destination rank d)
    pair: pull ships the pair's unique source rows, push its unique
    destination rows (partial sums); push where strictly fewer. The
    all_to_all pads every pair to its category's largest, so the split is
    kept only when max(pull pairs) + max(push pairs) beats the pure-pull
    max. Returns ``mode_push`` [n_dev, n_dev]."""
    n_pad = n_dev * n_local
    dev_r = rows // n_local
    dev_c = cols // n_local
    off = dev_r != dev_c
    pair = (dev_c[off] * n_dev + dev_r[off]).astype(np.int64)
    pull_cnt = np.bincount(
        np.unique(pair * n_pad + cols[off]) // n_pad, minlength=n_dev * n_dev
    )
    push_cnt = np.bincount(
        np.unique(pair * n_pad + rows[off]) // n_pad, minlength=n_dev * n_dev
    )
    mode_push = (push_cnt < pull_cnt) & (push_cnt > 0)
    mixed = (
        int(pull_cnt[~mode_push].max(initial=0))
        + int(push_cnt[mode_push].max(initial=0))
    )
    if mixed >= int(pull_cnt.max(initial=0)):
        mode_push[:] = False
    return mode_push.reshape(n_dev, n_dev)


def _build_push_slabs(rows, cols, vals, n_dev, n_local):
    """The push edges' per-source-rank slabs, sorted by (source rank,
    destination rank, destination row) so ``push_row`` ascends on each rank.
    Returns (push_row, push_col, push_val, push_recv, push_slab)."""
    n_pad = n_dev * n_local
    dev_r = (rows // n_local).astype(np.int64)
    dev_c = (cols // n_local).astype(np.int64)
    pair = dev_c * n_dev + dev_r
    key = pair * n_pad + rows
    uniq, inv = np.unique(key, return_inverse=True)
    upair = uniq // n_pad
    pair_start = np.searchsorted(upair, np.arange(n_dev * n_dev))
    slot = np.arange(len(uniq)) - pair_start[upair]
    per_pair = np.bincount(upair, minlength=n_dev * n_dev)
    push_slab = pad_to_multiple(max(int(per_pair.max()), 1), 8)

    order = np.argsort(key, kind="stable")
    src_dev = dev_c[order]
    e_cnt = np.bincount(src_dev, minlength=n_dev)
    e_push = pad_to_multiple(max(int(e_cnt.max()), 1), 128)
    starts = np.zeros(n_dev, np.int64)
    np.cumsum(e_cnt[:-1], out=starts[1:])
    pos = np.arange(len(order)) - starts[src_dev]

    # padding: val 0 into the last slot, so push_row stays ascending
    push_row = np.full((n_dev, e_push), n_dev * push_slab - 1, np.int32)
    push_col = np.zeros((n_dev, e_push), np.int32)
    push_val = np.zeros((n_dev, e_push), np.float32)
    push_row[src_dev, pos] = (
        dev_r[order] * push_slab + slot[inv[order]]
    ).astype(np.int32)
    push_col[src_dev, pos] = (cols[order] - src_dev * n_local).astype(np.int32)
    push_val[src_dev, pos] = vals[order]

    # slot k of the slab from rank s lands at push_recv[d, s*push_slab + k];
    # unused slots name the n_local dump row
    push_recv = np.full((n_dev, n_dev * push_slab), n_local, np.int32)
    s_u, d_u = upair // n_dev, upair % n_dev
    push_recv[d_u, s_u * push_slab + slot] = (
        uniq % n_pad - d_u * n_local
    ).astype(np.int32)
    return push_row, push_col, push_val, push_recv, int(push_slab)


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
    local+halo buffer and builds the all_to_all schedule; ``adaptive=True``
    (implies boundary) also moves each rank pair's edges to the push slabs
    where pushing partial sums ships fewer rows (the ``ShardedGraph``
    docstring). ``boundary_fallback=True`` returns the all_gather layout
    instead when the buffer would not be smaller (``_boundary_pays_off``);
    for the adaptive halo it rebuilds the plain partition from the CSR."""
    n_local = pad_to_multiple(-(-csr.n_rows // n_dev), node_pad)
    n_pad = n_local * n_dev

    rows = csr.row_ids().astype(np.int64)
    cols = csr.indices.astype(np.int64)
    vals = csr.values
    push = (None, None, None, None, 0)
    if adaptive:
        boundary = True
        mode_push = _adaptive_pair_modes(rows, cols, n_dev, n_local)
        is_push = mode_push[cols // n_local, rows // n_local]
        if is_push.any():
            push = _build_push_slabs(rows[is_push], cols[is_push], vals[is_push],
                                     n_dev, n_local)
            rows, cols, vals = rows[~is_push], cols[~is_push], vals[~is_push]
    row_local, col, val = _slice_coo_by_dest(rows, cols, vals, n_dev, n_local, n_pad)
    send_idx, halo = None, 0
    if boundary:
        col_b, send_idx, halo = _remap_cols_boundary(col, val, n_dev, n_local)
        if _boundary_pays_off(n_local, n_dev, halo, n_pad,
                              "adaptive" if adaptive else "boundary", boundary_fallback):
            col = col_b
        elif boundary_fallback:
            if adaptive:
                # the push split already took edges out of rows/cols/vals
                return partition_graph(csr, n_dev, node_pad=node_pad)
            send_idx, halo = None, 0
        else:
            col = col_b
    return ShardedGraph(
        row_local=row_local, col=col, val=val, n_dev=n_dev, n_local=n_local,
        n_real_nodes=csr.n_rows, n_real_edges=csr.nnz,
        send_idx=send_idx, halo_size=halo,
        push_row=push[0], push_col=push[1], push_val=push[2], push_recv=push[3],
        push_slab=push[4],
    )


def partition_graph_ring(csr: HostCSR, n_dev: int, node_pad: int = 8) -> ShardedGraph:
    """The ring layout of the ``ppermute`` rotation: each rank's edges
    bucketed by source block in ring order (slab s: sources of rank
    (d − s) mod n_dev), row-sorted within a slab, padded to the largest
    (rank, step) count rounded to 128 (padding: row n_local − 1, col 0,
    val 0, last)."""
    n_local = pad_to_multiple(-(-csr.n_rows // n_dev), node_pad)
    rows = csr.row_ids().astype(np.int64)
    cols = csr.indices.astype(np.int64)
    vals = csr.values
    d = rows // n_local
    b = cols // n_local
    s = (d - b) % n_dev

    order = np.lexsort((rows, s, d))
    group = (d[order] * n_dev + s[order]).astype(np.int64)
    counts = np.bincount(group, minlength=n_dev * n_dev)
    e_slab = pad_to_multiple(max(int(counts.max()), 1), 128)
    starts = np.zeros(n_dev * n_dev, dtype=np.int64)
    np.cumsum(counts[:-1], out=starts[1:])
    pos = np.arange(len(order), dtype=np.int64) - starts[group]

    row_s = np.full((n_dev * n_dev, e_slab), n_local - 1, dtype=np.int32)
    col_s = np.zeros((n_dev * n_dev, e_slab), dtype=np.int32)
    val_s = np.zeros((n_dev * n_dev, e_slab), dtype=np.float32)
    row_s[group, pos] = (rows[order] - d[order] * n_local).astype(np.int32)
    col_s[group, pos] = (cols[order] % n_local).astype(np.int32)
    val_s[group, pos] = vals[order]
    shape = (n_dev, n_dev, e_slab)
    return ShardedGraph(
        row_local=row_s.reshape(shape), col=col_s.reshape(shape),
        val=val_s.reshape(shape), n_dev=n_dev, n_local=n_local,
        n_real_nodes=csr.n_rows, n_real_edges=csr.nnz, ring=True,
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
    # adaptive halo (partition_graph_hybrid(adaptive=True)): the push pairs'
    # tiles and residual edges live on the SOURCE rank. The push tiles are a
    # rect pack over LOCAL column blocks with a compact output row space
    # (ptrow: compact block ids, ascending, every block covered); pt_dst
    # maps each compact row to its slot of the all_to_all slab (≥
    # n_dev·push_slab: padding, dropped). The push residual sums straight
    # into slab slots (prow, slot-sorted; n_dev·push_slab: padding). The
    # receiver adds the exchanged rows at push_recv (n_local: unused).
    ptiles: np.ndarray | None = None  # [n_dev, Tp, tile_r, tile_c]
    ptrow: np.ndarray | None = None  # int32 [n_dev, Tp] compact block ids
    ptcol: np.ndarray | None = None  # int32 [n_dev, Tp] LOCAL col blocks
    pt_dst: np.ndarray | None = None  # int32 [n_dev, Bp·tile_r] slab slots
    prow: np.ndarray | None = None  # int32 [n_dev, e_push] slab slots
    pcol: np.ndarray | None = None  # int32 [n_dev, e_push] local source rows
    pval: np.ndarray | None = None  # float32 [n_dev, e_push]
    push_recv: np.ndarray | None = None  # int32 [n_dev, n_dev·push_slab]
    push_slab: int = 0

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


def _hybrid_adaptive_split(g_trow, g_tcol, g_tiles, r_rows, r_cols, r_vals,
                           n_dev, n_local, tile_r, tile_c):
    """Push or pull per off-diagonal (source rank s, destination rank d)
    pair of a tile partition: pull ships the source column blocks the
    pair's tiles touch (tile_c rows each) plus its residual source rows
    outside them; push one partial row per destination row (tile_r per
    touched tile-row block, plus residual destination rows outside them).
    Pairs where push is strictly cheaper move their tiles and residual
    edges to the source rank.

    Returns None when no pair pushes (or the mix does not beat pure pull),
    else (keep_tiles, keep_res, (ptiles, ptrow, ptcol, pt_dst),
    (prow, pcol, pval), push_recv, push_slab), padded to equal shapes."""
    rows_per_dev = n_local // tile_r
    Bl = n_local // tile_c
    nz = g_tiles.reshape(g_tiles.shape[0], -1).any(axis=1)
    t_dst = (g_trow // rows_per_dev).astype(np.int64)
    t_src = (g_tcol // Bl).astype(np.int64)
    live_r = r_vals != 0
    r_dst = (r_rows // n_local).astype(np.int64)
    r_src = (r_cols // n_local).astype(np.int64)

    pull = np.zeros((n_dev, n_dev), np.int64)
    push = np.zeros((n_dev, n_dev), np.int64)
    pair_tiles = {}
    pair_res = {}
    for s in range(n_dev):
        for d in range(n_dev):
            if s == d:
                continue
            tm = np.flatnonzero(nz & (t_dst == d) & (t_src == s))
            rm = np.flatnonzero(live_r & (r_dst == d) & (r_src == s))
            pair_tiles[s, d] = tm
            pair_res[s, d] = rm
            blk = np.unique(g_tcol[tm].astype(np.int64))
            rr = np.unique(r_cols[rm].astype(np.int64))
            rr = rr[~np.isin(rr // tile_c, blk)]
            pull[s, d] = tile_c * len(blk) + len(rr)
            rb = np.unique(g_trow[tm].astype(np.int64))
            rd = np.unique(r_rows[rm].astype(np.int64))
            rd = rd[~np.isin(rd // tile_r, rb)]
            push[s, d] = tile_r * len(rb) + len(rd)
    mode_push = (push < pull) & (push > 0)
    mixed = (
        int(pull[~mode_push].max(initial=0))
        + int(push[mode_push].max(initial=0))
    )
    if not mode_push.any() or mixed >= int(pull.max(initial=0)):
        return None

    # slot spaces, per pair: tile-row blocks first (tile_r rows each, shared
    # by the tiles and the residual edges inside them), then the residual's
    # other destination rows
    H = 1
    pair_blocks = {}
    pair_extra = {}
    for (s, d), tm in pair_tiles.items():
        if not mode_push[s, d]:
            continue
        rb = np.unique(g_trow[tm].astype(np.int64))
        rd = np.unique(r_rows[pair_res[s, d]].astype(np.int64))
        extra = rd[~np.isin(rd // tile_r, rb)]
        pair_blocks[s, d] = rb
        pair_extra[s, d] = extra
        H = max(H, tile_r * len(rb) + len(extra))
    H = pad_to_multiple(H, 8)

    keep_t = np.ones(len(g_trow), bool)
    keep_r = np.ones(len(r_rows), bool)
    push_recv = np.full((n_dev, n_dev * H), n_local, np.int32)
    dev_blocks = [[] for _ in range(n_dev)]  # (compact block id, tile index)
    dev_res = [[] for _ in range(n_dev)]  # (slot, local col, val)
    dev_nblocks = np.zeros(n_dev, np.int64)
    for s in range(n_dev):
        for d in range(n_dev):
            if (s, d) not in pair_blocks:
                continue
            tm, rm = pair_tiles[s, d], pair_res[s, d]
            keep_t[tm] = False
            keep_r[rm] = False
            rb, extra = pair_blocks[s, d], pair_extra[s, d]
            blk_pos = {int(b): i for i, b in enumerate(rb)}
            for i, b in enumerate(rb):
                rows_g = b * tile_r + np.arange(tile_r)
                push_recv[d, s * H + i * tile_r : s * H + (i + 1) * tile_r] = (
                    rows_g - d * n_local
                ).astype(np.int32)
            base_extra = tile_r * len(rb)
            push_recv[d, s * H + base_extra : s * H + base_extra + len(extra)] = (
                extra - d * n_local
            ).astype(np.int32)
            for tix in tm:
                b = int(g_trow[tix])
                dev_blocks[s].append((dev_nblocks[s] + blk_pos[b], int(tix)))
            rrow_pair = r_rows[rm].astype(np.int64)
            rcol_pair = r_cols[rm].astype(np.int64)
            rval_pair = r_vals[rm]
            in_blk = np.isin(rrow_pair // tile_r, rb)
            slot = np.empty(len(rrow_pair), np.int64)
            bp = np.searchsorted(rb, rrow_pair[in_blk] // tile_r)
            slot[in_blk] = bp * tile_r + rrow_pair[in_blk] % tile_r
            slot[~in_blk] = base_extra + np.searchsorted(extra, rrow_pair[~in_blk])
            dev_res[s].append((d * H + slot, rcol_pair - s * n_local, rval_pair))
            dev_nblocks[s] += len(rb)

    tile_shape = g_tiles.shape[1:]
    Bp = max(int(dev_nblocks.max()), 1)
    Tp = max([1] + [len(dev_blocks[s]) for s in range(n_dev)])
    ptiles = np.zeros((n_dev, Tp) + tile_shape, dtype=g_tiles.dtype)
    ptrow = np.full((n_dev, Tp), Bp - 1, np.int32)
    ptcol = np.zeros((n_dev, Tp), np.int32)
    pt_dst = np.full((n_dev, Bp * tile_r), n_dev * H, np.int32)  # padding: dropped
    e_push = max([1] + [sum(len(x[0]) for x in dev_res[s]) for s in range(n_dev)])
    e_push = pad_to_multiple(e_push, 128)
    prow = np.full((n_dev, e_push), n_dev * H, np.int32)  # padding: dropped
    pcol = np.zeros((n_dev, e_push), np.int32)
    pval = np.zeros((n_dev, e_push), np.float32)
    for s in range(n_dev):
        entries = sorted(dev_blocks[s], key=lambda x: x[0])
        for k, (cblk, tix) in enumerate(entries):
            ptiles[s, k] = g_tiles[tix]
            ptrow[s, k] = cblk
            ptcol[s, k] = int(g_tcol[tix]) - s * Bl
        base = 0
        for d in range(n_dev):
            if (s, d) not in pair_blocks:
                continue
            nb = len(pair_blocks[s, d])
            pt_dst[s, base * tile_r : (base + nb) * tile_r] = (
                d * H + np.arange(nb * tile_r)
            ).astype(np.int32)
            base += nb
        if dev_res[s]:
            slots = np.concatenate([x[0] for x in dev_res[s]])
            cols_l = np.concatenate([x[1] for x in dev_res[s]])
            vals_l = np.concatenate([x[2] for x in dev_res[s]])
            o = np.argsort(slots, kind="stable")
            k = len(slots)
            prow[s, :k] = slots[o].astype(np.int32)
            pcol[s, :k] = cols_l[o].astype(np.int32)
            pval[s, :k] = vals_l[o]

    # every compact block 0..Bp-1 gets a tile on every rank (zero tiles for
    # the blocks a rank does not use; pt_dst drops those rows)
    for s in range(n_dev):
        covered = set(ptrow[s, : len(dev_blocks[s])].tolist())
        missing = [b for b in range(Bp) if b not in covered]
        free = len(dev_blocks[s])
        need = len(missing)
        if need > Tp - free:
            pad_t = need - (Tp - free)
            ptiles = np.concatenate(
                [ptiles, np.zeros((n_dev, pad_t) + tile_shape, dtype=g_tiles.dtype)],
                axis=1)
            ptrow = np.concatenate([ptrow, np.full((n_dev, pad_t), Bp - 1, np.int32)],
                                   axis=1)
            ptcol = np.concatenate([ptcol, np.zeros((n_dev, pad_t), np.int32)], axis=1)
            Tp += pad_t
        ptrow[s, free : free + need] = np.asarray(missing, np.int32)
        o = np.argsort(ptrow[s], kind="stable")
        ptiles[s] = ptiles[s][o]
        ptrow[s] = ptrow[s][o]
        ptcol[s] = ptcol[s][o]

    return (keep_t, keep_r, (ptiles, ptrow, ptcol, pt_dst), (prow, pcol, pval),
            push_recv, int(H))


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
    if hsg.push_slab:
        raise ValueError("gat_mesh_pack needs a pull-only partition: the adaptive halo's "
                         "push pairs move a destination row's edges off its rank")
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
    builds the boundary exchange of remote blocks and rows;
    ``adaptive=True`` (implies boundary at more than one rank) moves each
    rank pair's tiles and residual edges to the push slabs where pushing
    partial sums ships fewer rows (``_hybrid_adaptive_split``). int8
    ``tile_dtype`` keeps the 0/k pattern and ``sym_scale`` = d, with
    residual values the edge multiplicity."""
    from parallel_gcn_tpu_torch.data.graph import split_dense_tiles, sym_scale_for
    from parallel_gcn_tpu_torch.ops.cuda_bcsr import build_bcsr

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

    push = None
    if adaptive and n_dev > 1:
        boundary = True
        split = _hybrid_adaptive_split(g_trow, g_tcol, g_tiles, r_rows, r_cols, r_vals,
                                       n_dev, n_local, tile_r, tile_c)
        if split is not None:
            keep_t, keep_r, push_pack, push_res, push_recv, push_slab = split
            g_trow, g_tcol, g_tiles = g_trow[keep_t], g_tcol[keep_t], g_tiles[keep_t]
            r_rows, r_cols, r_vals = r_rows[keep_r], r_cols[keep_r], r_vals[keep_r]
            # a tile-row whose tiles all moved to push gets a zero tile on its
            # owner's first block (no halo), so every tile-row stays covered
            missing = np.setdiff1d(np.arange(n_pad // tile_r, dtype=np.int64),
                                   np.unique(g_trow.astype(np.int64)))
            if len(missing):
                own_blk = (missing * tile_r) // n_local * (n_local // tile_c)
                g_trow = np.concatenate([g_trow, missing]).astype(np.int32)
                g_tcol = np.concatenate([g_tcol, own_blk]).astype(np.int32)
                g_tiles = np.concatenate(
                    [g_tiles, np.zeros((len(missing), tile_r, tile_c), g_tiles.dtype)])
                o = np.argsort(g_trow, kind="stable")
                g_trow, g_tcol, g_tiles = g_trow[o], g_tcol[o], g_tiles[o]
            push = (push_pack, push_res, push_recv, push_slab)

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
        # with push pairs the pull buffer is not the whole exchange: warn only
        fallback = boundary_fallback and push is None
        if not _boundary_pays_off(n_local, n_dev, halo, n_pad,
                                  "hybrid-boundary" if push is None else "hybrid-adaptive",
                                  fallback) and fallback:
            # _hybrid_boundary rewrote tcol/res_col in place: restore the
            # global layout (= the all_gather halo)
            tcol, res_col = tcol0, res_col0
            send_idx, halo = None, 0

    push_fields = {}
    if push is not None:
        (ptiles, ptrow, ptcol, pt_dst), (prow, pcol, pval), precv, pslab = push
        push_fields = dict(ptiles=ptiles, ptrow=ptrow, ptcol=ptcol, pt_dst=pt_dst,
                           prow=prow, pcol=pcol, pval=pval, push_recv=precv,
                           push_slab=pslab)
    return HybridShardedGraph(
        tiles=tiles, trow=trow, tcol=tcol,
        res_row=res_row, res_col=res_col, res_val=res_val,
        n_dev=n_dev, n_local=n_local,
        n_real_nodes=csr.n_rows, n_real_edges=csr.nnz,
        sym_scale=None if sym_scale is None else
        np.asarray(sym_scale)[:n_pad].reshape(n_dev, n_local),
        send_idx=send_idx, halo_size=halo, node_perm=node_perm,
        tile_dtype=dtype_name, **push_fields,
    )
