"""Graph containers: numpy host CSR and the torch device ``Graph``.

Port of ``parallel_gcn_tpu/data/graph.py``. The host half (CSR building,
normalization, duplicate coalescing, the tile/residual edge split, the d
factor of int8 packs, the random test graph) is numpy and produces the same
arrays as the JAX package. ``build_graph`` writes torch tensors on the given
device.

The device layout is a row-sorted, padded COO (row/col/val padded to a fixed
edge count) plus an optional dense Â for small graphs and an optional BCSR
tile pack. The normalization matches the reference: degrees include the
implicit self-loop (src/parser.cpp:29-31) and
``val(src,dst) = 1/sqrt(deg(src)*deg(dst))`` (src/parser.cpp:164-181).
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from parallel_gcn_tpu_torch.device import torch_dtype


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


@dataclass(frozen=True)
class Graph:
    """Device-side graph for ``ops.graphsum``.

    row/col/val are COO triplets sorted by ``row``; padding entries carry
    ``val == 0`` and point at the last padded node. ``adj`` is the optional
    dense normalized adjacency. Â is symmetric, so the backward of the
    aggregation reuses the same operator (src/module.cu:188-208).
    """

    row: torch.Tensor  # int64 [n_edges_pad] (hybrid: COO residual only)
    col: torch.Tensor  # int64 [n_edges_pad]
    val: torch.Tensor  # float32 [n_edges_pad]
    adj: torch.Tensor | None  # [n_nodes, n_nodes] or None
    bcsr: "object | None"  # ops.cuda_bcsr.BCSR tile pack or None
    n_nodes: int  # padded
    n_real_nodes: int
    n_real_edges: int
    # True when bcsr holds only the dense tiles and row/col/val the residual
    is_hybrid: bool = False
    # False when row/col/val do NOT contain the whole edge set
    coo_complete: bool = True
    # sqrt(deg), self-loop-inclusive, [n_nodes] f32, 1.0 on padding rows
    sqrt_deg: torch.Tensor | None = None
    # adj_dtype=int8: d (= deg^{-1/2}, [n_nodes] f32) with adj_ij = adj8_ij·d_i·d_j
    adj_scale: torch.Tensor | None = None
    # ``ops.cuda_segment.Segments`` of row and of col over the nodes: the
    # ordered sums by destination and (the segment GAT's gradients) by source
    row_seg: "object | None" = None
    col_seg: "object | None" = None

    @property
    def n_edges_pad(self) -> int:
        return self.row.shape[0]


@dataclass(frozen=True)
class HostCSR:
    """Host-side CSR with values (reference: include/sparse.cuh:11-29)."""

    indptr: np.ndarray  # int32/int64 [n_rows+1]
    indices: np.ndarray  # int32 [nnz]
    values: np.ndarray  # float32 [nnz]
    n_rows: int
    n_cols: int
    # d = deg^{-1/2} with duplicate-inclusive degrees ([n_rows] f32), the
    # exact factor of v_ij = k_ij·d_i·d_j; None for feature CSRs and
    # hand-built fixtures (int8 packs then use recover_sym_scale)
    sym_scale: np.ndarray | None = None

    @property
    def nnz(self) -> int:
        return int(self.indices.shape[0])

    def row_ids(self) -> np.ndarray:
        """Expand indptr to a per-nnz row-id array (COO rows)."""
        return np.repeat(
            np.arange(self.n_rows, dtype=np.int32),
            np.diff(self.indptr).astype(np.int64),
        )

    def to_dense(self) -> np.ndarray:
        out = np.zeros((self.n_rows, self.n_cols), dtype=np.float32)
        out[self.row_ids(), self.indices] = self.values
        return out


def normalized_adjacency_values(indptr: np.ndarray, indices: np.ndarray) -> np.ndarray:
    """Â edge weights 1/sqrt(deg(src)·deg(dst)), degrees self-loop-inclusive,
    in float32 (reference src/parser.cpp:164-181)."""
    deg = np.diff(indptr).astype(np.float32)
    src_deg = np.repeat(deg, np.diff(indptr).astype(np.int64))
    dst_deg = deg[indices]
    return (1.0 / np.sqrt(src_deg * dst_deg)).astype(np.float32)


def coalesce_duplicate_edges(csr: HostCSR) -> HostCSR:
    """Merge duplicate (row, col) entries, SUMMING their values, so every
    backend applies the reference's operator (which counts each listed copy,
    src/parser.cpp:35-44). Within-row entries come out col-sorted. Returns
    the same object when the CSR has no duplicates."""
    rows = csr.row_ids().astype(np.int64)
    key = rows * csr.n_cols + csr.indices
    uniq, inv = np.unique(key, return_inverse=True)
    if len(uniq) == len(key):
        return csr
    values = np.zeros(len(uniq), np.float32)
    np.add.at(values, inv, csr.values)
    new_rows = (uniq // csr.n_cols).astype(np.int64)
    indptr = np.zeros(csr.n_rows + 1, dtype=np.int64)
    np.cumsum(np.bincount(new_rows, minlength=csr.n_rows), out=indptr[1:])
    return HostCSR(
        indptr=indptr,
        indices=(uniq % csr.n_cols).astype(np.int32),
        values=values,
        n_rows=csr.n_rows,
        n_cols=csr.n_cols,
        sym_scale=csr.sym_scale,
    )


def add_self_loops_csr(neighbor_lists: list[np.ndarray]) -> HostCSR:
    """Graph CSR with the implicit self-loop as first neighbor of every row
    (src/parser.cpp:29-31), duplicate entries then coalesced; carries the
    duplicate-inclusive d = deg^{-1/2} for exact int8 packs."""
    n = len(neighbor_lists)
    counts = np.fromiter((1 + len(nb) for nb in neighbor_lists), dtype=np.int64, count=n)
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    indices = np.empty(indptr[-1], dtype=np.int32)
    for i, nb in enumerate(neighbor_lists):
        start = indptr[i]
        indices[start] = i
        if len(nb):
            indices[start + 1 : indptr[i + 1]] = nb
    values = normalized_adjacency_values(indptr, indices)
    sym = (1.0 / np.sqrt(counts.astype(np.float64))).astype(np.float32)
    return coalesce_duplicate_edges(
        HostCSR(indptr=indptr, indices=indices, values=values, n_rows=n,
                n_cols=n, sym_scale=sym)
    )


def split_dense_tiles(
    rows: np.ndarray,
    cols: np.ndarray,
    n_pad: int,
    min_tile_nnz: int | None = None,
    tile_budget_bytes: int = 3 * 1024 * 1024 * 1024,
    tile: int = 128,
    bytes_per_elem: int = 4,
    tile_c: int | None = None,
) -> np.ndarray:
    """Boolean mask of edges living in "dense-enough" tile_r×tile_c blocks.

    A tile qualifies when its nnz ≥ threshold, the threshold being the
    smallest value ≥ ``min_tile_nnz`` whose qualified tiles fit the byte
    budget. An edge enters the tile part only if BOTH its tile and its
    mirror edge's tile qualify, which keeps the tile-part matrix symmetric
    for any tile geometry (the backward-equals-forward shortcut needs it).
    The default ``min_tile_nnz`` is the JAX package's break-even rule, kept
    so both packages pack the same tiles.
    """
    tile_r = tile
    tile_c = tile_c or tile_r
    ntc = n_pad // tile_c
    r64 = rows.astype(np.int64)
    c64 = cols.astype(np.int64)
    tid = (r64 // tile_r) * ntc + c64 // tile_c
    uniq, inverse = np.unique(tid, return_inverse=True)
    counts = np.bincount(inverse)

    tile_bytes = tile_r * tile_c * bytes_per_elem
    if min_tile_nnz is None:
        min_tile_nnz = max(8, tile_bytes // 12288)
    thresh = min_tile_nnz
    max_tiles = max(tile_budget_bytes // tile_bytes, 1)
    cs = np.sort(counts)[::-1]
    if (cs >= thresh).sum() > max_tiles:
        thresh = int(cs[max_tiles - 1]) + 1

    qualified = counts >= thresh
    mask = qualified[inverse]
    if tile_r != tile_c:
        qual_tids = uniq[qualified]
        mirror_tid = (c64 // tile_r) * ntc + r64 // tile_c
        pos = np.searchsorted(qual_tids, mirror_tid)
        pos = np.clip(pos, 0, max(len(qual_tids) - 1, 0))
        mirror_ok = (
            (qual_tids[pos] == mirror_tid) if len(qual_tids) else
            np.zeros(len(mirror_tid), dtype=bool)
        )
        mask = mask & mirror_ok
    return mask


def recover_sym_scale(
    rows: np.ndarray, cols: np.ndarray, vals: np.ndarray, n_rows: int, n_pad: int
) -> np.ndarray:
    """Recover d (= deg^{-1/2}) with v_ij = k_ij·d_i·d_j from the self-loop
    values (v_ii = d_i² under k_ii = 1) and verify every edge factors with
    an integer k ≥ 1. Raises ValueError otherwise."""
    selfloops = rows == cols
    d = np.zeros(n_pad, dtype=np.float64)
    d[rows[selfloops]] = np.sqrt(vals[selfloops].astype(np.float64))
    if not (d[:n_rows] > 0).all():
        raise ValueError(
            "tile_dtype=int8 needs a self-loop on every node to recover d"
        )
    unit = d[rows] * d[cols]
    k = np.rint(vals / np.maximum(unit, 1e-30))
    if not ((k >= 1).all() and np.allclose(vals, k * unit, rtol=1e-4,
                                           atol=1e-7)):
        raise ValueError(
            "tile_dtype=int8 requires values of the form k/sqrt(deg·deg) "
            "(symmetric normalization, integer edge multiplicity); got "
            "values that do not factor (load through the parser so "
            "HostCSR.sym_scale carries the exact degrees)"
        )
    return d.astype(np.float32)


def sym_scale_for(
    csr: HostCSR, rows: np.ndarray, cols: np.ndarray, vals: np.ndarray,
    n_pad: int,
) -> np.ndarray:
    """Padded d with v_ij = k_ij·d_i·d_j (integer k in [1, 127]) for int8
    pattern packs: from ``csr.sym_scale`` when present, else recovered from
    the self-loop values; verified against every edge value either way."""
    if csr.sym_scale is None:
        return recover_sym_scale(rows, cols, vals, csr.n_rows, n_pad)
    d = np.zeros(n_pad, dtype=np.float32)
    d[: csr.n_rows] = csr.sym_scale
    unit = d[rows].astype(np.float64) * d[cols]
    k = np.rint(vals / np.maximum(unit, 1e-30))
    if not ((k >= 1).all() and (k <= 127).all()
            and np.allclose(vals, k * unit, rtol=1e-4, atol=1e-7)):
        raise ValueError(
            "HostCSR.sym_scale does not factor the edge values as "
            "k·d_i·d_j with int8 multiplicities — refusing an inexact "
            "int8 pattern pack"
        )
    return d


def build_graph(
    csr: HostCSR,
    *,
    device: torch.device,
    node_pad: int = 8,
    edge_pad: int = 512,
    dense: bool = False,
    bcsr: bool = False,
    hybrid: bool = False,
    n_nodes_pad: int | None = None,
    min_tile_nnz: int | None = None,
    tile_budget_bytes: int = 3 * 1024 * 1024 * 1024,
    tile_dtype="float32",
    tile_size: int = 128,
    tile_cols: int = 0,
    adj_dtype="float32",
    times: dict | None = None,
) -> Graph:
    """Pad a host CSR into the static-shaped device Graph on ``device``.

    Padding edges get val=0 and row=col=n_nodes_pad-1. ``bcsr=True`` packs
    all of Â into tiles; ``hybrid=True`` packs only the dense-enough tiles
    (``split_dense_tiles``) and keeps the other edges as the COO residual.
    ``times``, when given, receives the seconds of the host pack
    (``pack_s``) and of the copy to the device with the segments
    (``copy_s``).
    """
    t0 = time.perf_counter()
    from parallel_gcn_tpu_torch.ops.cuda_bcsr import build_bcsr
    from parallel_gcn_tpu_torch.ops.cuda_segment import segments

    tile_dtype = torch_dtype(tile_dtype)
    adj_dtype = torch_dtype(adj_dtype)
    tile_cols = tile_cols or tile_size
    if bcsr or hybrid:
        node_pad = max(node_pad, tile_cols)
    n_pad = n_nodes_pad or pad_to_multiple(max(csr.n_rows, 1), node_pad)

    all_rows = csr.row_ids()
    rows_np = all_rows
    cols_np = csr.indices
    vals_np = csr.values

    sym_scale = None
    if tile_dtype == torch.int8:
        sym_scale = sym_scale_for(csr, rows_np, cols_np, vals_np, n_pad)

    coo_complete = True
    bcsr_pack = None
    if hybrid:
        coo_complete = False
        in_tiles = split_dense_tiles(
            rows_np, cols_np, n_pad, min_tile_nnz, tile_budget_bytes,
            tile=tile_size, bytes_per_elem=tile_dtype.itemsize,
            tile_c=tile_cols,
        )
        bcsr_pack = build_bcsr(
            rows_np[in_tiles], cols_np[in_tiles], vals_np[in_tiles], n_pad,
            dtype=tile_dtype, tile=tile_size, tile_c=tile_cols,
            sym_scale=sym_scale,
        )
        rows_np = rows_np[~in_tiles]
        cols_np = cols_np[~in_tiles]
        vals_np = vals_np[~in_tiles]
        if len(rows_np) == 0:
            # every edge landed in a tile: the graph is pure BCSR
            hybrid = False

    nnz = len(rows_np)
    e_pad = pad_to_multiple(max(nnz, 1), edge_pad)
    row = np.full(e_pad, n_pad - 1, dtype=np.int64)
    col = np.full(e_pad, n_pad - 1, dtype=np.int64)
    val = np.zeros(e_pad, dtype=np.float32)
    row[:nnz] = rows_np
    col[:nnz] = cols_np
    val[:nnz] = vals_np

    adj = None
    adj_scale = None
    if dense:
        if adj_dtype == torch.int8:
            # Â = D·A₈·D with the integer multiplicity matrix A₈ (exact)
            d = (sym_scale if sym_scale is not None else
                 sym_scale_for(csr, all_rows, csr.indices, csr.values, n_pad))
            unit = d[all_rows].astype(np.float64) * d[csr.indices]
            k = np.rint(csr.values / np.maximum(unit, 1e-30))
            if not ((1 <= k).all() and (k <= 127).all()):
                raise ValueError("edge multiplicity outside the int8 range")
            adj_np = np.zeros((n_pad, n_pad), dtype=np.int8)
            adj_np[all_rows, csr.indices] = k.astype(np.int8)
            adj_scale = torch.from_numpy(d.astype(np.float32)).to(device)
            adj = torch.from_numpy(adj_np).to(device)
        else:
            adj_np = np.zeros((n_pad, n_pad), dtype=np.float32)
            adj_np[all_rows, csr.indices] = csr.values
            adj = torch.from_numpy(adj_np).to(adj_dtype).to(device)

    if bcsr:
        bcsr_pack = build_bcsr(
            all_rows, csr.indices, csr.values, n_pad,
            dtype=tile_dtype, tile=tile_size, tile_c=tile_cols,
            sym_scale=sym_scale,
        )

    sqrt_deg_np = np.ones(n_pad, dtype=np.float32)
    sqrt_deg_np[: csr.n_rows] = np.sqrt(
        np.diff(csr.indptr).astype(np.float32)
    )

    t1 = time.perf_counter()
    row_t = torch.from_numpy(row).to(device)
    col_t = torch.from_numpy(col).to(device)
    val_t = torch.from_numpy(val).to(device)
    graph = Graph(
        row=row_t,
        col=col_t,
        val=val_t,
        adj=adj,
        bcsr=None if bcsr_pack is None else bcsr_pack.to(device),
        n_nodes=n_pad,
        n_real_nodes=csr.n_rows,
        n_real_edges=csr.nnz,
        is_hybrid=hybrid,
        coo_complete=coo_complete,
        sqrt_deg=torch.from_numpy(sqrt_deg_np).to(device),
        adj_scale=adj_scale,
        row_seg=segments(row_t, n_pad, col_t, val_t),
        col_seg=segments(col_t, n_pad),
    )
    if times is not None:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        times.update(pack_s=t1 - t0, copy_s=time.perf_counter() - t1)
    return graph


def random_graph(
    n_nodes: int, avg_degree: int, seed: int = 0
) -> tuple[HostCSR, list[np.ndarray]]:
    """Synthetic undirected graph fixture for tests."""
    rng = np.random.default_rng(seed)
    half: dict[int, set[int]] = {i: set() for i in range(n_nodes)}
    n_edges = n_nodes * avg_degree // 2
    src = rng.integers(0, n_nodes, size=n_edges)
    dst = rng.integers(0, n_nodes, size=n_edges)
    for s, d in zip(src, dst):
        if s == d:
            continue
        half[int(s)].add(int(d))
        half[int(d)].add(int(s))
    neighbor_lists = [np.array(sorted(half[i]), dtype=np.int32) for i in range(n_nodes)]
    return add_self_loops_csr(neighbor_lists), neighbor_lists
