"""Node-partitioned training over ``torch.distributed``.

Port of ``parallel_gcn_tpu/parallel/train_parallel.py``. The graph's rows are
partitioned over the ranks of a ``torch.distributed`` world, one process per
rank, each on its own device (``cuda:<LOCAL_RANK>``, or the CPU when asked
for). A rank holds its rows of the features, labels and split and its own
slab of the graph (``RankGraph``), aggregates its rows' edges against a
source buffer filled by a collective (``parallel.collectives``: all_gather
of every row, the boundary all_to_all of only the referenced rows, the
ring's rotation of one block at a time, or the adaptive halo's exchange of
partial sums),
sums the weight gradients and the metrics with ``all_reduce``, and runs the
same Adam step as every other rank, so the weights stay replicated.

Aggregation layouts (``parallel.partition``):
- flat COO slabs (``graphsum_dist``): the ordered gather-sum of
  ``ops.cuda_segment`` by local row, its backward the same sum transposed
  (by buffer row), then the collectives' autograd;
- the ring (``graphsum_ring``): n_dev steps of the ordered gather-sum of
  one slab against the block the rank holds, the block passed on by
  ``collectives.ppermute_rows`` between steps;
- the adaptive push/pull halo over flat slabs (``graphsum_dist_adaptive``):
  the pulled edges as ``graphsum_dist``, the push pairs' partial rows
  summed on their source rank, one ``all_to_all`` and an ordered add at
  the receiver;
- tile slabs plus a COO residual (``graphsum_dist_hybrid``,
  ``graphsum_dist_hybrid_scaled`` for int8 pattern slabs, and their
  ``_adaptive`` forms with push tiles): K3 over the rectangular slab
  (``ops.cuda_bcsr.bcsr_matmul_rect``);
- the ring, the adaptive and the tile aggregations are self-adjoint (Â is
  symmetric), so each backward is the same aggregation of the cotangent;
- the mesh GAT over ``gat_mesh_pack`` slabs (``ops.tile_attention.
  gat_attend_rect``: K5 forward, K7 backward) or over flat COO slabs.

SAGE and GIN (``MeshSAGE``, ``MeshGIN``: the JAX ``forward_agg_variant``)
run the single-card layers with every aggregation on the rank's slab. Their
diagonal rewrites scale the rank's own rows by its slice of sqrt(deg)
(``RankGraph.sqrt_deg``, from ``sharded_sqrt_deg``) before the exchange, so
the scaled rows are what either halo ships.

Dropout seeds. Every rank draws the epoch's seeds from the same generator
(``train.epoch_seeds`` seeded with ``cfg.tpu.seed``); ``rank_seeds`` then
keeps them on rank 0 and replaces each by ``splitmix64(splitmix64(seed) ^
rank)`` reduced to the seed's range on rank r > 0, so the masks differ
across ranks (the JAX package folds the axis index into the key) and a
world of one replays the single-card run's masks.

``mode=scan`` (the default) runs the whole-run path of ``scan.ScanLoop``
on every rank, the counterpart of the JAX package's ``make_parallel_run``:
the same schedules as the single-card ``fit`` (the deferred-eval epoch of
the mesh GCN stacks the train and val halves into one last-layer
aggregation and one collective), each rank's epoch one CUDA graph with its
NCCL collectives captured in it, the seeds from a table of the epochs'
``rank_seeds``. Every rank reads the same stop flag (the metrics are
all-reduced), so all ranks queue the same epochs.

Checkpoints are the single-card ``fit``'s (``train``'s module docstring):
every rank loads the same ``resume_from`` file; rank 0 writes each
checkpoint while the others wait at a barrier.

``remat`` recomputes each layer in the backward, as on one card; the
recompute issues the layer's collectives again, in the same order on every
rank, inside the captured epoch.

Not ported (NotImplementedError): tensor parallelism (``tp`` > 1). The
mesh CE is the plain masked CE of ``ops.loss`` on every rank, as in the JAX
package (``ce_impl`` does not apply).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from functools import partial

import numpy as np
import torch

from parallel_gcn_tpu_torch.config import Config
from parallel_gcn_tpu_torch.data.parser import TEST, TRAIN, VAL
from parallel_gcn_tpu_torch.device import resolve_device
from parallel_gcn_tpu_torch.models.gat import (LEAKY_SLOPE, GATModel, _edge_softmax_segment,
                                               attend_chunked)
from parallel_gcn_tpu_torch.models.gcn import GCNModel, set_matmul_precision
from parallel_gcn_tpu_torch.models.sage import GINModel, SAGEModel
from parallel_gcn_tpu_torch.ops.cuda_bcsr import BCSR, bcsr_matmul_rect, slab_pack
from parallel_gcn_tpu_torch.ops.cuda_dropout import dropout
from parallel_gcn_tpu_torch.ops.cuda_segment import (Segments, gather, gather_sum,
                                                     gather_sum_t, segment_sum, segment_sum_,
                                                     segments)
from parallel_gcn_tpu_torch.ops.loss import masked_softmax_xent_sums
from parallel_gcn_tpu_torch.ops.tile_attention import (RectAttention, gat_attend_rect,
                                                       rect_attention)
from parallel_gcn_tpu_torch.optim import AdamState, adam_step
from parallel_gcn_tpu_torch.parallel import collectives
from parallel_gcn_tpu_torch.parallel.collectives import (all_reduce_sum, all_to_all_rows,
                                                         buffer_rows, gather_buffer,
                                                         ppermute_rows)
from parallel_gcn_tpu_torch.parallel.partition import (GATMeshPack, HybridShardedGraph,
                                                       ShardedGraph, gat_mesh_pack,
                                                       partition_graph,
                                                       partition_graph_hybrid,
                                                       partition_graph_ring)
from parallel_gcn_tpu_torch.scan import ScanLoop, SeedSlots, seed_table
from parallel_gcn_tpu_torch.train import (_ATTN_SEED_HIGH, _SEED_HIGH, FitResult, _l2_term,
                                          _sync, checkpoint_writer, eager_loop, epoch_seeds,
                                          fit_result, fused_deferred_forward, print_scan,
                                          init_weights, resume_state, resumed_adam,
                                          scan_checkpoints, scan_schedule, skip_epochs)

_M64 = (1 << 64) - 1


# ---------------------------------------------------------------------------
# a rank's share of the data and the graph
# ---------------------------------------------------------------------------


def shard_dataset(ds, sgraph):
    """Host arrays padded to the partition's node count, permuted by its
    slab-balancing ``node_perm`` when present: (x [n_pad, F] f32, labels
    [n_pad] int64 with -1 on padding, split [n_pad] int32)."""
    n_pad = sgraph.n_nodes_pad
    x = np.zeros((n_pad, ds.input_dim), dtype=np.float32)
    x[: ds.n_nodes] = ds.features
    labels = np.full(n_pad, -1, dtype=np.int64)
    labels[: ds.n_nodes] = ds.labels
    split = np.zeros(n_pad, dtype=np.int32)
    split[: ds.n_nodes] = ds.split
    perm = sgraph.node_perm if isinstance(sgraph, (HybridShardedGraph, GATMeshPack)) else None
    if perm is not None:
        x, labels, split = x[perm], labels[perm], split[perm]
    return x, labels, split


@dataclass(frozen=True)
class RankData:
    """One rank's rows of the features, labels and split on its device."""

    x: torch.Tensor
    labels: torch.Tensor
    split: torch.Tensor


def rank_data(ds, sgraph, rank: int, device) -> RankData:
    """Rank ``rank``'s rows of ``shard_dataset``'s arrays on ``device``."""
    rows = slice(rank * sgraph.n_local, (rank + 1) * sgraph.n_local)
    x, labels, split = (torch.from_numpy(np.ascontiguousarray(a[rows])).to(device)
                        for a in shard_dataset(ds, sgraph))
    return RankData(x=x, labels=labels, split=split)


def sharded_sqrt_deg(ds, sgraph) -> np.ndarray:
    """The self-loop-inclusive sqrt(deg) of every partition row, f32
    [n_dev, n_local], 1 on padding rows, in ``shard_dataset``'s row order
    (JAX ``sharded_sqrt_deg``): the diagonal of the SAGE/GIN rewrites, as
    ``Graph.sqrt_deg`` is on one card."""
    s = np.ones(sgraph.n_nodes_pad, np.float32)
    s[: ds.n_nodes] = np.sqrt(np.diff(ds.graph.indptr).astype(np.float32))
    perm = getattr(sgraph, "node_perm", None)
    if perm is not None:
        s = s[perm]
    return s.reshape(sgraph.n_dev, sgraph.n_local)


@dataclass(frozen=True)
class PushGroup:
    """A rank's half of the adaptive halo's push pairs: the partial-sum slab
    it sends (``n_slab`` = n_dev·push_slab rows, one chunk per destination
    rank), built from its COO push edges (``seg`` over the slab's slots,
    ``col`` its local source rows, ``val``) and, on tile slabs, from its
    push tiles (``tiles``, a rect pack over its local rows whose first
    ``n_tile_rows`` output rows land at the slots ``tile_seg`` lists; None
    when the rank pushes no tile); and the receive map: row k of the
    received slab, at ``keep[k]`` (all rows when None), adds into local row
    ``recv_seg.index[k]``, the rows of one destination in (peer, slot)
    order."""

    n_slab: int
    seg: Segments
    col: torch.Tensor
    val: torch.Tensor
    recv_seg: Segments
    keep: torch.Tensor | None = None
    tiles: BCSR | None = None
    tile_seg: Segments | None = None
    n_tile_rows: int = 0


@dataclass(frozen=True)
class RankGraph:
    """Rank ``rank``'s slab of a partition on its device: flat COO
    (``coo``, with the ``Segments`` of its rows and of its buffer columns),
    the ring's slabs (``ring``: per rotation step the ``Segments`` of its
    rows, its columns within the held block and its values), a tile slab
    with its residual (``slab``, ``res`` with its rows' ``Segments``, and
    the int8 slab's ``d``), or the mesh GAT's packs (``attn``, over
    ``res``'s layout). ``send`` is the boundary halo's schedule, the
    ``Segments`` of its sent rows (None: the all_gather halo); ``push`` the
    adaptive halo's push pairs. ``sqrt_deg``: the rank's rows' sqrt(deg)
    (SAGE/GIN only). Padding edges (val 0) are left out of every slab."""

    n_dev: int
    rank: int
    n_local: int
    n_buf: int
    send: Segments | None = None
    coo: tuple | None = None  # (row_local, col, val, row segments, col segments)
    ring: tuple | None = None  # ((row segments, col, val), ...) one per step
    slab: BCSR | None = None
    res: tuple | None = None  # (rrow, rcol, rval, row segments)
    d: torch.Tensor | None = None
    push: PushGroup | None = None
    attn: RectAttention | None = None
    sqrt_deg: torch.Tensor | None = None

    def aggregate(self, h: torch.Tensor) -> torch.Tensor:
        """Â·h on this rank's rows, in h's dtype (the JAX ``_aggregate``)."""
        if self.ring is not None:
            return graphsum_ring(h, self.ring)
        if self.coo is not None:
            if self.push is not None:
                return graphsum_dist_adaptive(h, self.coo, self.send, self.push)
            return graphsum_dist(h, *self.coo, send=self.send)
        if self.slab is None:
            raise ValueError("the mesh GAT's packs carry no GCN aggregation")
        if self.push is not None:
            if self.d is not None:
                return graphsum_dist_hybrid_adaptive_scaled(h, self.d, self.send, self.slab,
                                                            *self.res, self.push)
            return graphsum_dist_hybrid_adaptive(h, self.send, self.slab, *self.res,
                                                 self.push)
        if self.d is not None:
            return graphsum_dist_hybrid_scaled(h, self.d, self.send, self.slab, *self.res)
        return graphsum_dist_hybrid(h, self.send, self.slab, *self.res)


def _push_group(sg, r: int, device) -> PushGroup:
    """Rank ``r``'s ``PushGroup`` of an adaptive partition: the COO push
    edges without their padding (slot n_slab on tile slabs, val 0 on flat
    ones), the push tiles (tile slabs), the receive map without its unused
    slots."""
    hybrid = isinstance(sg, HybridShardedGraph)
    n_slab = sg.n_dev * sg.push_slab
    prow, pcol, pval = ((sg.prow, sg.pcol, sg.pval) if hybrid
                        else (sg.push_row, sg.push_col, sg.push_val))
    live = (prow[r] < n_slab) & (pval[r] != 0)
    slot = torch.from_numpy(prow[r][live].astype(np.int64)).to(device)
    recv = sg.push_recv[r]
    keep = np.flatnonzero(recv < sg.n_local)
    group = dict(
        n_slab=n_slab, seg=segments(slot, n_slab),
        col=torch.from_numpy(pcol[r][live].astype(np.int64)).to(device),
        val=torch.from_numpy(pval[r][live].astype(np.float32)).to(device),
        recv_seg=segments(torch.from_numpy(recv[keep].astype(np.int64)).to(device),
                          sg.n_local),
        keep=None if len(keep) == len(recv) else torch.from_numpy(keep).to(device))
    ptiles = sg.ptiles[r] if hybrid else None
    if ptiles is not None and ptiles.reshape(ptiles.shape[0], -1).any():
        # (a rank whose push pairs hold residual edges only has zero tiles)
        dst = sg.pt_dst[r]
        n_rows = int((dst < n_slab).sum())  # the real rows lead, in slot order
        group.update(
            tiles=slab_pack(sg.ptiles[r], sg.ptrow[r], sg.ptcol[r], dst.shape[0],
                            sg.n_local, sg.tile_dtype, device),
            tile_seg=segments(torch.from_numpy(dst[:n_rows].astype(np.int64)).to(device),
                              n_slab),
            n_tile_rows=n_rows)
    return PushGroup(**group)


def rank_graph(sgraph, rank: int, device, sqrt_deg: np.ndarray | None = None) -> RankGraph:
    """Rank ``rank``'s slab of ``sgraph`` (``ShardedGraph``,
    ``HybridShardedGraph`` or ``GATMeshPack``) on ``device``, with its rows
    of ``sqrt_deg`` (``sharded_sqrt_deg``) when given."""
    r = rank

    def coo(rows, cols, vals, n_cols):
        """(row, col, val, row segments, col segments) of the live edges."""
        live = vals != 0
        row = torch.from_numpy(rows[live].astype(np.int64)).to(device)
        col = torch.from_numpy(cols[live].astype(np.int64)).to(device)
        val = torch.from_numpy(vals[live].astype(np.float32)).to(device)
        return row, col, val, segments(row, sgraph.n_local), segments(col, n_cols)

    def i64(a):
        return torch.from_numpy(a[r].astype(np.int64)).to(device)

    def f32(a):
        return torch.from_numpy(np.asarray(a[r], np.float32)).to(device)

    base = dict(n_dev=sgraph.n_dev, rank=r, n_local=sgraph.n_local, n_buf=sgraph.n_buf,
                send=None if sgraph.send_idx is None else segments(i64(sgraph.send_idx),
                                                                    sgraph.n_local),
                push=_push_group(sgraph, r, device) if getattr(sgraph, "push_slab", 0)
                else None,
                sqrt_deg=None if sqrt_deg is None else f32(sqrt_deg))
    if isinstance(sgraph, GATMeshPack):
        sg = sgraph
        attn = rect_attention(sg.tiles_r[r], sg.trow_r[r], sg.tcol_r[r], sg.tiles_c[r],
                              sg.trow_c[r], sg.tcol_c[r], sg.res_row[r], sg.res_col[r],
                              sg.res_val[r], sg.has_res, sg.n_local, sg.n_buf,
                              sg.tile_dtype, device)
        return RankGraph(**base, attn=attn)
    if isinstance(sgraph, HybridShardedGraph):
        sg = sgraph
        slab = slab_pack(sg.tiles[r], sg.trow[r], sg.tcol[r], sg.n_local, sg.n_buf,
                         sg.tile_dtype, device)
        rrow, rcol, rval, rseg, _ = coo(sg.res_row[r], sg.res_col[r], sg.res_val[r],
                                         sg.n_buf)
        return RankGraph(**base, slab=slab, res=(rrow, rcol, rval, rseg),
                         d=None if sg.sym_scale is None else f32(sg.sym_scale))
    if sgraph.ring:
        steps = (coo(sgraph.row_local[r, s], sgraph.col[r, s], sgraph.val[r, s],
                     sgraph.n_local) for s in range(sgraph.n_dev))
        return RankGraph(**base, ring=tuple((seg, col, val) for _, col, val, seg, _ in steps))
    return RankGraph(**base, coo=coo(sgraph.row_local[r], sgraph.col[r], sgraph.val[r],
                                     sgraph.n_buf))


# ---------------------------------------------------------------------------
# distributed aggregation
# ---------------------------------------------------------------------------


def graphsum_dist(x_local, row_local, col, val, row_seg: Segments, col_seg: Segments,
                  send: Segments | None = None):
    """Distributed Â·x over row-sharded features, flat COO slab: the source
    buffer (all_gather, or the boundary halo with ``send``), then
    ``val·x_buf[col]`` summed into ``row_local`` in edge order (``row_seg``),
    in x's dtype. The backward sums the cotangent by buffer row
    (``col_seg``), then transposes the collective."""
    x_buf = gather_buffer(x_local, send)
    return gather_sum_t(x_buf, row_seg, col, val, col_seg)


class _SelfAdjoint(torch.autograd.Function):
    """``impl(x)`` whose backward is ``impl`` of the cotangent: exact for any
    layout of the symmetric Â, however its edges are routed, because the
    cotangent is row-sharded like x and Σ_b A[b,d]ᵀ g_b = Σ_b A[d,b] g_b
    (the JAX package's custom VJPs of the tile and adaptive aggregations)."""

    @staticmethod
    def forward(ctx, x, impl):
        ctx.impl = impl
        return impl(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.impl(g.contiguous()), None


def _scaled(impl, d_local):
    """int8 pattern slabs: scale the local rows by d before any exchange
    (the pulled rows and the pushed partials then carry d-scaled operands)
    and the output rows after: d ⊙ B (d ⊙ x) = Â·x."""

    def run(x_local):
        out = impl((d_local[:, None] * x_local.float()).to(x_local.dtype))
        return (d_local[:, None] * out).to(out.dtype)

    return run


def pull_sum(x_buf, slab, rcol, rval, res_seg):
    """The pulled and local edges of a tile slab: K3 over the slab against
    the source buffer plus the residual's ordered gather-sum (its rows are
    ``res_seg``'s index), [n_local, F] in x_buf's dtype (K3's f32 rounded
    first, as JAX casts it)."""
    out = bcsr_matmul_rect(slab, x_buf).to(x_buf.dtype)
    return out + gather_sum(x_buf, res_seg, rcol, rval)


def push_partials(x_local, push: PushGroup):
    """This rank's partial-sum slab [n_slab, F] in x's dtype: the push
    edges summed by slot in edge order (kernel (a)), then on tile slabs K3
    over the push tiles, rounded to x's dtype and added at their slots
    (kernel (b); each slot takes at most one tile row). JAX rounds both to
    x's dtype before the exchange as well."""
    slab = gather_sum(x_local, push.seg, push.col, push.val)
    if push.tiles is not None:
        part = bcsr_matmul_rect(push.tiles, x_local)[: push.n_tile_rows].to(slab.dtype)
        segment_sum_(slab, push.tile_seg, part)
    return slab


def receive_add(out, recv, push: PushGroup):
    """``out`` plus the received partial rows at their local rows, in place:
    kernel (b) adds a row's partials in (peer, slot) order to out's value in
    float32 and rounds once; the unused slots are left out."""
    if push.keep is not None:
        recv = recv.index_select(0, push.keep)
    return segment_sum_(out, push.recv_seg, recv.to(out.dtype))


def ring_step(acc, blk, step):
    """One step of the ring: the step's slab summed against the held block
    in edge order (kernel (a), rounded to blk's dtype once), added to the
    accumulator in blk's dtype, as JAX keeps it."""
    seg, col, val = step
    part = gather_sum(blk, seg, col, val)
    return part if acc is None else acc + part


def _ring_impl(x_local, steps):
    acc, blk = None, x_local
    for s, step in enumerate(steps):
        acc = ring_step(acc, blk, step)
        if s + 1 < len(steps):  # JAX's last rotation only sends blocks home
            blk = ppermute_rows(blk)
    return acc


def graphsum_ring(x_local, steps):
    """Distributed Â·x over the ring halo (JAX ``graphsum_ring``): n_dev
    steps, each the ordered gather-sum of the step's slab against the block
    this rank holds, then the block passed to rank + 1. A rank holds one
    remote block at a time instead of the gathered matrix. ``steps``:
    ``RankGraph.ring``. Self-adjoint."""
    return _SelfAdjoint.apply(x_local, partial(_ring_impl, steps=steps))


def _adaptive_impl(x_local, coo, send, push):
    row, col, val, row_seg, _ = coo
    out = gather_sum(buffer_rows(x_local, send), row_seg, col, val)
    return receive_add(out, all_to_all_rows(push_partials(x_local, push)), push)


def graphsum_dist_adaptive(x_local, coo, send, push: PushGroup):
    """Distributed Â·x over flat COO slabs with the adaptive push/pull halo
    (JAX ``graphsum_dist_adaptive``): the pulled and local edges through the
    boundary buffer, the push edges summed on this rank by slot, one
    ``all_to_all`` of the partial rows, the received rows added at their
    local rows in order. ``coo``: ``RankGraph.coo``. Self-adjoint."""
    return _SelfAdjoint.apply(x_local, partial(_adaptive_impl, coo=coo, send=send, push=push))


def _hybrid_impl(x_local, send, slab, rrow, rcol, rval, res_seg, push=None):
    del rrow  # res_seg's index
    out = pull_sum(buffer_rows(x_local, send), slab, rcol, rval, res_seg)
    if push is None:
        return out
    return receive_add(out, all_to_all_rows(push_partials(x_local, push)), push)


def graphsum_dist_hybrid(x_local, send, slab, rrow, rcol, rval, res_seg):
    """Distributed Â·x over a rank's tile slab (K3 rect) plus its COO
    residual summed in edge order (``res_seg``: rrow's segments over the
    rank's rows), in x's dtype; ``send`` None for the all_gather halo.
    Self-adjoint."""
    return _SelfAdjoint.apply(x_local, partial(_hybrid_impl, send=send, slab=slab, rrow=rrow,
                                               rcol=rcol, rval=rval, res_seg=res_seg))


def graphsum_dist_hybrid_scaled(x_local, d_local, send, slab, rrow, rcol, rval, res_seg):
    """``graphsum_dist_hybrid`` for int8 pattern slabs: the slab holds the
    0/k pattern, the residual the multiplicities, ``d_local`` (deg^{-1/2} of
    the rank's rows) the normalization."""
    impl = partial(_hybrid_impl, send=send, slab=slab, rrow=rrow, rcol=rcol, rval=rval,
                   res_seg=res_seg)
    return _SelfAdjoint.apply(x_local, _scaled(impl, d_local))


def graphsum_dist_hybrid_adaptive(x_local, send, slab, rrow, rcol, rval, res_seg,
                                  push: PushGroup):
    """Distributed Â·x over tile slabs with the adaptive halo (JAX
    ``graphsum_dist_hybrid_adaptive``): the pulled slab as
    ``graphsum_dist_hybrid``, plus the push pairs' partial slab (the push
    residual by slot, K3 over the push tiles) exchanged by one
    ``all_to_all`` and added at its rows in order. Self-adjoint."""
    return _SelfAdjoint.apply(x_local, partial(_hybrid_impl, send=send, slab=slab, rrow=rrow,
                                               rcol=rcol, rval=rval, res_seg=res_seg,
                                               push=push))


def graphsum_dist_hybrid_adaptive_scaled(x_local, d_local, send, slab, rrow, rcol, rval,
                                         res_seg, push: PushGroup):
    """``graphsum_dist_hybrid_adaptive`` for int8 pattern slabs (JAX
    ``graphsum_dist_hybrid_adaptive_scaled``): d scales the local rows
    before any exchange and the output rows after."""
    impl = partial(_hybrid_impl, send=send, slab=slab, rrow=rrow, rcol=rcol, rval=rval,
                   res_seg=res_seg, push=push)
    return _SelfAdjoint.apply(x_local, _scaled(impl, d_local))


# ---------------------------------------------------------------------------
# the mesh models: the single-card models over a rank's slab
# ---------------------------------------------------------------------------


class _OnSlab:
    """A single-card model's aggregation on the rank's slab, in h's dtype."""

    def aggregate(self, h: torch.Tensor, graph: RankGraph) -> torch.Tensor:
        return graph.aggregate(h).to(h.dtype)


class MeshGCN(_OnSlab, GCNModel):
    """The GCN forward with every aggregation on the rank's slab (the JAX
    mesh forward: dropout → X·W → Â·(·) → ReLU, residual as on one card)."""


class MeshSAGE(_OnSlab, SAGEModel):
    """SAGE over the rank's slab (JAX ``forward_agg_variant``): the mean
    rewrite scales the rank's rows by ``RankGraph.sqrt_deg`` before the
    exchange."""


class MeshGIN(_OnSlab, GINModel):
    """GIN over the rank's slab, as ``MeshSAGE``, with the sum rewrite."""


class MeshGAT(GATModel):
    """The GAT forward over the rank's slab: per layer one exchange carries
    [W·h | t] into the source buffer; attention over the ``gat_mesh_pack``
    tiles (``tile``) or the flat COO slab (``segment``, streamed in chunks
    with ``edge_chunk``)."""

    def _check_graph(self, graph: RankGraph) -> None:
        if (graph.attn is None) == (self.backend == "tile"):
            raise ValueError(f"mesh GAT backend {self.backend!r} does not fit the rank's slab")

    def _source_buffer(self, graph, hw3, t):
        n, H, D = hw3.shape
        buf = gather_buffer(torch.cat([hw3.reshape(n, H * D), t], dim=1), graph.send)
        return buf[:, H * D:], buf[:, : H * D].view(-1, H, D)

    def _attend_tile(self, graph, hw3, s, t, seed, training):
        t_buf, hw_buf = self._source_buffer(graph, hw3, t)
        rate = self.attn_dropout if training else 0.0
        return gat_attend_rect(s, t_buf, hw_buf, graph.attn, slope=LEAKY_SLOPE,
                               attn_dropout=rate,
                               seed=seed if rate > 0.0 else None).to(hw3.dtype)

    def _attend_segment(self, graph, hw3, s, t, seed, training):
        t_buf, hw_buf = self._source_buffer(graph, hw3, t)
        chunks = self.chunks_of(*graph.coo[:3], graph.n_local, graph.n_buf)
        if chunks is not None:
            # the streaming softmax over the rank's slab (JAX _attend_chunked)
            rate = self.attn_dropout if training else 0.0
            return attend_chunked(chunks, s, t_buf, hw_buf, seed, rate)
        edges = _Edges(*graph.coo)
        alpha = _edge_softmax_segment(edges, s, t_buf, graph.n_local)
        if training and self.attn_dropout > 0.0:
            alpha = dropout(alpha.contiguous(), seed, self.attn_dropout)
        contrib = (alpha[:, :, None] * gather(hw_buf, edges.col_seg)).float()
        return segment_sum(contrib, edges.row_seg).to(hw3.dtype)


@dataclass(frozen=True)
class _Edges:
    """COO triplets in the shape ``models.gat._edge_softmax_segment`` reads:
    ``row`` local dest rows, ``col`` buffer source rows, with their
    ``Segments`` over the rank's rows and over the buffer."""

    row: torch.Tensor
    col: torch.Tensor
    val: torch.Tensor
    row_seg: Segments
    col_seg: Segments


def _mix64(x: int) -> int:
    """splitmix64's finalizer."""
    x = (x + 0x9E3779B97F4A7C15) & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return x ^ (x >> 31)


def rank_seeds(seeds: list[int], rank: int, attention: bool = False) -> list[int]:
    """The epoch's dropout seeds for rank ``rank``: unchanged on rank 0;
    ``splitmix64(splitmix64(seed) ^ rank)`` reduced to the seed's range on
    the others. With ``attention`` (GAT) the odd entries are int32 attention
    seeds."""
    if rank == 0:
        return list(seeds)
    highs = [(_ATTN_SEED_HIGH if attention and i % 2 else _SEED_HIGH)
             for i in range(len(seeds))]
    return [_mix64(_mix64(s) ^ rank) % hi for s, hi in zip(seeds, highs)]


def build_mesh_model(cfg: Config, sgraph, weights: list[torch.Tensor],
                     device) -> MeshGCN | MeshGAT | MeshSAGE | MeshGIN:
    """The mesh model of ``cfg`` with a copy of ``weights`` (float32, the
    family's leaves in JAX leaf order) on ``device``; training leaves the
    caller's tensors alone."""
    weights = [w.detach().to(device, torch.float32, copy=True) for w in weights]
    common = dict(compute_dtype=cfg.tpu.compute_dtype, residual=cfg.gcn.residual,
                  remat=cfg.gcn.remat)
    if cfg.gcn.model == "gat":
        return MeshGAT(weights, cfg.gcn.dropouts, heads=cfg.gcn.heads,
                       attn_dropout=cfg.gcn.attn_dropout,
                       backend="tile" if isinstance(sgraph, GATMeshPack) else "segment",
                       edge_chunk=cfg.tpu.edge_chunk, **common)
    if cfg.gcn.model == "sage":
        return MeshSAGE(weights, cfg.gcn.dropouts, **common)
    if cfg.gcn.model == "gin":
        return MeshGIN(weights, cfg.gcn.dropouts, gin_eps=cfg.gcn.gin_eps, **common)
    return MeshGCN(weights, cfg.gcn.dropouts, fuse_dropout_matmul=cfg.tpu.fuse_dropout_matmul,
                   **common)


# ---------------------------------------------------------------------------
# epoch step, eval, input pre-aggregation
# ---------------------------------------------------------------------------


def _global_ce(logits, labels, mask, num_samples):
    """(loss, accuracy) of the whole world from this rank's rows: the local
    sums of ``ops.loss`` reduced over the ranks, divided by the split's
    size."""
    sums = all_reduce_sum(torch.stack(masked_softmax_xent_sums(logits, labels, mask)))
    return sums[0] / float(num_samples), sums[1] / float(num_samples)


def make_parallel_epoch_step(cfg: Config, model, graph: RankGraph, data: RankData,
                             split_counts: dict, x_train=None, x_eval=None):
    """One-epoch function ``(opt_state, seeds) -> metrics[4]`` (train_loss,
    train_acc, val_loss, val_acc; the same on every rank). ``seeds`` are
    this rank's (``rank_seeds``). The local loss's gradient, its sum over
    the ranks (one ``all_reduce`` with the train metrics' sums), Adam in
    place, then the val eval on the updated weights. ``x_train`` /
    ``x_eval``: the rank's Â·X (``make_preagg_fn``), and layer 0 of the
    train / val forward skips its aggregation."""
    adam = cfg.adam
    wd = adam.weight_decay
    n_train, n_val = split_counts[TRAIN], split_counts[VAL]
    train_mask = data.split == TRAIN
    val_mask = data.split == VAL
    weights = list(model.weights)
    x_tr = data.x if x_train is None else x_train
    x_ev = data.x if x_eval is None else x_eval

    def step(opt_state: AdamState, seeds: list[int]) -> torch.Tensor:
        logits = model(x_tr, graph, training=True, seeds=seeds,
                       input_preagg=x_train is not None)
        loss_sum, correct = masked_softmax_xent_sums(logits, data.labels, train_mask)
        grads = torch.autograd.grad(loss_sum / float(n_train), weights)
        grads, sums = _reduce_grads(weights, grads, torch.stack([loss_sum.detach(), correct]))
        with torch.no_grad():
            # the L2 term of the PRE-update W0
            train_loss = sums[0] / float(n_train) + _l2_term(wd, weights[0])
            train_acc = sums[1] / float(n_train)
        adam_step(weights, grads, opt_state, learning_rate=adam.learning_rate,
                  weight_decay=wd, beta1=adam.beta1, beta2=adam.beta2, eps=adam.eps)
        with torch.no_grad():
            val_ce, val_acc = _global_ce(
                model(x_ev, graph, training=False, input_preagg=x_eval is not None),
                data.labels, val_mask, n_val)
            return torch.stack([train_loss, train_acc,
                                val_ce + _l2_term(wd, weights[0]), val_acc])

    return step


def make_parallel_deferred_step(cfg: Config, model: MeshGCN, graph: RankGraph,
                                data: RankData, split_counts: dict, x_train=None,
                                x_eval=None):
    """The mesh GCN's deferred-eval epoch (``train.fused_deferred_forward``
    over the rank's slab: one last-layer aggregation, one collective, for
    the train and the val halves): ``(opt_state, seeds) -> metrics[4]``,
    this epoch's train loss and accuracy and the val loss and accuracy of
    the weights it started from. One ``all_reduce`` carries the local
    gradients and both halves' sums."""
    adam = cfg.adam
    wd = adam.weight_decay
    n_train, n_val = split_counts[TRAIN], split_counts[VAL]
    train_mask = data.split == TRAIN
    val_mask = data.split == VAL
    weights = list(model.weights)
    x_tr = data.x if x_train is None else x_train
    x_ev = data.x if x_eval is None else x_eval

    def step(opt_state: AdamState, seeds) -> torch.Tensor:
        lt, le = fused_deferred_forward(model, x_tr, x_ev, graph, seeds,
                                        train_preagg=x_train is not None,
                                        eval_preagg=x_eval is not None)
        loss_sum, correct = masked_softmax_xent_sums(lt, data.labels, train_mask)
        grads = torch.autograd.grad(loss_sum / float(n_train), weights)
        with torch.no_grad():
            val_sums = masked_softmax_xent_sums(le, data.labels, val_mask)
            sums = torch.stack([loss_sum.detach(), correct, *val_sums])
        grads, sums = _reduce_grads(weights, grads, sums)
        with torch.no_grad():
            # the L2 term of the PRE-update W0, which the val half also ran on
            pen = _l2_term(wd, weights[0])
            metrics = torch.stack([sums[0] / float(n_train) + pen, sums[1] / float(n_train),
                                   sums[2] / float(n_val) + pen, sums[3] / float(n_val)])
        adam_step(weights, grads, opt_state, learning_rate=adam.learning_rate,
                  weight_decay=wd, beta1=adam.beta1, beta2=adam.beta2, eps=adam.eps)
        return metrics

    return step


def _reduce_grads(weights, grads, sums):
    """One ``all_reduce`` of the local gradients and the metric ``sums``:
    (the world's gradients shaped like ``weights``, the world's sums)."""
    flat = all_reduce_sum(torch.cat([g.reshape(-1).float() for g in grads] + [sums]))
    out, off = [], 0
    for w in weights:
        out.append(flat[off : off + w.numel()].view(w.shape))
        off += w.numel()
    return out, flat[off:]


def make_parallel_eval_fn(cfg: Config, model, graph: RankGraph, data: RankData,
                          split_counts: dict, split: int, x_eval=None,
                          preagg: bool = False):
    """``() -> (loss, acc)`` of ``split`` on the current weights, over the
    whole world. ``preagg``: ``x_eval`` holds Â·X and layer 0 skips its
    aggregation."""
    mask = data.split == split
    x = data.x if x_eval is None else x_eval

    def eval_fn():
        with torch.no_grad():
            ce, acc = _global_ce(model(x, graph, training=False, input_preagg=preagg),
                                 data.labels, mask, split_counts[split])
            return ce + _l2_term(cfg.adam.weight_decay, model.weights[0]), acc

    return eval_fn


def make_preagg_fn(graph: RankGraph):
    """One distributed Â·X for the input pre-aggregation hoist (exact:
    Â·(X·W0) = (Â·X)·W0)."""

    def preagg(x_local: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            return graph.aggregate(x_local)

    return preagg


# ---------------------------------------------------------------------------
# the run
# ---------------------------------------------------------------------------


def _check_config(cfg: Config, halo: str) -> None:
    """The JAX package's config errors (``fit_parallel``), and
    NotImplementedError for tensor parallelism, which is not ported."""
    gat = cfg.gcn.model == "gat"
    tiles = cfg.tpu.backend in ("hybrid", "bcsr")
    if gat and (halo in ("ring", "adaptive") or cfg.tpu.tp > 1):
        raise ValueError(
            "model=gat over the mesh supports the flat COO partition or the gat_mesh_pack "
            "tile partition, with the all_gather or boundary halo — set "
            "halo=all_gather|boundary, tp=1")
    if cfg.tpu.tp > 1:
        raise NotImplementedError(
            f"not yet ported to parallel_gcn_tpu_torch: tp={cfg.tpu.tp}")
    if gat and tiles and cfg.tpu.edge_chunk:
        raise ValueError(
            "edge_chunk streams the SEGMENT attention; the tile backend already bounds "
            "memory at O(N·heads) — unset edge_chunk or set backend=segment")
    if tiles and halo == "ring":
        raise ValueError(
            "backend=hybrid/bcsr uses per-device tile slabs against the all_gather, "
            "boundary or adaptive halo; the ppermute ring is only available with the COO "
            "backends (set backend=segment, or halo=boundary|adaptive to keep the tile "
            "slabs AND memory scaling)")


def partition_for(cfg: Config, ds, n_devices: int, halo: str):
    """The partition ``fit_parallel`` trains on (JAX ``fit_parallel``): tile
    slabs for ``backend=hybrid|bcsr`` with the all_gather, boundary or
    adaptive halo (and the mesh GAT's packs over them for ``model=gat``);
    otherwise flat COO slabs, or the ring's. ``halo_fallback`` turns a
    boundary or adaptive buffer that would not be smaller into the
    all_gather layout."""
    if cfg.tpu.backend in ("hybrid", "bcsr"):
        tile_dtype = cfg.tpu.tile_dtype
        if tile_dtype == "auto":
            tile_dtype = "float32" if cfg.tpu.matmul_precision == "highest" else "bfloat16"
        sgraph = partition_graph_hybrid(
            ds.graph, n_devices, node_pad=cfg.tpu.node_pad,
            tile_r=cfg.tpu.tile_size, tile_c=cfg.tpu.tile_cols, tile_dtype=tile_dtype,
            tile_budget_bytes=cfg.tpu.tile_budget_mb * 1024 * 1024,
            min_tile_nnz=cfg.tpu.min_tile_nnz or None,
            boundary=halo == "boundary", adaptive=halo == "adaptive",
            balance=cfg.tpu.balance_slabs, boundary_fallback=cfg.tpu.halo_fallback,
        )
        return gat_mesh_pack(sgraph) if cfg.gcn.model == "gat" else sgraph
    if halo == "ring":
        return partition_graph_ring(ds.graph, n_devices, node_pad=cfg.tpu.node_pad)
    return partition_graph(ds.graph, n_devices, node_pad=cfg.tpu.node_pad,
                           boundary=halo == "boundary", adaptive=halo == "adaptive",
                           boundary_fallback=cfg.tpu.halo_fallback)


def halo_of(sgraph) -> str:
    """The halo a partition's layout runs: ring, adaptive (push pairs),
    boundary or all_gather."""
    if getattr(sgraph, "ring", False):
        return "ring"
    if getattr(sgraph, "push_slab", 0):
        return "adaptive"
    return "all_gather" if sgraph.send_idx is None else "boundary"


@dataclass
class RankRun:
    """What ``fit_parallel`` trains on one rank: the partition, the rank's
    slab, rows and model, and the splits' global sizes."""

    sgraph: ShardedGraph | HybridShardedGraph | GATMeshPack
    graph: RankGraph
    data: RankData
    model: MeshGCN | MeshGAT | MeshSAGE | MeshGIN
    split_counts: dict


def build_rank(cfg: Config, ds, rank: int, n_devices: int, halo: str, device,
               weights: list[torch.Tensor] | None = None) -> RankRun:
    """Rank ``rank``'s share of a run of ``cfg`` over ``n_devices`` ranks on
    ``device``; ``weights`` (float32, the family's leaves in JAX leaf order)
    or the Glorot init from ``cfg.tpu.seed``. Sets the matmul precision."""
    sgraph = partition_for(cfg, ds, n_devices, halo)
    if weights is None:
        weights = init_weights(cfg, ds.input_dim, ds.output_dim)
    set_matmul_precision(cfg.tpu.matmul_precision)
    sdeg = sharded_sqrt_deg(ds, sgraph) if cfg.gcn.model in ("sage", "gin") else None
    return RankRun(
        sgraph=sgraph, graph=rank_graph(sgraph, rank, device, sdeg),
        data=rank_data(ds, sgraph, rank, device),
        model=build_mesh_model(cfg, sgraph, weights, device),
        split_counts={s: int((ds.split == s).sum()) for s in (TRAIN, VAL, TEST)},
    )


def preagg_inputs(cfg: Config, run: RankRun):
    """(x_train, x_eval) of ``run``: the input pre-aggregation the
    single-card ``fit`` and the JAX package's whole-run program hoist. The
    evals always read Â·X, the train forward too at input dropout 0 (exact
    reassociation; GCN only, as the JAX mesh ignores the knob for the GAT,
    SAGE and GIN); None where the forward reads X."""
    x_train = x_eval = None
    if cfg.tpu.input_preagg and cfg.gcn.model == "gcn" and cfg.gcn.n_layers >= 2:
        x_eval = make_preagg_fn(run.graph)(run.data.x).to(run.model.compute_dtype)
        if cfg.gcn.dropouts[0] == 0.0:
            x_train = x_eval
    return x_train, x_eval


def make_parallel_scan_loop(cfg: Config, run: RankRun, opt_state: AdamState,
                            gen: torch.Generator, x_train=None, x_eval=None, start: int = 0,
                            checkpoint=None) -> ScanLoop:
    """The whole-run loop of ``run`` on its rank (``scan.ScanLoop``) over the
    epochs after ``start``: the schedule of ``train.scan_schedule``, every
    epoch's ``rank_seeds`` drawn from ``gen`` now; ``x_train``, ``x_eval`` as
    ``preagg_inputs`` gives them; ``checkpoint`` as ``train.make_scan_loop``
    takes it."""
    model, graph, data, counts = run.model, run.graph, run.data, run.split_counts
    gat = isinstance(model, MeshGAT)
    epochs = max(cfg.gcn.epochs - start, 0)
    k, deferred = scan_schedule(model, cfg, epochs)
    if deferred:
        step = make_parallel_deferred_step(cfg, model, graph, data, counts, x_train, x_eval)
        final_val = make_parallel_eval_fn(cfg, model, graph, data, counts, VAL,
                                          x_eval=x_eval, preagg=x_eval is not None)
    else:
        step = make_parallel_epoch_step(cfg, model, graph, data, counts, x_train, x_eval)
        final_val = None
    table = seed_table([rank_seeds(epoch_seeds(gen, model.n_layers, attention=gat),
                                   graph.rank, gat) for _ in range(epochs)],
                       data.x.device)
    return ScanLoop(lambda slots: step(opt_state, slots),
                    state=[*model.weights, *opt_state.m, *opt_state.v, opt_state.step],
                    seeds=SeedSlots(model.n_layers, gat, data.x.device), table=table, k=k,
                    final_val=final_val, device=data.x.device,
                    every=cfg.train.checkpoint_every if checkpoint else 0,
                    checkpoint=checkpoint)


def fit_parallel(
    cfg: Config,
    ds,
    *,
    n_devices: int | None = None,
    halo: str | None = None,
    device: str | torch.device = "cuda",
    weights: list[torch.Tensor] | None = None,
    verbose: bool | None = None,
    resume_from: str | None = None,
) -> FitResult:
    """The node-partitioned training run, the mesh counterpart of
    ``train.fit``: partition the host dataset ``ds``, train with per-epoch
    val metrics and the reference's early-stopping rule, evaluate the test
    split. Call it on every rank of a world of ``n_devices`` processes
    (torchrun), or with ``n_devices`` 1 and no world (a world of one is
    started). ``halo``: ``all_gather``, ``boundary``, ``adaptive`` or
    ``ring`` (default ``cfg.tpu.halo``). ``weights`` (float32, a GAT's in JAX leaf order)
    replace the Glorot init from ``cfg.tpu.seed``; ``resume_from`` and the
    checkpoint options as ``train.fit`` takes them. The history, losses and
    accuracies are the whole world's, equal on every rank; only rank 0
    prints."""
    halo = halo or cfg.tpu.halo
    _check_config(cfg, halo)
    device = collectives.local_device(
        device if isinstance(device, torch.device) else resolve_device(device))
    if n_devices is None:
        n_devices = cfg.tpu.n_devices or (
            torch.distributed.get_world_size() if torch.distributed.is_initialized() else 1)
    verbose = cfg.train.verbose if verbose is None else verbose
    gat = cfg.gcn.model == "gat"
    with collectives.world(n_devices, device) as (rank, _):
        verbose = verbose and rank == 0
        ck, weights, start, seed = resume_state(resume_from, weights, cfg.tpu.seed, "cpu",
                                                verbose)
        run = build_rank(cfg, ds, rank, n_devices, halo, device, weights)
        sgraph, model = run.sgraph, run.model
        opt_state = resumed_adam(ck, list(model.weights))
        if verbose:
            print(f"mesh: {n_devices} rank(s), halo={halo_of(sgraph)}, "
                  f"n_local={sgraph.n_local}, n_buf={sgraph.n_buf}, device {device}")

        x_train, x_eval = preagg_inputs(cfg, run)
        test_fn = make_parallel_eval_fn(cfg, model, run.graph, run.data, run.split_counts,
                                        TEST, x_eval=x_eval, preagg=x_eval is not None)
        gen = torch.Generator().manual_seed(seed)
        skip_epochs(gen, start, model.n_layers, gat)
        ckpt_s: list = []
        save = checkpoint_writer(cfg, model, opt_state, seed, ckpt_s, write=rank == 0,
                                 barrier=torch.distributed.barrier, verbose=verbose)
        scan = None
        _sync(device)
        t0 = time.perf_counter()
        if cfg.train.mode == "scan":
            scan = make_parallel_scan_loop(cfg, run, opt_state, gen, x_train, x_eval, start,
                                           scan_checkpoints(cfg, start, save, verbose)).run()
            total = time.perf_counter() - t0
            history, epochs_run = scan.history, scan.epochs_run
            if verbose:
                print_scan(scan, cfg.gcn.epochs, start)
        else:
            step = make_parallel_epoch_step(cfg, model, run.graph, run.data,
                                            run.split_counts, x_train, x_eval)
            history, epochs_run = eager_loop(
                step, opt_state, cfg, SeedSlots(model.n_layers, gat, device),
                lambda: rank_seeds(epoch_seeds(gen, model.n_layers, attention=gat), rank, gat),
                device, verbose, start, save)
            total = time.perf_counter() - t0
        if save is not None:
            save("ckpt_final.npz", start + epochs_run)
        test_loss, test_acc = (float(v) for v in test_fn())
        if verbose:
            print(f"test_loss={test_loss:.5f} test_acc={test_acc:.5f}")
            print(f"total time: {total:.5f}")
    return fit_result(model, history, epochs_run, test_loss, test_acc, total, scan,
                      start_epoch=start, checkpoint_s=ckpt_s)
