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
world of one replays the single-card run's masks. Under tensor parallelism
a layer whose input is feat-sharded derives its seed once more from the
feat index; a replicated input's mask is the same on every feat rank.

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

Tensor parallelism (``tp`` > 1; the GCN, SAGE and GIN, on every halo and
layout): a world of ``n_devices × tp`` processes forms the JAX package's
(nodes, feat) grid (``collectives.grid``). The node ranks partition the
rows as above; the ``tp`` feat ranks of a node rank hold the same rows and
a 1/tp shard of each feat-sharded weight (``tp_schedule``,
``shard_weights``: Megatron's col/row split), and the models' TP layers
(``MeshGCN``, ``MeshSAGE``, ``MeshGIN`` with ``feat``) reach the feat
collectives through their ``collectives.FeatGroup``. Gradients and metrics
are reduced over the node group only; the decayed leaf's Σw² is summed over
feat in every reported loss. Under ``remat`` a TP layer checkpoints its
pieces between feat collectives, so the recompute re-runs none of them.
Checkpoints hold full arrays: gathered over feat to write, sliced on
resume. The GAT takes no ``tp``, as in the JAX package.

The mesh CE is the plain masked CE of ``ops.loss`` on every rank, as in the
JAX package (``ce_impl`` does not apply).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from functools import partial

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

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
from parallel_gcn_tpu_torch.ops.loss import l2_penalty, masked_softmax_xent_sums
from parallel_gcn_tpu_torch.ops.sparse_matmul import feature_transform
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
from parallel_gcn_tpu_torch.train import (_ATTN_SEED_HIGH, _SEED_HIGH, FitResult, _sync,
                                          checkpoint_writer, eager_loop, epoch_seeds,
                                          fit_result, fused_deferred_forward, init_weights,
                                          l2_term, print_scan, resume_state, resumed_adam,
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
    with its residual (``slab``, ``res`` its rows' ``Segments`` with its
    columns and values packed, and the int8 slab's ``d``), or the mesh
    GAT's packs (``attn``). ``send`` is the boundary halo's schedule, the
    ``Segments`` of its sent rows (None: the all_gather halo); ``push`` the
    adaptive halo's push pairs. ``sqrt_deg``: the rank's rows' sqrt(deg)
    (SAGE/GIN only). Padding edges (val 0) are left out of every slab."""

    n_dev: int
    rank: int
    n_local: int
    n_buf: int
    send: Segments | None = None
    coo: tuple | None = None  # (row_local, col, val, row segments, col segments)
    ring: tuple | None = None  # the row segments of each step (their gather operands packed)
    slab: BCSR | None = None
    res: Segments | None = None  # the residual's row segments (gather operands packed)
    d: torch.Tensor | None = None
    push: PushGroup | None = None
    attn: RectAttention | None = None
    sqrt_deg: torch.Tensor | None = None
    group: object = None  # the node group the exchanges run over (None: the world)

    def aggregate(self, h: torch.Tensor) -> torch.Tensor:
        """Â·h on this rank's rows, in h's dtype (the JAX ``_aggregate``)."""
        g = self.group
        if self.ring is not None:
            return graphsum_ring(h, self.ring, g)
        if self.coo is not None:
            if self.push is not None:
                return graphsum_dist_adaptive(h, self.coo, self.send, self.push, g)
            return graphsum_dist(h, *self.coo[3:], send=self.send, group=g)
        if self.slab is None:
            raise ValueError("the mesh GAT's packs carry no GCN aggregation")
        if self.push is not None:
            if self.d is not None:
                return graphsum_dist_hybrid_adaptive_scaled(h, self.d, self.send, self.slab,
                                                            self.res, self.push, g)
            return graphsum_dist_hybrid_adaptive(h, self.send, self.slab, self.res, self.push, g)
        if self.d is not None:
            return graphsum_dist_hybrid_scaled(h, self.d, self.send, self.slab, self.res, g)
        return graphsum_dist_hybrid(h, self.send, self.slab, self.res, g)


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
    col = torch.from_numpy(pcol[r][live].astype(np.int64)).to(device)
    val = torch.from_numpy(pval[r][live].astype(np.float32)).to(device)
    group = dict(
        n_slab=n_slab, seg=segments(slot, n_slab, col, val), col=col, val=val,
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


def rank_graph(sgraph, rank: int, device, sqrt_deg: np.ndarray | None = None,
               group=None) -> RankGraph:
    """Rank ``rank``'s slab of ``sgraph`` (``ShardedGraph``,
    ``HybridShardedGraph`` or ``GATMeshPack``) on ``device``, with its rows
    of ``sqrt_deg`` (``sharded_sqrt_deg``) when given, exchanging over the
    node ``group`` (None: the whole world)."""
    r = rank

    def edges(rows, cols, vals):
        """(row, col, val) of the live edges on the device."""
        live = vals != 0
        return (torch.from_numpy(rows[live].astype(np.int64)).to(device),
                torch.from_numpy(cols[live].astype(np.int64)).to(device),
                torch.from_numpy(vals[live].astype(np.float32)).to(device))

    def row_segments(rows, cols, vals):
        """The live edges' row segments, their columns and values packed."""
        row, col, val = edges(rows, cols, vals)
        return segments(row, sgraph.n_local, col, val)

    def i64(a):
        return torch.from_numpy(a[r].astype(np.int64)).to(device)

    def f32(a):
        return torch.from_numpy(np.asarray(a[r], np.float32)).to(device)

    base = dict(n_dev=sgraph.n_dev, rank=r, n_local=sgraph.n_local, n_buf=sgraph.n_buf,
                send=None if sgraph.send_idx is None else segments(i64(sgraph.send_idx),
                                                                    sgraph.n_local),
                push=_push_group(sgraph, r, device) if getattr(sgraph, "push_slab", 0)
                else None,
                sqrt_deg=None if sqrt_deg is None else f32(sqrt_deg), group=group)
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
        return RankGraph(**base, slab=slab,
                         res=row_segments(sg.res_row[r], sg.res_col[r], sg.res_val[r]),
                         d=None if sg.sym_scale is None else f32(sg.sym_scale))
    if sgraph.ring:
        return RankGraph(**base, ring=tuple(
            row_segments(sgraph.row_local[r, s], sgraph.col[r, s], sgraph.val[r, s])
            for s in range(sgraph.n_dev)))
    row, col, val = edges(sgraph.row_local[r], sgraph.col[r], sgraph.val[r])
    return RankGraph(**base, coo=(row, col, val, segments(row, sgraph.n_local, col, val),
                                  segments(col, sgraph.n_buf, row, val)))


# ---------------------------------------------------------------------------
# distributed aggregation
# ---------------------------------------------------------------------------


def graphsum_dist(x_local, row_seg: Segments, col_seg: Segments,
                  send: Segments | None = None, group=None):
    """Distributed Â·x over row-sharded features, flat COO slab: the source
    buffer (all_gather, or the boundary halo with ``send``, over the node
    ``group``), then ``val·x_buf[col]`` summed into the local rows in edge
    order (``row_seg``, built with col and val), in x's dtype. The backward sums the cotangent by
    buffer row (``col_seg``), then transposes the collective."""
    x_buf = gather_buffer(x_local, send, group)
    return gather_sum_t(x_buf, row_seg, col_seg)


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


def pull_sum(x_buf, slab, res_seg):
    """The pulled and local edges of a tile slab: K3 over the slab against
    the source buffer plus the residual's ordered gather-sum (``res_seg``,
    built with its columns and values), [n_local, F] in x_buf's dtype (K3's
    f32 rounded first, as JAX casts it)."""
    out = bcsr_matmul_rect(slab, x_buf).to(x_buf.dtype)
    return out + gather_sum(x_buf, res_seg)


def push_partials(x_local, push: PushGroup):
    """This rank's partial-sum slab [n_slab, F] in x's dtype: the push
    edges summed by slot in edge order (kernel (a)), then on tile slabs K3
    over the push tiles, rounded to x's dtype and added at their slots
    (kernel (b); each slot takes at most one tile row). JAX rounds both to
    x's dtype before the exchange as well."""
    slab = gather_sum(x_local, push.seg)
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


def ring_step(acc, blk, seg):
    """One step of the ring: the step's slab (``seg``, its row segments with
    its columns and values) summed against the held block in edge order
    (kernel (a), rounded to blk's dtype once), added to the accumulator in
    blk's dtype, as JAX keeps it."""
    part = gather_sum(blk, seg)
    return part if acc is None else acc + part


def _ring_impl(x_local, steps, group=None):
    acc, blk = None, x_local
    for s, seg in enumerate(steps):
        acc = ring_step(acc, blk, seg)
        if s + 1 < len(steps):  # JAX's last rotation only sends blocks home
            blk = ppermute_rows(blk, group)
    return acc


def graphsum_ring(x_local, steps, group=None):
    """Distributed Â·x over the ring halo (JAX ``graphsum_ring``): n_dev
    steps, each the ordered gather-sum of the step's slab against the block
    this rank holds, then the block passed to rank + 1. A rank holds one
    remote block at a time instead of the gathered matrix. ``steps``:
    ``RankGraph.ring``. Self-adjoint."""
    return _SelfAdjoint.apply(x_local, partial(_ring_impl, steps=steps, group=group))


def _adaptive_impl(x_local, coo, send, push, group=None):
    out = gather_sum(buffer_rows(x_local, send, group), coo[3])
    return receive_add(out, all_to_all_rows(push_partials(x_local, push), group), push)


def graphsum_dist_adaptive(x_local, coo, send, push: PushGroup, group=None):
    """Distributed Â·x over flat COO slabs with the adaptive push/pull halo
    (JAX ``graphsum_dist_adaptive``): the pulled and local edges through the
    boundary buffer, the push edges summed on this rank by slot, one
    ``all_to_all`` of the partial rows, the received rows added at their
    local rows in order. ``coo``: ``RankGraph.coo``. Self-adjoint."""
    return _SelfAdjoint.apply(x_local, partial(_adaptive_impl, coo=coo, send=send, push=push,
                                               group=group))


def _hybrid_impl(x_local, send, slab, res_seg, push=None, group=None):
    out = pull_sum(buffer_rows(x_local, send, group), slab, res_seg)
    if push is None:
        return out
    return receive_add(out, all_to_all_rows(push_partials(x_local, push), group), push)


def graphsum_dist_hybrid(x_local, send, slab, res_seg, group=None):
    """Distributed Â·x over a rank's tile slab (K3 rect) plus its COO
    residual summed in edge order (``res_seg``: its segments over the
    rank's rows, built with its columns and values), in x's dtype; ``send``
    None for the all_gather halo. Self-adjoint."""
    return _SelfAdjoint.apply(x_local, partial(_hybrid_impl, send=send, slab=slab,
                                               res_seg=res_seg, group=group))


def graphsum_dist_hybrid_scaled(x_local, d_local, send, slab, res_seg, group=None):
    """``graphsum_dist_hybrid`` for int8 pattern slabs: the slab holds the
    0/k pattern, the residual the multiplicities, ``d_local`` (deg^{-1/2} of
    the rank's rows) the normalization."""
    impl = partial(_hybrid_impl, send=send, slab=slab, res_seg=res_seg, group=group)
    return _SelfAdjoint.apply(x_local, _scaled(impl, d_local))


def graphsum_dist_hybrid_adaptive(x_local, send, slab, res_seg, push: PushGroup, group=None):
    """Distributed Â·x over tile slabs with the adaptive halo (JAX
    ``graphsum_dist_hybrid_adaptive``): the pulled slab as
    ``graphsum_dist_hybrid``, plus the push pairs' partial slab (the push
    residual by slot, K3 over the push tiles) exchanged by one
    ``all_to_all`` and added at its rows in order. Self-adjoint."""
    return _SelfAdjoint.apply(x_local, partial(_hybrid_impl, send=send, slab=slab,
                                               res_seg=res_seg, push=push, group=group))


def graphsum_dist_hybrid_adaptive_scaled(x_local, d_local, send, slab, res_seg,
                                         push: PushGroup, group=None):
    """``graphsum_dist_hybrid_adaptive`` for int8 pattern slabs (JAX
    ``graphsum_dist_hybrid_adaptive_scaled``): d scales the local rows
    before any exchange and the output rows after."""
    impl = partial(_hybrid_impl, send=send, slab=slab, res_seg=res_seg, push=push,
                   group=group)
    return _SelfAdjoint.apply(x_local, _scaled(impl, d_local))


# ---------------------------------------------------------------------------
# tensor parallelism: the feat axis's schedule and weight shards
# ---------------------------------------------------------------------------


def tp_schedule(n_layers: int) -> list[str]:
    """Each layer's kind over the feat axis (JAX ``_tp_schedule``): ``col``,
    W split on its output dim (a replicated input, a feat-sharded output, no
    collective); ``row``, W split on its input dim (a feat-sharded input,
    partial outputs reduced over feat). Alternating, the last layer always
    ``row`` so the logits come out replicated."""
    return ["row" if (i % 2 == 1 or i == n_layers - 1) else "col" for i in range(n_layers)]


def rep_in_schedule(sched: list[str]) -> tuple[list[bool], list[bool]]:
    """(rep_in, gather_after) of a schedule (JAX ``_rep_in_schedule``):
    whether layer l's input is replicated over feat, and whether the column
    all_gather runs after layer l (the next layer is ``col`` and its input
    would be sharded)."""
    rep_in, gather_after, rep = [], [], True
    for i, kind in enumerate(sched):
        rep_in.append(rep)
        last = i == len(sched) - 1
        rep = kind == "row" and last
        gather = not last and sched[i + 1] == "col" and not rep
        gather_after.append(gather)
        if gather:
            rep = True
    return rep_in, gather_after


def validate_tp_dims(input_dim: int, hidden_dims, output_dim: int, tp: int,
                     model: str = "gcn") -> None:
    """Raise ``ValueError`` when a dim cannot be split ``tp`` ways (JAX
    ``validate_tp_dims``, its messages)."""
    if tp <= 1:
        return
    dims = [input_dim, *hidden_dims, output_dim]
    n_layers = len(dims) - 1
    if model == "gin":
        # inner MLP pairs: w1 col-sharded on dims[i+1], w2 row-sharded on the
        # same width; the last layer row-shards its input dims[L-1]
        for i in range(n_layers - 1):
            if dims[i + 1] % tp:
                raise ValueError(f"tp={tp} requires GIN layer {i}'s hidden dim {dims[i + 1]} "
                                 "divisible by tp (Megatron MLP pair)")
        if dims[n_layers - 1] % tp:
            raise ValueError(f"tp={tp} requires the GIN classifier input dim "
                             f"{dims[n_layers - 1]} divisible by tp (row-sharded)")
        return
    # the GCN and SAGE share the alternating schedule
    for i, kind in enumerate(tp_schedule(n_layers)):
        if kind == "col" and dims[i + 1] % tp:
            raise ValueError(f"tp={tp} requires layer {i}'s output dim {dims[i + 1]} "
                             "divisible by tp (column-sharded weight)")
        if kind == "row" and i < n_layers - 1 and dims[i + 1] % tp:
            raise ValueError(f"tp={tp} requires layer {i}'s output dim {dims[i + 1]} "
                             "divisible by tp (reduce_scatter over feat)")
        if kind == "row" and i % 2 == 1 and dims[i] % tp:
            raise ValueError(f"tp={tp} requires layer {i}'s input dim {dims[i]} "
                             "divisible by tp (row-sharded weight)")
    if n_layers == 1 and input_dim % tp:
        raise ValueError(f"tp={tp} with a single layer requires input_dim {input_dim} "
                         "divisible by tp")


def leaf_kinds(n_leaves: int, model: str = "gcn") -> list[str]:
    """The split of each of a family's ``n_leaves`` flat leaves (JAX
    ``_weight_specs``): ``col`` (output dim) or ``row`` (input dim). The GCN
    one leaf a layer on the schedule; SAGE ``[neigh, self]`` both on the
    layer's kind; GIN ``[w1 col, w2 row]`` a layer, the last ``[w1 row]``."""
    if model == "sage":
        return [k for k in tp_schedule(n_leaves // 2) for _ in range(2)]
    if model == "gin":
        return ["col", "row"] * (n_leaves // 2) + ["row"]
    return tp_schedule(n_leaves)


def shard_weights(weights: list[torch.Tensor], tp: int, feat_rank: int,
                  model: str = "gcn") -> list[torch.Tensor]:
    """Feat rank ``feat_rank``'s contiguous slices of a family's full flat
    leaves (weights or Adam moments; JAX ``shard_weights``' addressable
    shards)."""
    if tp <= 1:
        return list(weights)
    return [w.chunk(tp, dim=1 if kind == "col" else 0)[feat_rank].contiguous()
            for w, kind in zip(weights, leaf_kinds(len(weights), model), strict=True)]


def gather_weights(shards: list[torch.Tensor], feat, model: str = "gcn") -> list[torch.Tensor]:
    """The inverse of ``shard_weights`` over the feat ranks of ``feat`` (a
    ``collectives.FeatGroup``): every leaf's full array, on every feat
    rank."""
    with torch.no_grad():
        return [feat.all_gather_cols(w.detach()) if kind == "col"
                else feat.all_gather_rows(w.detach())
                for w, kind in zip(shards, leaf_kinds(len(shards), model), strict=True)]


# ---------------------------------------------------------------------------
# the mesh models: the single-card models over a rank's slab
# ---------------------------------------------------------------------------


class _OnSlab:
    """A single-card model's aggregation on the rank's slab, in h's dtype,
    and its tensor-parallel frame: ``feat`` (a ``collectives.FeatGroup``,
    or an object with its methods) makes the model one feat rank of a
    ``tp``-way grid over shards of its weights; None is ``tp`` 1."""

    def __init__(self, *args, feat=None, **kw):
        super().__init__(*args, **kw)
        self.feat = feat if feat is not None and feat.size > 1 else None
        self.sched = tp_schedule(self.n_layers)
        self.rep_in, self.gather_after = rep_in_schedule(self.sched)

    def aggregate(self, h: torch.Tensor, graph: RankGraph) -> torch.Tensor:
        return graph.aggregate(h).to(h.dtype)

    def feat_sharded_inputs(self) -> list[bool]:
        """Per layer, whether its input is feat-sharded, so its dropout mask
        is drawn per feat rank (JAX ``_keys``); replicated inputs share the
        mask across feat."""
        if self.feat is None:
            return [False] * self.n_layers
        return [not r for r in self.rep_in]

    def _piece(self, fn, *args, training: bool):
        """``fn(*args)``, recomputed in the backward when training with
        ``remat``: a TP layer checkpoints its pieces between its feat
        collectives, never across one, so the recompute re-runs none of them
        (JAX's ``_TP_SAVE`` policy)."""
        if self.remat and training:
            return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)
        return fn(*args)

    def slice_in(self, h: torch.Tensor, layer: int) -> torch.Tensor:
        """A ``row`` layer's replicated input cut to this feat rank's column
        block, the rows of its weight shard (after the dropout of the full
        input); any other input whole."""
        if self.feat is None or self.sched[layer] != "row" or not self.rep_in[layer]:
            return h
        width = h.shape[1] // self.feat.size
        j = self.feat.rank
        return h[:, j * width:(j + 1) * width]

    def between_layers(self, h: torch.Tensor, layer: int) -> torch.Tensor:
        """The column all_gather after layer ``layer`` where ``gather_after``
        says."""
        if self.feat is not None and self.gather_after[layer]:
            return self.feat.gather_cols(h)
        return h

    def _reduce(self, partial_out: torch.Tensor, layer: int) -> torch.Tensor:
        """A row layer's partial product summed over feat: replicated for the
        last layer (``psum``), else this rank's column block
        (``psum_scatter``)."""
        if layer == self.n_layers - 1:
            return self.feat.psum(partial_out)
        return self.feat.psum_scatter(partial_out)

    def stack_reduce(self, stacked: torch.Tensor) -> torch.Tensor:
        """The deferred-eval epoch's stacked [train | val] partial logits
        summed over feat in one collective (no autograd: its transpose is
        the identity)."""
        return stacked if self.feat is None else self.feat.all_reduce(stacked)


class MeshGCN(_OnSlab, GCNModel):
    """The GCN forward with every aggregation on the rank's slab (the JAX
    mesh forward: dropout → X·W → Â·(·) → ReLU, residual as on one card).

    With ``feat`` (tensor parallelism, JAX ``forward_tp``): a ``col`` layer
    multiplies its replicated input by its column shard and aggregates the
    1/tp-wide result; a ``row`` layer (slicing a replicated input) gives a
    partial product, ``psum_scatter`` (the last: ``psum``) sums it over
    feat, then the aggregation; the column all_gather runs where
    ``gather_after`` says. Â·H is column-independent, so every aggregation
    but the last layer's runs at 1/tp of the width. The deferred ReLU stays
    fused into K2 (ReLU commutes with the column gather)."""

    def layer(self, h, graph, layer: int, seed, training: bool, skip_agg: bool):
        if self.feat is None:
            return super().layer(h, graph, layer, seed, training, skip_agg)
        pre_relu = self.defers_relu(layer)
        if self.sched[layer] == "col":  # no feat collective: one piece
            return self._piece(self._layer, h, graph, layer, seed, training, skip_agg,
                               training=training)
        part = self._piece(self.layer_pre, h, layer, seed, training, pre_relu,
                           training=training)
        h = self._reduce(part, layer)
        if skip_agg:
            return h
        return self._piece(self.aggregate, h, graph, training=training)


class MeshSAGE(_OnSlab, SAGEModel):
    """SAGE over the rank's slab (JAX ``forward_agg_variant``): the mean
    rewrite scales the rank's rows by ``RankGraph.sqrt_deg`` before the
    exchange. With ``feat``, both of a layer's weights take the GCN's
    col/row schedule: a ``col`` layer is the single-card layer on its column
    shards; a ``row`` layer sums each product over feat before the
    neighbour mean of the shard."""

    def run_layer(self, h, layer: int, seed, training: bool, pre_relu: bool, graph):
        if self.feat is None or self.sched[layer] == "col":
            return super().run_layer(h, layer, seed, training, pre_relu, graph)
        w = self.layer_weights(layer)
        dtype = self.compute_dtype

        def products(h):
            h = self._entry(h, layer, seed, training, pre_relu)
            h = self.slice_in(h, layer)
            return feature_transform(h, w["self"], dtype), feature_transform(h, w["neigh"], dtype)

        ps, pn = self._piece(products, h, training=training)
        ps, pn = self._reduce(ps, layer), self._reduce(pn, layer)
        return self._piece(lambda ps, pn: ps + self.mean_agg(pn, graph).to(dtype), ps, pn,
                           training=training)


class MeshGIN(_OnSlab, GINModel):
    """GIN over the rank's slab, as ``MeshSAGE``, with the sum rewrite. With
    ``feat`` every layer aggregates its replicated input on each feat rank,
    then runs its MLP as a Megatron pair (w1 col → ReLU → w2 row; the last
    layer's slice into its row-sharded w1), the partial output summed over
    feat (``psum``). From layer 1 on the layer's input takes a gradient, so
    ``copy_in`` (Megatron's f) sums its partial cotangents over feat."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        # every layer's input is replicated (its dropout mask shared across
        # feat) and no column gather runs; only the last layer slices it
        L = self.n_layers
        self.sched = ["col"] * (L - 1) + ["row"]
        self.rep_in, self.gather_after = [True] * L, [False] * L

    def run_layer(self, h, layer: int, seed, training: bool, pre_relu: bool, graph):
        if self.feat is None:
            return super().run_layer(h, layer, seed, training, pre_relu, graph)
        w = self.layer_weights(layer)
        dtype = self.compute_dtype

        def body(h):
            h = self._entry(h, layer, seed, training, pre_relu)
            z = self.eps * h + self.sum_agg(h, graph).to(dtype)
            if layer > 0:
                z = self.feat.copy_in(z)
            if "w2" in w:
                z = feature_transform(z, w["w1"], dtype)
                return feature_transform(torch.relu(z), w["w2"], dtype)
            return feature_transform(self.slice_in(z, layer), w["w1"], dtype)

        return self.feat.psum(self._piece(body, h, training=training))


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
        buf = gather_buffer(torch.cat([hw3.reshape(n, H * D), t], dim=1), graph.send,
                            graph.group)
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


# salts the feat index's derivation apart from the node rank's
_FEAT_SALT = 0x5EED_FEA7_0000_0001


def rank_seeds(seeds: list[int], rank: int, attention: bool = False, feat_rank: int = 0,
               sharded: list[bool] | None = None) -> list[int]:
    """The epoch's dropout seeds for node rank ``rank``: unchanged on rank 0;
    ``splitmix64(splitmix64(seed) ^ rank)`` reduced to the seed's range on
    the others. With ``attention`` (GAT) the odd entries are int32 attention
    seeds. Tensor parallelism: on feat rank ``feat_rank`` > 0 the seed of
    each layer whose input is feat-sharded (``sharded``, one flag a layer)
    is derived once more, ``splitmix64(splitmix64(seed ^ salt) ^
    feat_rank)``, so the feat ranks' masks form one mask over the full
    width; a replicated input keeps the node rank's seed, so its mask is
    the same on every feat rank (JAX ``_keys`` folds the feat index into the
    key of exactly those layers)."""
    highs = [(_ATTN_SEED_HIGH if attention and i % 2 else _SEED_HIGH)
             for i in range(len(seeds))]
    out = list(seeds) if rank == 0 else [_mix64(_mix64(s) ^ rank) % hi
                                         for s, hi in zip(seeds, highs)]
    if feat_rank and sharded:
        out = [_mix64(_mix64(s ^ _FEAT_SALT) ^ feat_rank) % hi if sharded[i] else s
               for i, (s, hi) in enumerate(zip(out, highs))]
    return out


def build_mesh_model(cfg: Config, sgraph, weights: list[torch.Tensor],
                     device, feat=None) -> MeshGCN | MeshGAT | MeshSAGE | MeshGIN:
    """The mesh model of ``cfg`` with a copy of ``weights`` (float32, the
    family's full leaves in JAX leaf order) on ``device``; training leaves
    the caller's tensors alone. With ``feat`` (a ``collectives.FeatGroup``
    of more than one rank, or an object with its methods) the model holds
    feat rank ``feat.rank``'s shards (``shard_weights``)."""
    tp = 1 if feat is None else feat.size
    if tp > 1:
        weights = shard_weights(weights, tp, feat.rank, cfg.gcn.model)
    weights = [w.detach().to(device, torch.float32, copy=True) for w in weights]
    common = dict(compute_dtype=cfg.tpu.compute_dtype, residual=cfg.gcn.residual,
                  remat=cfg.gcn.remat)
    if cfg.gcn.model == "gat":  # tp 1 (_check_config)
        return MeshGAT(weights, cfg.gcn.dropouts, heads=cfg.gcn.heads,
                       attn_dropout=cfg.gcn.attn_dropout,
                       backend="tile" if isinstance(sgraph, GATMeshPack) else "segment",
                       edge_chunk=cfg.tpu.edge_chunk, **common)
    if cfg.gcn.model == "sage":
        return MeshSAGE(weights, cfg.gcn.dropouts, feat=feat, **common)
    if cfg.gcn.model == "gin":
        return MeshGIN(weights, cfg.gcn.dropouts, gin_eps=cfg.gcn.gin_eps, feat=feat, **common)
    # the fused dropout⊗matmul (K10) does not apply under tp (fit_parallel's note)
    return MeshGCN(weights, cfg.gcn.dropouts, feat=feat,
                   fuse_dropout_matmul=cfg.tpu.fuse_dropout_matmul and tp == 1, **common)


# ---------------------------------------------------------------------------
# epoch step, eval, input pre-aggregation
# ---------------------------------------------------------------------------


def _global_ce(logits, labels, mask, num_samples, group=None):
    """(loss, accuracy) of the whole world from this rank's rows: the local
    sums of ``ops.loss`` reduced over the node ``group`` (the feat ranks
    hold the same replicated logits), divided by the split's size."""
    sums = all_reduce_sum(torch.stack(masked_softmax_xent_sums(logits, labels, mask)), group)
    return sums[0] / float(num_samples), sums[1] / float(num_samples)


def _feat_sum(model, t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the feat ranks (tensor parallelism), else ``t``:
    the partial Σw² of the decayed leaf's shard (JAX ``_pen``'s psum over
    feat)."""
    feat = getattr(model, "feat", None)
    return t if feat is None else feat.all_reduce(t)


def make_parallel_epoch_step(cfg: Config, model, graph: RankGraph, data: RankData,
                             split_counts: dict, x_train=None, x_eval=None):
    """One-epoch function ``(opt_state, seeds) -> metrics[4]`` (train_loss,
    train_acc, val_loss, val_acc; the same on every rank). ``seeds`` are
    this rank's (``rank_seeds``). The local loss's gradient, its sum over
    the node ranks (one ``all_reduce`` with the train metrics' sums), Adam
    in place, then the val eval on the updated weights; under tensor
    parallelism one feat ``all_reduce`` of the pre- and post-update Σw².
    ``x_train`` / ``x_eval``: the rank's Â·X (``make_preagg_fn``), and
    layer 0 of the train / val forward skips its aggregation."""
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
        grads, sums = _reduce_grads(weights, grads, torch.stack([loss_sum.detach(), correct]),
                                    graph.group)
        with torch.no_grad():
            l2_pre = l2_penalty(weights[0])  # the L2 term of the PRE-update W0
        adam_step(weights, grads, opt_state, learning_rate=adam.learning_rate,
                  weight_decay=wd, beta1=adam.beta1, beta2=adam.beta2, eps=adam.eps)
        with torch.no_grad():
            val_ce, val_acc = _global_ce(
                model(x_ev, graph, training=False, input_preagg=x_eval is not None),
                data.labels, val_mask, n_val, graph.group)
            l2 = _feat_sum(model, torch.stack([l2_pre, l2_penalty(weights[0])]))
            return torch.stack([sums[0] / float(n_train) + l2_term(wd, l2[0]),
                                sums[1] / float(n_train), val_ce + l2_term(wd, l2[1]), val_acc])

    return step


def make_parallel_deferred_step(cfg: Config, model: MeshGCN, graph: RankGraph,
                                data: RankData, split_counts: dict, x_train=None,
                                x_eval=None):
    """The mesh GCN's deferred-eval epoch (``train.fused_deferred_forward``
    over the rank's slab: one last-layer aggregation, one collective, for
    the train and the val halves; under tensor parallelism one feat
    ``all_reduce`` of both halves' partial logits, JAX
    ``forward_stacked_tp``): ``(opt_state, seeds) -> metrics[4]``, this
    epoch's train loss and accuracy and the val loss and accuracy of the
    weights it started from. One ``all_reduce`` over the node ranks carries
    the local gradients and both halves' sums."""
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
        grads, sums = _reduce_grads(weights, grads, sums, graph.group)
        with torch.no_grad():
            # the L2 term of the PRE-update W0, which the val half also ran on
            pen = l2_term(wd, _feat_sum(model, l2_penalty(weights[0])))
            metrics = torch.stack([sums[0] / float(n_train) + pen, sums[1] / float(n_train),
                                   sums[2] / float(n_val) + pen, sums[3] / float(n_val)])
        adam_step(weights, grads, opt_state, learning_rate=adam.learning_rate,
                  weight_decay=wd, beta1=adam.beta1, beta2=adam.beta2, eps=adam.eps)
        return metrics

    return step


def _reduce_grads(weights, grads, sums, group=None):
    """One ``all_reduce`` over the node ``group`` of the local gradients and
    the metric ``sums``: (the gradients of the world's loss shaped like
    ``weights``, the world's sums). Under tensor parallelism each feat rank
    reduces its own shards' gradients: a sum over the whole world would
    multiply the sums by tp."""
    flat = all_reduce_sum(torch.cat([g.reshape(-1).float() for g in grads] + [sums]), group)
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
                                 data.labels, mask, split_counts[split], graph.group)
            l2 = _feat_sum(model, l2_penalty(model.weights[0]))
            return ce + l2_term(cfg.adam.weight_decay, l2), acc

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
    """The JAX package's config errors (``fit_parallel``): among them, the
    GAT takes no tensor parallelism (its per-destination softmax stays
    device-local; ``tp`` is for the GCN, SAGE and GIN)."""
    gat = cfg.gcn.model == "gat"
    tiles = cfg.tpu.backend in ("hybrid", "bcsr")
    if gat and (halo in ("ring", "adaptive") or cfg.tpu.tp > 1):
        raise ValueError(
            "model=gat over the mesh supports the flat COO partition or the gat_mesh_pack "
            "tile partition, with the all_gather or boundary halo — set "
            "halo=all_gather|boundary, tp=1")
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
    slab, rows and model, the splits' global sizes and the rank's place in
    the (nodes, feat) grid."""

    sgraph: ShardedGraph | HybridShardedGraph | GATMeshPack
    graph: RankGraph
    data: RankData
    model: MeshGCN | MeshGAT | MeshSAGE | MeshGIN
    split_counts: dict
    grid: collectives.Grid | None = None

    def seeds(self, seeds: list[int], attention: bool = False) -> list[int]:
        """This rank's share of an epoch's seeds (``rank_seeds``)."""
        model = self.model
        feat = getattr(model, "feat", None)
        if feat is None:
            return rank_seeds(seeds, self.graph.rank, attention)
        return rank_seeds(seeds, self.graph.rank, attention, feat.rank,
                          model.feat_sharded_inputs())


def build_rank(cfg: Config, ds, rank: int, n_devices: int, halo: str, device,
               weights: list[torch.Tensor] | None = None,
               grid: collectives.Grid | None = None) -> RankRun:
    """Node rank ``rank``'s share of a run of ``cfg`` over ``n_devices``
    node ranks on ``device``; ``weights`` (float32, the family's full leaves
    in JAX leaf order) or the Glorot init from ``cfg.tpu.seed``; ``grid``
    (``collectives.grid``) the node group the exchanges run over and, under
    tensor parallelism, the feat rank whose shards the model holds. Sets the
    matmul precision."""
    sgraph = partition_for(cfg, ds, n_devices, halo)
    if weights is None:
        weights = init_weights(cfg, ds.input_dim, ds.output_dim)
    set_matmul_precision(cfg.tpu.matmul_precision)
    sdeg = sharded_sqrt_deg(ds, sgraph) if cfg.gcn.model in ("sage", "gin") else None
    group = None if grid is None else grid.node_group
    return RankRun(
        sgraph=sgraph, graph=rank_graph(sgraph, rank, device, sdeg, group),
        data=rank_data(ds, sgraph, rank, device),
        model=build_mesh_model(cfg, sgraph, weights, device,
                               None if grid is None else grid.feat),
        split_counts={s: int((ds.split == s).sum()) for s in (TRAIN, VAL, TEST)},
        grid=grid,
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
    table = seed_table([run.seeds(epoch_seeds(gen, model.n_layers, attention=gat), gat)
                        for _ in range(epochs)], data.x.device)
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
    split. Call it on every rank of a world of ``n_devices × cfg.tpu.tp``
    processes (torchrun; ``n_devices`` defaults to the world's size over
    ``tp``), or with ``n_devices`` 1, ``tp`` 1 and no world (a world of one is
    started). ``halo``: ``all_gather``, ``boundary``, ``adaptive`` or
    ``ring`` (default ``cfg.tpu.halo``). ``weights`` (float32, the family's
    full leaves in JAX leaf order) replace the Glorot init from
    ``cfg.tpu.seed``; ``resume_from`` and the checkpoint options as
    ``train.fit`` takes them (under tensor parallelism the files hold full
    arrays: gathered over feat to write, sliced on resume). The history,
    losses and accuracies are the whole world's, equal on every rank, and so
    are the result's weights (full arrays); only rank 0 prints."""
    halo = halo or cfg.tpu.halo
    _check_config(cfg, halo)
    tp = max(cfg.tpu.tp, 1)
    device = collectives.local_device(
        device if isinstance(device, torch.device) else resolve_device(device))
    if n_devices is None:
        n_devices = cfg.tpu.n_devices or max(
            (torch.distributed.get_world_size() if torch.distributed.is_initialized() else 1)
            // tp, 1)
    verbose = cfg.train.verbose if verbose is None else verbose
    gat = cfg.gcn.model == "gat"
    with collectives.world(n_devices, device, tp) as (rank, _):
        validate_tp_dims(ds.input_dim, cfg.gcn.hidden_dims, ds.output_dim, tp, cfg.gcn.model)
        grid = collectives.grid(n_devices, tp)
        verbose = verbose and rank == 0
        ck, weights, start, seed = resume_state(resume_from, weights, cfg.tpu.seed, "cpu",
                                                verbose)
        run = build_rank(cfg, ds, grid.node_rank, n_devices, halo, device, weights, grid)
        sgraph, model = run.sgraph, run.model
        opt_state = resumed_adam(ck, list(model.weights))
        if ck is not None and tp > 1:  # the file's moments are full arrays
            opt_state.m, opt_state.v = (shard_weights(list(t), tp, grid.feat_rank,
                                                      cfg.gcn.model)
                                        for t in (opt_state.m, opt_state.v))
        if verbose:
            print(f"mesh: {n_devices} rank(s), halo={halo_of(sgraph)}, "
                  f"n_local={sgraph.n_local}, n_buf={sgraph.n_buf}, device {device}")
            if tp > 1:
                print(f"tp: {tp} feat ranks a node rank ({n_devices * tp} processes), layer "
                      f"kinds {model.sched}, rank 0's weight shards "
                      f"{[list(w.shape) for w in model.weights]}")
                if cfg.tpu.fuse_dropout_matmul and cfg.gcn.model == "gcn":
                    print("note: fuse_dropout_matmul does not apply under tp > 1 (the JAX "
                          "package's TP forward has no fused layer) — ignored")

        def full_state():
            """(full weights, Adam state with full moments), on every rank."""
            gather = partial(gather_weights, feat=grid.feat, model=cfg.gcn.model)
            return gather(list(model.weights)), AdamState(
                step=opt_state.step, m=gather(list(opt_state.m)), v=gather(list(opt_state.v)))

        x_train, x_eval = preagg_inputs(cfg, run)
        test_fn = make_parallel_eval_fn(cfg, model, run.graph, run.data, run.split_counts,
                                        TEST, x_eval=x_eval, preagg=x_eval is not None)
        gen = torch.Generator().manual_seed(seed)
        skip_epochs(gen, start, model.n_layers, gat)
        ckpt_s: list = []
        save = checkpoint_writer(cfg, model, opt_state, seed, ckpt_s, write=rank == 0,
                                 barrier=torch.distributed.barrier,
                                 gather=full_state if tp > 1 else None, verbose=verbose)
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
                lambda: run.seeds(epoch_seeds(gen, model.n_layers, attention=gat), gat),
                device, verbose, start, save)
            total = time.perf_counter() - t0
        if save is not None:
            save("ckpt_final.npz", start + epochs_run)
        test_loss, test_acc = (float(v) for v in test_fn())
        if verbose:
            print(f"test_loss={test_loss:.5f} test_acc={test_acc:.5f}")
            print(f"total time: {total:.5f}")
        result = fit_result(model, history, epochs_run, test_loss, test_acc, total, scan,
                            start_epoch=start, checkpoint_s=ckpt_s)
        if tp > 1:
            result.weights = [w.detach() for w in full_state()[0]]
    return result
