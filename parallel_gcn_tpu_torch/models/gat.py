"""Graph Attention Network (Veličković et al., arXiv:1710.10903).

Port of ``parallel_gcn_tpu/models/gat.py``. Per layer:

    e_ij = LeakyReLU(a_srcᵀ(W h_i) + a_dstᵀ(W h_j))      edge logits
    α_ij = softmax_j(e_ij)   over j ∈ N(i) ∪ {i}         per-dest softmax
    h_i' = ELU(‖_k Σ_j α_ij^k (W^k h_j))                  heads concatenated
    last layer: heads averaged, no nonlinearity (logits)

Three aggregation backends, as in the JAX package:

- ``dense``: the masked [heads, N, N] softmax and one batched product
  (citation-scale graphs with a dense adjacency);
- ``segment``: per-edge logits on the padded COO triplets with a
  scatter-max / exp / segment-sum softmax; the sums by destination, and
  the gathers' gradients by source, are the ordered sums of
  ``ops.cuda_segment`` over the graph's ``row_seg`` and ``col_seg``. With
  ``edge_chunk`` the softmax streams over chunks of edges
  (``attend_chunked``, JAX ``_attend_segment_chunked``), so no per-edge
  tensor of more than one chunk exists;
- ``tile``: the block-sparse tile attention of ``ops.tile_attention`` over
  the graph's tile pack plus its COO residual (K5 forward, K6 backward on
  the card): the reddit-scale path.

Parameters are one flat ``nn.ParameterList`` in the JAX package's leaf order
(``jax.tree.leaves`` sorts each layer's dict keys): ``[W_0, a_dst_0,
a_src_0, W_1, ...]``, so the trainer's Adam (decaying leaf 0) and its L2 term
on ``weights[0]`` apply to W_0 unchanged. Feature dropout is K1
(``ops.cuda_dropout.dropout``, the port's Philox stream; the JAX package
uses threefry). Attention dropout takes its own seed per layer: on the tile
backend an int32 for the hash mask, elsewhere K1 on the attention weights.
With ``remat`` each training layer is recomputed in the backward
(``torch.utils.checkpoint``, JAX's ``jax.checkpoint``), its masks redrawn
from the same seed slots, no RNG state stashed.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from parallel_gcn_tpu_torch.data.graph import Graph, pad_to_multiple
from parallel_gcn_tpu_torch.device import torch_dtype
from parallel_gcn_tpu_torch.models.gcn import glorot
from parallel_gcn_tpu_torch.ops.cuda_dropout import dropout
from parallel_gcn_tpu_torch.ops.cuda_segment import Segments, gather, segment_sum, segments
from parallel_gcn_tpu_torch.ops.sparse_matmul import feature_transform
from parallel_gcn_tpu_torch.ops.tile_attention import gat_attend_tiles

LEAKY_SLOPE = 0.2  # paper §2.1
_NEG = -1e9  # masked-logit fill; finite so empty softmax rows stay finite
# a layer's keys in JAX's leaf order (sorted): the port's leaves a layer
LAYER_KEYS = ("W", "a_dst", "a_src")
LEAVES_PER_LAYER = len(LAYER_KEYS)


def init_gat_params(
    generator: torch.Generator, input_dim: int, hidden_dims: Sequence[int],
    output_dim: int, heads: int,
) -> list[torch.Tensor]:
    """Glorot-uniform float32 parameters in leaf order ``[W, a_dst, a_src]``
    per layer. ``hidden_dims`` are per-head widths; hidden layers concatenate
    heads, the last layer averages ``output_dim``-wide heads."""
    dims_in = [input_dim] + [heads * d for d in hidden_dims]
    dims_out = list(hidden_dims) + [output_dim]
    out = []
    for f_in, d in zip(dims_in, dims_out):
        w = glorot(generator, f_in, heads * d)
        a_src = glorot(generator, heads, d)
        a_dst = glorot(generator, heads, d)
        out += [w, a_dst, a_src]
    return out


def _edge_softmax_segment(graph: Graph, s, t, n_nodes: int) -> torch.Tensor:
    """Attention weights α [E, heads] over the padded COO triplets; padding
    edges (val == 0) get weight 0. The max is detached: softmax does not
    depend on it, so its gradient contributions cancel. ``graph`` carries
    ``row_seg`` (over s's n_nodes rows) and ``col_seg`` (over t's)."""
    live = (graph.val != 0.0)[:, None]
    e = torch.where(live, F.leaky_relu(gather(s, graph.row_seg) + gather(t, graph.col_seg),
                                       LEAKY_SLOPE), _NEG)
    m = torch.full((n_nodes, e.shape[1]), _NEG, dtype=e.dtype, device=e.device)
    # a max is exact in any order
    m = m.scatter_reduce(0, graph.row[:, None].expand_as(e), e.detach(), "amax",
                         include_self=True)
    w = torch.where(live, torch.exp(e - m[graph.row]), 0.0)
    # f32 denominator: a bf16 sum loses per-edge increments on hub rows
    den = segment_sum(w.float(), graph.row_seg)
    return w / gather(torch.clamp(den, min=1e-16), graph.row_seg).to(w.dtype)


@dataclass(frozen=True)
class EdgeChunk:
    """Edges ``start`` to ``start + len(row)`` of a COO slab: destination
    rows, source rows, the live mask [c, 1] (val ≠ 0), and the ordered
    sums' ``Segments`` of each over its rows."""

    start: int
    row: torch.Tensor
    live: torch.Tensor
    row_seg: Segments
    col_seg: Segments


def edge_chunks(row, col, val, n_dst: int, n_src: int, chunk: int) -> tuple:
    """The ``EdgeChunk`` s of a COO slab, ``chunk`` edges each rounded up to
    a multiple of 4 (so that each chunk's attention-dropout offset, start ×
    heads, lies on a whole Philox counter); the last takes the rest. Builds
    ``Segments`` (host reads): call it with the graph, not in an epoch."""
    chunk = pad_to_multiple(chunk, 4)
    out = []
    for start in range(0, row.shape[0], chunk):
        r, c = row[start : start + chunk], col[start : start + chunk]
        out.append(EdgeChunk(start=start, row=r.long(),
                             live=(val[start : start + chunk] != 0.0)[:, None],
                             row_seg=segments(r, n_dst), col_seg=segments(c, n_src)))
    return tuple(out)


def _chunk_logits(ch: EdgeChunk, s, t):
    e = F.leaky_relu(gather(s, ch.row_seg) + gather(t, ch.col_seg), LEAKY_SLOPE)
    return torch.where(ch.live, e, _NEG)


def _chunk_step(num, den, s, t, hw, m, ch: EdgeChunk, seed, rate: float):
    """(num, den) plus one chunk's terms: the exp weights' sum by
    destination and their (dropped) products with the source rows, f32."""
    w = torch.where(ch.live, torch.exp(_chunk_logits(ch, s, t) - m[ch.row]), 0.0)
    den = den + segment_sum(w.float(), ch.row_seg)
    if rate > 0.0:
        # this chunk's slice of the unchunked [E, heads] mask
        w = dropout(w.contiguous(), seed, rate, offset=ch.start * w.shape[1])
    contrib = (w[:, :, None] * gather(hw, ch.col_seg)).float()
    return num + segment_sum(contrib, ch.row_seg), den


def attend_chunked(chunks: tuple, s, t, hw, seed=None, rate: float = 0.0):
    """Streaming edge softmax and aggregation over ``chunks``
    (``edge_chunks``), the JAX ``_attend_segment_chunked``: pass 1 takes the
    running segment max (``scatter_reduce`` amax, exact in any order,
    detached: softmax does not depend on it); pass 2 adds each chunk's
    exp weights into the f32 denominator [n, heads] and their products with
    the gathered sources into the f32 numerator [n, heads, d] with the
    ordered sums, and divides once. Attention dropout drops the
    numerator's terms with each chunk's slice of the unchunked path's mask
    (K1's element offset), so the result is the unchunked attention's at
    any rate. Each chunk is recomputed in the backward
    (``torch.utils.checkpoint``, no RNG state): only the O(n) carries are
    kept. ``s`` [n, heads] destination terms, ``t`` and ``hw`` [n_src, heads(, d)]
    source terms; returns [n, heads, d] in hw's dtype."""
    n, heads = s.shape
    with torch.no_grad():
        m = torch.full((n, heads), _NEG, dtype=s.dtype, device=s.device)
        for ch in chunks:
            e = _chunk_logits(ch, s, t)
            m.scatter_reduce_(0, ch.row[:, None].expand_as(e), e, "amax", include_self=True)
    num = torch.zeros((n, heads, hw.shape[2]), dtype=torch.float32, device=s.device)
    den = torch.zeros((n, heads), dtype=torch.float32, device=s.device)
    for ch in chunks:
        num, den = checkpoint(_chunk_step, num, den, s, t, hw, m, ch, seed, rate,
                              use_reentrant=False, preserve_rng_state=False)
    return (num / torch.clamp(den, min=1e-16)[:, :, None]).to(hw.dtype)


class GATModel(nn.Module):
    """The GAT forward with its parameters (``self.weights``, float32, JAX
    leaf order). ``backend`` ∈ {dense, segment, tile}."""

    input_preagg = False  # the trainer's contract: GAT has no Â·X rewrite
    # attention weights differ between the train and the val forward, so the
    # two cannot share one last aggregation (train.fused_deferred_forward)
    supports_deferred_eval = False

    def __init__(
        self,
        params: list[torch.Tensor],
        dropouts: Sequence[float],
        *,
        heads: int,
        attn_dropout: float = 0.0,
        backend: str = "dense",
        compute_dtype: str = "float32",
        residual: bool = False,
        remat: bool = False,
        edge_chunk: int = 0,
    ):
        super().__init__()
        if len(params) % LEAVES_PER_LAYER or len(dropouts) * LEAVES_PER_LAYER != len(params):
            raise ValueError(f"need {LEAVES_PER_LAYER} params and one dropout per "
                             f"layer, got {len(params)} params, dropouts {dropouts}")
        if backend not in ("dense", "segment", "tile"):
            raise ValueError(f"GAT backend must be dense|segment|tile, got {backend!r}")
        self.weights = nn.ParameterList(
            [nn.Parameter(p.float().contiguous()) for p in params]
        )
        self.dropouts = tuple(float(d) for d in dropouts)
        self.heads = heads
        self.attn_dropout = float(attn_dropout)
        self.backend = backend
        self.compute_dtype = torch_dtype(compute_dtype)
        self.residual = residual
        self.remat = remat
        self.edge_chunk = int(edge_chunk)
        self._chunks: dict = {}  # the edge chunks of each slab seen, built once
        self.layer_keys = [LAYER_KEYS] * len(dropouts)

    @property
    def n_layers(self) -> int:
        return len(self.weights) // LEAVES_PER_LAYER

    def _attend_dense(self, graph, hw3, s, t, seed, training):
        mask = (graph.adj > 0)[None]  # [1, N, N]
        e = F.leaky_relu(s.T[:, :, None] + t.T[:, None, :], LEAKY_SLOPE)  # [heads, N, N]
        a = torch.softmax(torch.where(mask, e, _NEG), dim=-1)
        if training and self.attn_dropout > 0.0:
            a = dropout(a.contiguous(), seed, self.attn_dropout)
        return torch.einsum("hij,jhd->ihd", a, hw3)

    def chunks_of(self, row, col, val, n_dst: int, n_src: int):
        """The ``edge_chunks`` of a COO slab when ``edge_chunk`` is set and
        shorter than the slab, else None; built at the first call with
        that slab (the first epoch runs eagerly, before any capture)."""
        if not self.edge_chunk or self.edge_chunk >= row.shape[0]:
            return None
        key = (row.data_ptr(), row.shape[0], n_dst, n_src)
        if key not in self._chunks:
            self._chunks[key] = edge_chunks(row, col, val, n_dst, n_src, self.edge_chunk)
        return self._chunks[key]

    def _attend_segment(self, graph, hw3, s, t, seed, training):
        n = hw3.shape[0]
        chunks = self.chunks_of(graph.row, graph.col, graph.val, n, n)
        if chunks is not None:
            rate = self.attn_dropout if training else 0.0
            return attend_chunked(chunks, s, t, hw3, seed, rate)
        alpha = _edge_softmax_segment(graph, s, t, hw3.shape[0])
        if training and self.attn_dropout > 0.0:
            alpha = dropout(alpha.contiguous(), seed, self.attn_dropout)
        contrib = (alpha[:, :, None] * gather(hw3, graph.col_seg)).float()
        return segment_sum(contrib, graph.row_seg).to(hw3.dtype)

    def _attend_tile(self, graph, hw3, s, t, seed, training):
        rate = self.attn_dropout if training else 0.0
        return gat_attend_tiles(
            graph, s, t, hw3, slope=LEAKY_SLOPE, attn_dropout=rate,
            seed=seed if rate > 0.0 else None,
        ).to(hw3.dtype)

    def _check_graph(self, graph: Graph) -> None:
        if self.backend == "dense" and graph.adj is None:
            raise ValueError("GAT dense backend needs the dense adjacency; "
                             "use backend=segment otherwise")
        if self.backend == "tile" and graph.bcsr is None:
            raise ValueError("GAT tile backend needs a bcsr/hybrid-built graph")
        if self.backend == "segment" and not graph.coo_complete:
            raise ValueError("GAT segment backend needs complete COO triplets "
                             "(tile-only hybrid packs carry no per-edge list)")

    def forward(
        self,
        x: torch.Tensor,
        graph: Graph,
        *,
        training: bool,
        seeds: Sequence[int] | None = None,
        input_preagg: bool | None = None,
    ) -> torch.Tensor:
        """Logits [n_nodes, output_dim] float32. ``seeds`` holds two seeds per
        layer, ``[feature_0, attention_0, feature_1, ...]`` (needed when
        training with a nonzero rate); attention seeds are int32."""
        if input_preagg:
            raise ValueError("GAT has no loop-invariant first aggregation")
        self._check_graph(graph)
        L = self.n_layers
        if training and (any(d > 0 for d in self.dropouts) or self.attn_dropout > 0):
            if seeds is None or len(seeds) != 2 * L:
                raise ValueError(f"a training forward with dropout needs {2 * L} seeds")
        seeds = list(seeds) if seeds is not None else [None] * (2 * L)
        h = x.to(self.compute_dtype)
        prev = None
        for layer in range(L):
            args = (h, graph, layer, seeds[2 * layer], seeds[2 * layer + 1], training)
            if self.remat and training:
                h = checkpoint(self._layer, *args, use_reentrant=False,
                               preserve_rng_state=False)
            else:
                h = self._layer(*args)
            if layer == L - 1:
                break
            if self.residual and prev is not None and prev.shape == h.shape:
                h = h + prev
            h = F.elu(h)
            prev = h
        return h.float()

    def _layer(self, h, graph, layer: int, seed, attn_seed, training: bool):
        """One layer before its residual and ELU: dropout, transform,
        attention; heads concatenated, or averaged on the last layer."""
        dtype = self.compute_dtype
        w, a_dst, a_src = self.weights[LEAVES_PER_LAYER * layer:
                                       LEAVES_PER_LAYER * (layer + 1)]
        rate = self.dropouts[layer]
        if training and rate > 0.0:
            h = dropout(h.contiguous(), seed, rate)
        hw = feature_transform(h, w, dtype)
        hw3 = hw.view(hw.shape[0], self.heads, a_src.shape[1])
        s = torch.einsum("nhd,hd->nh", hw3, a_src.to(dtype))
        t = torch.einsum("nhd,hd->nh", hw3, a_dst.to(dtype))
        attend = {"dense": self._attend_dense, "segment": self._attend_segment,
                  "tile": self._attend_tile}[self.backend]
        out = attend(graph, hw3, s, t, attn_seed, training)
        if layer == self.n_layers - 1:
            return out.mean(dim=1)  # average heads (paper eq. 6)
        return out.reshape(out.shape[0], -1)
