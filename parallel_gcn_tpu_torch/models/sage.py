"""GraphSAGE (mean aggregator) and GIN.

Port of ``parallel_gcn_tpu/models/sage.py``. Both families aggregate through
the GCN's symmetric operator Â = D^{-1/2} (A+I) D^{-1/2} (``ops.graphsum``:
on the card the tile SpMM K4 and the residual's ordered gather-sum) by exact
diagonal rewrites, with s = sqrt(deg) (``Graph.sqrt_deg``):

    SUM:  (A+I)·h          = s ⊙ Â·(s ⊙ h)
    MEAN: D^{-1}(A+I)·h    = s^{-1} ⊙ Â·(s ⊙ h)

GraphSAGE-mean (arXiv:1706.02216) over N(i) ∪ {i}:
``h_i' = act(W_self·h_i + W_neigh·mean_{j ∈ N(i) ∪ {i}} h_j)``, the neighbour
transform applied before the aggregation (exact: the aggregation is
linear), so it runs at the layer's output width.

GIN-eps (arXiv:1810.00826): ``h_i' = MLP((1+eps)·h_i + Σ_{j ∈ N(i)} h_j)``
with a two-layer MLP (Linear → ReLU → Linear) on the inner layers and one
linear classifier after the last aggregation; eps is fixed
(``cfg.gcn.gin_eps``).

Parameters are one flat ``nn.ParameterList`` in the JAX package's leaf order
(each layer's dict keys sorted): SAGE ``[neigh_0, self_0, neigh_1, ...]``,
GIN ``[w1_0, w2_0, ..., w1_last]``. Leaf 0 is the leaf the trainer's Adam
decays and its L2 term reports, as JAX's ``optim.decayed_leaf``. Dropout
before every layer is K1 (``ops.cuda_dropout``) with the layer's seed;
without residual connections a layer's trailing ReLU is applied at the next
layer's entry, fused with its dropout (K2), as ``models/gcn.py`` does; the
result is identical. The fused dropout⊗matmul (K10) stays GCN-only, as in
JAX. There is no input pre-aggregation (the layer algebra is not
transform → aggregate) and no deferred eval. With ``remat`` each layer is
recomputed in the backward (``torch.utils.checkpoint``): the recompute
reads its dropout seed from the same device slot, so it redraws the same
mask, and it stashes no RNG state, which a captured epoch forbids.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from parallel_gcn_tpu_torch.device import torch_dtype
from parallel_gcn_tpu_torch.models.gcn import glorot, layer_entry
from parallel_gcn_tpu_torch.ops.graphsum import graphsum
from parallel_gcn_tpu_torch.ops.sparse_matmul import feature_transform


def init_sage_params(generator: torch.Generator, input_dim: int, hidden_dims: Sequence[int],
                     output_dim: int) -> list[torch.Tensor]:
    """Glorot-uniform float32 leaves ``[neigh, self]`` per layer, drawn on
    the CPU from ``generator``."""
    dims = [input_dim, *hidden_dims, output_dim]
    out = []
    for rows, cols in zip(dims[:-1], dims[1:]):
        out += [glorot(generator, rows, cols), glorot(generator, rows, cols)]
    return out


def init_gin_params(generator: torch.Generator, input_dim: int, hidden_dims: Sequence[int],
                    output_dim: int) -> list[torch.Tensor]:
    """Glorot-uniform float32 leaves: ``[w1: d_k→d_{k+1}, w2: d_{k+1}→d_{k+1}]``
    per inner layer (the two-layer MLP), ``[w1: d_{L-1}→classes]`` last."""
    dims = [input_dim, *hidden_dims, output_dim]
    out = []
    for i in range(len(dims) - 2):
        out += [glorot(generator, dims[i], dims[i + 1]),
                glorot(generator, dims[i + 1], dims[i + 1])]
    return out + [glorot(generator, dims[-2], dims[-1])]


class _AggVariant(nn.Module):
    """What SAGE and GIN share: the trainer's protocol, the weights by
    layer, dropout at the layer entries, the diagonal-rewrite aggregators
    and the layer loop (residual, ReLU, ``remat``)."""

    family = ""
    input_preagg = False  # the trainer's contract: no Â·X rewrite
    supports_deferred_eval = False

    def __init__(
        self,
        params: list[torch.Tensor],
        dropouts: Sequence[float],
        *,
        backend: str = "auto",
        edge_chunk: int = 0,
        dense_threshold: int = 8192,
        compute_dtype: str = "float32",
        residual: bool = False,
        remat: bool = False,
    ):
        super().__init__()
        self.layer_keys = self.keys_for(len(dropouts))
        if len(params) != sum(len(k) for k in self.layer_keys):
            raise ValueError(f"{self.family}: {len(params)} params do not fit "
                             f"{len(dropouts)} layers of keys {self.layer_keys}")
        self.weights = nn.ParameterList(
            [nn.Parameter(p.float().contiguous()) for p in params]
        )
        self.dropouts = tuple(float(d) for d in dropouts)
        self.backend = backend
        self.edge_chunk = edge_chunk
        self.dense_threshold = dense_threshold
        self.compute_dtype = torch_dtype(compute_dtype)
        self.residual = residual
        self.remat = remat
        starts = [0]
        for keys in self.layer_keys:
            starts.append(starts[-1] + len(keys))
        self._starts = starts

    @staticmethod
    def keys_for(n_layers: int) -> list[tuple[str, ...]]:
        """Each layer's keys in JAX's leaf order (sorted)."""
        raise NotImplementedError

    @property
    def n_layers(self) -> int:
        return len(self.dropouts)

    def layer_weights(self, layer: int) -> dict[str, torch.Tensor]:
        """Layer ``layer``'s leaves by key."""
        lo = self._starts[layer]
        return {k: self.weights[lo + i] for i, k in enumerate(self.layer_keys[layer])}

    def aggregate(self, h: torch.Tensor, graph) -> torch.Tensor:
        """``Â·h`` with this model's backend knobs."""
        return graphsum(h, graph, backend=self.backend, edge_chunk=self.edge_chunk,
                        dense_threshold=self.dense_threshold)

    @staticmethod
    def _scale(graph, h: torch.Tensor) -> torch.Tensor:
        if graph.sqrt_deg is None:
            raise ValueError("this model needs the graph's sqrt_deg")
        return graph.sqrt_deg.to(h.dtype)[:, None]

    def sum_agg(self, h: torch.Tensor, graph) -> torch.Tensor:
        """Σ_{j ∈ N(i) ∪ {i}} h_j = s ⊙ Â·(s ⊙ h)."""
        s = self._scale(graph, h)
        return s * self.aggregate(s * h, graph)

    def mean_agg(self, h: torch.Tensor, graph) -> torch.Tensor:
        """mean_{j ∈ N(i) ∪ {i}} h_j = Â·(s ⊙ h) / s."""
        s = self._scale(graph, h)
        return self.aggregate(s * h, graph) / s

    def _entry(self, h, layer: int, seed, training: bool, pre_relu: bool) -> torch.Tensor:
        """[the previous layer's ReLU →] this layer's dropout, fused into K2
        when both run."""
        return layer_entry(h, self.dropouts[layer], seed, training, pre_relu)

    def _layer(self, h, layer: int, seed, training: bool, pre_relu: bool, graph):
        raise NotImplementedError

    def forward(
        self,
        x: torch.Tensor,
        graph,
        *,
        training: bool,
        seeds: Sequence | None = None,
        input_preagg: bool | None = None,
    ) -> torch.Tensor:
        """Logits [n_nodes, output_dim] float32; ``seeds`` one dropout seed
        per layer (needed when training with a nonzero rate)."""
        if input_preagg:
            raise ValueError(f"input pre-aggregation is a GCN rewrite; {self.family} has "
                             "no loop-invariant first aggregation")
        if training and any(d > 0 for d in self.dropouts) and seeds is None:
            raise ValueError("a training forward with dropout needs seeds")
        seeds = list(seeds) if seeds is not None else [None] * self.n_layers
        last = self.n_layers - 1
        h = x.to(self.compute_dtype)
        prev = None
        for layer in range(self.n_layers):
            h = self.run_layer(h, layer, seeds[layer], training,
                               layer > 0 and not self.residual, graph)
            if self.residual and 0 < layer < last and prev is not None \
                    and prev.shape == h.shape:
                h = h + prev
            if layer < last and self.residual:
                h = torch.relu(h)
                prev = h
            if layer < last:
                h = self.between_layers(h, layer)
        return h.float()

    def run_layer(self, h, layer: int, seed, training: bool, pre_relu: bool, graph):
        """``_layer``, recomputed in the backward when training with
        ``remat``."""
        args = (h, layer, seed, training, pre_relu, graph)
        if self.remat and training:
            return checkpoint(self._layer, *args, use_reentrant=False, preserve_rng_state=False)
        return self._layer(*args)

    def between_layers(self, h: torch.Tensor, layer: int) -> torch.Tensor:
        """What runs on layer ``layer``'s output before the next layer: nothing
        here (the tensor-parallel mesh model gathers columns)."""
        return h


class SAGEModel(_AggVariant):
    """GraphSAGE-mean for full-batch node classification."""

    family = "sage"

    @staticmethod
    def keys_for(n_layers: int) -> list[tuple[str, ...]]:
        return [("neigh", "self")] * n_layers

    def _layer(self, h, layer, seed, training, pre_relu, graph):
        h = self._entry(h, layer, seed, training, pre_relu)
        w = self.layer_weights(layer)
        dtype = self.compute_dtype
        h_self = feature_transform(h, w["self"], dtype)
        h_neigh = feature_transform(h, w["neigh"], dtype)
        return h_self + self.mean_agg(h_neigh, graph).to(dtype)


class GINModel(_AggVariant):
    """GIN-eps for full-batch node classification."""

    family = "gin"

    @staticmethod
    def keys_for(n_layers: int) -> list[tuple[str, ...]]:
        # the inner layers' two-layer MLP, the last layer's classifier
        return [("w1", "w2")] * (n_layers - 1) + [("w1",)]

    def __init__(self, params, dropouts, *, gin_eps: float = 0.0, **kw):
        super().__init__(params, dropouts, **kw)
        self.gin_eps = float(gin_eps)
        # eps in the compute dtype on the weights' device, as JAX's
        # jnp.asarray(eps, dtype): a capture reads no host value
        self.register_buffer("eps", torch.tensor(self.gin_eps, dtype=self.compute_dtype,
                                                  device=self.weights[0].device),
                             persistent=False)

    def _layer(self, h, layer, seed, training, pre_relu, graph):
        h = self._entry(h, layer, seed, training, pre_relu)
        dtype = self.compute_dtype
        # (1+eps)·h_i + Σ_{N(i)} h_j, through the self-loop-inclusive sum
        z = self.eps * h + self.sum_agg(h, graph).to(dtype)
        w = self.layer_weights(layer)
        z = feature_transform(z, w["w1"], dtype)
        if "w2" in w:
            z = feature_transform(torch.relu(z), w["w2"], dtype)
        return z
