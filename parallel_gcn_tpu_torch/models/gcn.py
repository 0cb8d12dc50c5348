"""N-layer Graph Convolutional Network.

Port of ``parallel_gcn_tpu/models/gcn.py`` (reference src/gcn.cu:47-142):

    layer 0:      dropout → X·W0        → Â·(·) → ReLU
    layer 1..L-2: dropout → H·Wi [+res] → Â·(·) → ReLU
    layer L-1:    dropout → H·W_{L-1}   → Â·(·) → logits

One weight per layer, no biases, Glorot-uniform init with half-range
sqrt(6/(rows+cols)) (src/variable.cu:63-83) drawn from a ``torch.Generator``.
Without residual connections the trailing ReLU is deferred into the next
layer's entry, where it fuses with that layer's dropout into one kernel
(``ops.cuda_dropout.relu_dropout``); the result is identical to ReLU then
dropout.

With ``fuse_dropout_matmul`` a training layer with a nonzero rate runs
dropout and X·W as one kernel (``ops.cuda_fused.dropout_matmul``, K10)
instead. Its mask is K1's, so the knob changes a trajectory by matmul
rounding only. The JAX package takes this branch only with
``dropout_impl=pallas``; the port has one dropout (Philox), so it always
does.

With ``remat`` each training layer (its dropout, transform and aggregation)
is recomputed in the backward instead of keeping its intermediates
(``torch.utils.checkpoint``, as the JAX package wraps it in
``jax.checkpoint``), in ``forward`` and in ``prefix``, which the deferred
schedule shares. The recompute reads the layer's dropout seed from the same
device slot, so it redraws the same mask; it stashes no RNG state (the
kernels draw none, and a captured epoch forbids it).
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from parallel_gcn_tpu_torch.data.graph import Graph
from parallel_gcn_tpu_torch.device import torch_dtype
from parallel_gcn_tpu_torch.ops.cuda_dropout import dropout, relu_dropout
from parallel_gcn_tpu_torch.ops.cuda_fused import dropout_matmul
from parallel_gcn_tpu_torch.ops.graphsum import graphsum
from parallel_gcn_tpu_torch.ops.sparse_matmul import feature_transform


def set_matmul_precision(precision: str) -> None:
    """``highest``: float32 matmuls in full f32 and bf16 matmuls with f32
    reductions; ``default``: TF32 and reduced-precision bf16 reductions
    allowed. A process-wide CUDA setting."""
    fast = precision == "default"
    torch.backends.cuda.matmul.allow_tf32 = fast
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = fast


def glorot(generator: torch.Generator, rows: int, cols: int) -> torch.Tensor:
    """A Glorot-uniform float32 [rows, cols] matrix, half-range
    sqrt(6/(rows+cols)), drawn on the CPU from ``generator``."""
    r = (6.0 / (rows + cols)) ** 0.5
    return torch.empty(rows, cols).uniform_(-r, r, generator=generator)


def layer_entry(h: torch.Tensor, rate: float, seed, training: bool,
                pre_relu: bool) -> torch.Tensor:
    """[the previous layer's deferred ReLU →] a layer's dropout at ``rate``:
    one K2 when both run (``relu_dropout``), K1 alone, or neither."""
    drop = training and rate > 0.0
    if pre_relu:
        if drop:
            return relu_dropout(h, seed, rate)
        h = torch.relu(h)
    return dropout(h, seed, rate) if drop else h


def init_params(
    generator: torch.Generator, input_dim: int, hidden_dims: Sequence[int],
    output_dim: int,
) -> list[torch.Tensor]:
    """One Glorot-uniform float32 weight per layer (src/gcn.cu:171-172),
    drawn on the CPU from ``generator``."""
    dims = [input_dim, *hidden_dims, output_dim]
    return [glorot(generator, rows, cols) for rows, cols in zip(dims[:-1], dims[1:])]


class GCNModel(nn.Module):
    """The GCN forward with its weights (``self.weights``, float32)."""

    # the last layer's aggregation can carry the deferred val forward beside
    # the train forward (train.fused_deferred_forward)
    supports_deferred_eval = True

    def __init__(
        self,
        weights: list[torch.Tensor],
        dropouts: Sequence[float],
        *,
        residual: bool = False,
        backend: str = "auto",
        edge_chunk: int = 0,
        dense_threshold: int = 8192,
        compute_dtype: str = "float32",
        input_preagg: bool = False,
        fuse_dropout_matmul: bool = False,
        remat: bool = False,
    ):
        super().__init__()
        if len(dropouts) != len(weights):
            raise ValueError(f"need {len(weights)} dropouts, got {dropouts}")
        self.weights = nn.ParameterList(
            [nn.Parameter(w.float().contiguous()) for w in weights]
        )
        self.dropouts = tuple(float(d) for d in dropouts)
        self.residual = residual
        self.backend = backend
        self.edge_chunk = edge_chunk
        self.dense_threshold = dense_threshold
        self.compute_dtype = torch_dtype(compute_dtype)
        # x already holds Â·X and layer 0 skips its aggregation (exact when
        # the input dropout is 0; see train.preaggregate_input)
        self.input_preagg = input_preagg
        self.fuse_dropout_matmul = fuse_dropout_matmul
        self.remat = remat
        # a layer is one array, with no keys (the checkpoint's grouping)
        self.layer_keys = [None] * len(weights)

    @property
    def n_layers(self) -> int:
        return len(self.weights)

    def aggregate(self, h: torch.Tensor, graph: Graph) -> torch.Tensor:
        """``Â·h`` with this model's backend knobs."""
        return graphsum(h, graph, backend=self.backend, edge_chunk=self.edge_chunk,
                        dense_threshold=self.dense_threshold)

    def layer_pre(self, h, layer: int, seed: int | None, training: bool,
                  pre_relu: bool = False) -> torch.Tensor:
        """Layer ``layer``'s half before aggregation: [relu →] dropout →
        feature transform. ``pre_relu`` is the previous layer's deferred
        ReLU, fused with this layer's dropout when both run, unless the
        dropout fuses with the feature transform (``fuse_dropout_matmul``)."""
        rate = self.dropouts[layer]
        drop = training and rate > 0.0
        if drop and self.fuse_dropout_matmul:
            if pre_relu:
                h = torch.relu(h)
            w = self.weights[layer].to(self.compute_dtype)
            # layer 0's input is data: no dX kernel
            return dropout_matmul(h, w, seed, rate, need_dx=layer > 0).to(self.compute_dtype)
        h = self.slice_in(layer_entry(h, rate, seed, training, pre_relu), layer)
        return feature_transform(h, self.weights[layer], self.compute_dtype)

    def slice_in(self, h: torch.Tensor, layer: int) -> torch.Tensor:
        """The part of layer ``layer``'s input (after its dropout) that its
        weight multiplies: all of it here (a tensor-parallel mesh model takes
        its feat rank's columns)."""
        return h

    def between_layers(self, h: torch.Tensor, layer: int) -> torch.Tensor:
        """What runs on layer ``layer``'s output before the next layer:
        nothing here (a tensor-parallel mesh model gathers columns)."""
        return h

    def forward(
        self,
        x: torch.Tensor,
        graph: Graph,
        *,
        training: bool,
        seeds: Sequence[int] | None = None,
        input_preagg: bool | None = None,
    ) -> torch.Tensor:
        """Logits [n_nodes, output_dim] float32. ``seeds`` holds one dropout
        seed per layer (needed when training with a nonzero rate);
        ``input_preagg`` overrides the model flag for this call (eval
        forwards on Â·X)."""
        preagg = self.input_preagg if input_preagg is None else input_preagg
        if training and any(d > 0 for d in self.dropouts) and seeds is None:
            raise ValueError("a training forward with dropout needs seeds")
        if preagg and training and self.dropouts[0] != 0.0:
            raise ValueError("input_preagg is only exact with zero input dropout")
        seeds = list(seeds) if seeds is not None else [None] * self.n_layers
        last = self.n_layers - 1
        h = self.prefix(x, graph, training=training, seeds=seeds, preagg=preagg)
        return self.layer(h, graph, last, seeds[last], training, last == 0 and preagg).float()

    def _layer(self, h, graph, layer: int, seed, training: bool, skip_agg: bool):
        h = self.layer_pre(h, layer, seed, training, pre_relu=self.defers_relu(layer))
        return h if skip_agg else self.aggregate(h, graph)

    def layer(self, h, graph, layer: int, seed, training: bool, skip_agg: bool):
        """Layer ``layer`` before its residual and ReLU: ``layer_pre`` then
        the aggregation (none with ``skip_agg``), recomputed in the backward
        when training with ``remat``."""
        args = (h, graph, layer, seed, training, skip_agg)
        if self.remat and training:
            return checkpoint(self._layer, *args, use_reentrant=False,
                              preserve_rng_state=False)
        return self._layer(*args)

    def defers_relu(self, layer: int) -> bool:
        """Whether ``layer`` applies the previous layer's ReLU at its entry
        (fused with its dropout): every layer after the first, without
        residual connections."""
        return layer > 0 and not self.residual

    def prefix(self, x: torch.Tensor, graph, *, training: bool, seeds: Sequence,
               preagg: bool) -> torch.Tensor:
        """Layers 0..L-2 of the forward on ``x`` (cast to the compute dtype),
        with one seed per layer: their output, before the ReLU when the last
        layer applies it at its entry (``defers_relu``)."""
        h = x.to(self.compute_dtype)
        prev = None
        for layer in range(self.n_layers - 1):
            h = self.layer(h, graph, layer, seeds[layer], training, layer == 0 and preagg)
            if self.residual:
                if layer > 0 and prev is not None and prev.shape == h.shape:
                    h = h + prev
                h = torch.relu(h)
                prev = h
            h = self.between_layers(h, layer)
        return h
