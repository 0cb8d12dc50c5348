"""graphsum — neighborhood aggregation ``out = Â · x``.

Port of ``parallel_gcn_tpu/ops/graphsum.py`` (reference GraphSum,
src/module.cu:165-210). Backends:

* ``dense``   — ``torch.matmul`` with the dense Â (small graphs).
* ``segment`` — row-sorted COO: ``Σ val·x[col]`` by ``row``, the ordered
                gather-sum of ``ops.cuda_segment`` over the graph's
                ``row_seg`` (kernel (a) on the card, every row's edges in
                edge order; on the CPU gather, scale and ``index_add_``, in
                edge chunks when the gathered intermediate would exceed the
                memory budget).
* ``bcsr``    — the tile SpMM kernel (``ops.cuda_bcsr``).
* ``hybrid``  — dense-enough tiles through the kernel plus the COO residual
                through the segment path, summed in x's dtype.

Backward: Â is symmetric, so the gradient re-runs the same aggregation on
the cotangent (one ``torch.autograd.Function`` for every backend).

Dtypes. The output is in x's dtype (the bcsr backend's in f32). In bf16
the segment sum departs from the JAX package's on purpose: the port
multiplies each bf16-rounded ``val`` by bf16 x exactly in f32, sums in f32
in edge order and rounds once (kernel (a) on the card, the same function on
the CPU), where JAX's ``_segment_once`` rounds every product and partial
sum to bf16. Against an f64 sum, on rows of up to 409 edges (synth-reddit's
residual), the port's error is at most 0.0039 of the row's Σ|term| (one
rounding) and JAX's 0.021, so the two agree within 0.025 of Σ|term|
(``tests/test_torch_segment.py``, ``PORT_VS_JAX_BF16``). In f32 both are one
rounding a product and a sum apart from the order.
"""

from __future__ import annotations

import warnings

import torch

from parallel_gcn_tpu_torch.data.graph import Graph
from parallel_gcn_tpu_torch.ops.cuda_bcsr import bcsr_matmul_impl
from parallel_gcn_tpu_torch.ops.cuda_segment import gather_sum

# gathered-intermediate budget for the segment backend's plain version, in
# elements
_DEFAULT_EDGE_ELEM_BUDGET = 256 * 1024 * 1024


def _segment(x, graph: Graph, n_chunks):
    """Σ_e val[e]·x[col[e]] into row[e] in edge order, in x's dtype: the
    ordered gather-sum (``n_chunks`` edge chunks in its plain version)."""
    return gather_sum(x, graph.row_seg, n_chunks=n_chunks)


def _pick_n_chunks(n_edges_pad: int, n_feat: int, edge_chunk: int) -> int:
    if edge_chunk > 0:
        return max(1, n_edges_pad // edge_chunk)
    total = n_edges_pad * max(n_feat, 1)
    n_chunks = max(1, total // _DEFAULT_EDGE_ELEM_BUDGET)
    while n_edges_pad % n_chunks != 0 and n_chunks > 1:
        n_chunks -= 1
    return n_chunks


def _graphsum_impl(x: torch.Tensor, graph: Graph, backend: str,
                   n_chunks: int) -> torch.Tensor:
    if backend == "dense":
        adj = graph.adj
        if adj.dtype == torch.int8:
            adj = adj.to(x.dtype)
        elif adj.dtype != x.dtype:
            # narrow x to a narrow Â's dtype (the operands the JAX package
            # multiplies) and accumulate in x's wider dtype
            if adj.dtype.itemsize < x.dtype.itemsize:
                return torch.matmul(adj.to(x.dtype), x.to(adj.dtype).to(x.dtype))
            adj = adj.to(x.dtype)
        return torch.matmul(adj, x)
    if backend == "bcsr":
        return bcsr_matmul_impl(graph.bcsr, x)
    if backend == "hybrid":
        # tile part in f32, rounded to x's dtype, plus the residual in
        # x's dtype (graphsum.py:123-126 order)
        out = bcsr_matmul_impl(graph.bcsr, x).to(x.dtype)
        return out + _segment(x, graph, n_chunks)
    return _segment(x, graph, n_chunks)


class _GraphSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, graph, backend, n_chunks):
        ctx.graph, ctx.backend, ctx.n_chunks = graph, backend, n_chunks
        return _graphsum_impl(x, graph, backend, n_chunks)

    @staticmethod
    def backward(ctx, g):
        # Â symmetric: the backward is the same aggregation of the cotangent
        dx = _graphsum_impl(g.contiguous(), ctx.graph, ctx.backend, ctx.n_chunks)
        return dx, None, None, None


def resolve_backend(graph: Graph, backend: str, dense_threshold: int = 8192) -> str:
    """The backend that serves ``backend`` on ``graph`` (same rules and
    errors as the JAX package's ``resolve_backend``)."""
    if backend == "auto":
        if graph.is_hybrid:
            backend = "hybrid"
        elif graph.bcsr is not None:
            backend = "bcsr"
        elif graph.adj is not None and graph.n_nodes <= dense_threshold:
            backend = "dense"
        else:
            backend = "segment"
    if backend in ("bcsr", "segment") and graph.is_hybrid:
        warnings.warn(
            f"backend={backend!r} requested on a hybrid-built graph; serving "
            "tiles or residual alone would drop edges — using 'hybrid'",
            stacklevel=2,
        )
        backend = "hybrid"
    if not graph.is_hybrid and not graph.coo_complete:
        if graph.bcsr is None:
            raise ValueError("graph has neither a complete COO nor a tile pack")
        if backend in ("dense", "segment"):
            raise ValueError(
                f"backend={backend!r} requested but this graph carries only a "
                "tile pack (hybrid build with empty residual; its COO/adj "
                "arrays are padding-only) — use backend=bcsr/hybrid/auto"
            )
        backend = "bcsr"
    elif backend == "hybrid" and not graph.is_hybrid and graph.bcsr is not None:
        backend = "bcsr"
    return backend


def graphsum(
    x: torch.Tensor,
    graph: Graph,
    *,
    backend: str = "auto",
    edge_chunk: int = 0,
    dense_threshold: int = 8192,
) -> torch.Tensor:
    """Aggregate node features over the normalized adjacency: ``Â @ x``.

    x: [n_nodes, F] (n_nodes = padded node count of ``graph``). Returns
    [n_nodes, F] in x's dtype, except the bcsr backend, which returns f32
    like the kernel."""
    resolved = resolve_backend(graph, backend, dense_threshold)
    if resolved == "dense" and graph.adj is None:
        raise ValueError("dense backend requested but graph was built without adj")
    if resolved in ("bcsr", "hybrid") and graph.bcsr is None:
        raise ValueError(
            f"{resolved} backend requested but graph was built without tiles"
        )
    n_chunks = (
        _pick_n_chunks(graph.n_edges_pad, x.shape[-1], edge_chunk)
        if resolved in ("segment", "hybrid")
        else 1
    )
    if resolved == "dense" and graph.adj.dtype == torch.int8:
        # Â = D·A₈·D (exact factorization): scale outside the pattern matmul
        d = graph.adj_scale.to(x.dtype)[:, None]
        return _GraphSum.apply(x * d, graph, resolved, n_chunks) * d
    return _GraphSum.apply(x, graph, resolved, n_chunks)
