"""feature_transform — the per-layer ``X @ W`` product.

Port of ``parallel_gcn_tpu/ops/sparse_matmul.py:29``. Features are dense (a
reddit-size feature matrix is 0.56 GB), so this is one ``torch.matmul``:
operands in x's dtype, float32 accumulation, result in ``out_dtype``. TF32
and reduced-precision bf16 reductions are switched off or on once, at model
build (``models.gcn.set_matmul_precision``).

``sparse_feature_transform`` is the same product for features given as
(row, col, val) nonzeros: the ordered gather-sum of ``ops.cuda_segment``.
"""

from __future__ import annotations

import torch

from parallel_gcn_tpu_torch.ops.cuda_segment import gather_sum_t, segments


def feature_transform(
    x: torch.Tensor, w: torch.Tensor, out_dtype: torch.dtype | None = None
) -> torch.Tensor:
    """``x @ w.to(x.dtype)`` with f32 accumulation, returned in
    ``out_dtype`` (default float32)."""
    out_dtype = out_dtype or torch.float32
    w = w.to(x.dtype)
    if out_dtype == x.dtype:
        return torch.matmul(x, w)
    # f32 result of narrow operands: the products are exact in f32
    return torch.matmul(x.float(), w.float()).to(out_dtype)


def sparse_feature_transform(
    feat_row: torch.Tensor,  # int [nnz]: row id per nonzero (sorted)
    feat_col: torch.Tensor,  # int [nnz]: feature id per nonzero
    feat_val: torch.Tensor,  # float [nnz]: 0 on padding
    w: torch.Tensor,  # [input_dim, H]
    n_nodes: int,
) -> torch.Tensor:
    """Sparse features times ``w``: out[n] = Σ_j val_j · w[col_j] over row
    n's nonzeros (``parallel_gcn_tpu/ops/sparse_matmul.py:52``), in w's
    dtype. Differentiable in ``w`` only (the features are data), as the
    reference's backward (src/module.cu:136-163), whose sums by feature run
    in nonzero order too. Builds the index's segments per call (a host
    sync)."""
    row, col = feat_row.long().contiguous(), feat_col.long().contiguous()
    seg = segments(row, n_nodes, col, feat_val)
    return gather_sum_t(w, seg, segments(col, w.shape[0], seg.index, feat_val))
