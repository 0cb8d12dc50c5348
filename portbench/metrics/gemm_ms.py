"""Model layer: cuBLAS GEMMs and GEMVs (``ops.sparse_matmul.feature_transform``),
device ms a model-epoch."""

from portbench.metrics._device import category_seconds, ms_per_model_epoch


def read(ctx):
    if ctx.trace is None:
        return None
    return ms_per_model_epoch(ctx, category_seconds(ctx, "GEMMs"))
