"""Aggregation layer: the tile SpMM (K3/K4, ``ops.cuda_bcsr``; both bodies
and the segment reduction), device ms a model-epoch."""

from portbench.metrics._device import category_seconds, ms_per_model_epoch


def read(ctx):
    if ctx.trace is None:
        return None
    return ms_per_model_epoch(ctx, category_seconds(ctx, "K3/K4 tile SpMM"))
