"""Seed-batch layer (``seeds``): K1/K2 over the lanes and their backward,
and the joins of the lanes' tensors (``cat``), device ms a model-epoch."""

from portbench.metrics._device import ms_per_model_epoch

NAMES = ("dropout_lanes_kernel", "dropout_lanes_bwd_kernel", "CatArrayBatchedCopy")


def read(ctx):
    if ctx.trace is None or ctx.cell.lanes < 2:
        return None
    return ms_per_model_epoch(ctx, ctx.trace.seconds(*NAMES))
