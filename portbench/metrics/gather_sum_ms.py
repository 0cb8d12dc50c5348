"""Aggregation layer: the residual's ordered sums (``ops.cuda_segment``,
kernels in namespace ``pgcn_seg``), device ms a model-epoch."""

from portbench.metrics._device import ms_per_model_epoch

NAMES = ("pgcn_seg::",)


def read(ctx):
    if ctx.trace is None:
        return None
    return ms_per_model_epoch(ctx, ctx.trace.seconds(*NAMES))
