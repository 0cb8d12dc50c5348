"""Model layer: the PyTorch ops between the kernels (``ops.loss``,
``optim``, casts, copies, reductions), device ms a model-epoch: the
categories below, the ordered sums left out."""

from portbench.metrics._device import category_seconds, ms_per_model_epoch

CATEGORIES = ("other elementwise", "reductions", "copies", "scatter/index (residual)")


def read(ctx):
    if ctx.trace is None:
        return None
    seconds = category_seconds(ctx, *CATEGORIES) - ctx.trace.seconds("pgcn_seg::")
    return ms_per_model_epoch(ctx, seconds)
