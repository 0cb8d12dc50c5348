"""Device, the whole step: the model FLOPs of the window (the family's
``work`` a model-epoch from its equations, and the once-a-run Â·X of each
run) over the traced window's time times the peak of the compute dtype."""


def read(ctx):
    tr, pk = ctx.trace, ctx.peaks
    if tr is None or pk is None or tr.window_s <= 0:
        return None
    g = ctx.graph
    flops = ctx.work["flops"] * ctx.model_epochs
    flops += len(ctx.runs) * sum(2.0 * g["nnz"] * f for w in ctx.work["agg_run"] for f in w)
    peak = pk["bf16_flops"] if g["dtype_bytes"] == 2 else pk["f32_flops"]
    return 100.0 * flops / (tr.window_s * peak)
