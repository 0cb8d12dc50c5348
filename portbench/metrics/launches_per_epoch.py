"""Whole-run loop: the kernel launches and collectives of one captured
epoch (the program's launch counters, ``FitResult.graph_launches``),
summed over the lanes' one graph."""


def read(ctx):
    launches = ctx.runs[0].graph_launches if ctx.runs else {}
    return float(sum(launches.values())) if launches else None
