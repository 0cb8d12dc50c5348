"""Whole-run loop: the input's pre-aggregation (Â·X at the input's width,
once a run; the program's span ``pgcn::preagg``, ended by a sync, in
``fit`` only), ms a run over the traced window's run spans."""

from portbench.metrics._program import span_ms


def read(ctx):
    return span_ms(ctx, ("pgcn::preagg",))
