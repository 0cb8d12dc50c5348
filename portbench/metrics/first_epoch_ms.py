"""Whole-run loop: epoch 1, run eagerly before the capture, enqueued and
waited for (the program's span ``pgcn::scan.prepare`` less its child
``pgcn::scan.capture``, which opens after the sync that ends epoch 1), ms
a run over the traced window's run spans."""

from portbench.metrics._program import span_ms


def read(ctx):
    return span_ms(ctx, ("pgcn::scan.prepare",), ("pgcn::scan.capture",))
