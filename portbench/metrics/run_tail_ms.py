"""Whole-run loop: what a run does after its last replay, the deferred
final val eval and the history's read-back (``pgcn::scan.result``) and the
test split's eval and read (``pgcn::test_eval``), ms a run over the
traced window's run spans."""

from portbench.metrics._program import span_ms


def read(ctx):
    return span_ms(ctx, ("pgcn::scan.result", "pgcn::test_eval"))
