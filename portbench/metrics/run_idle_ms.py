"""Whole-run loop: the device's idle time while a run is open and its
replays are not (the program's host spans ``pgcn::fit`` / ``pgcn::fit_seeds``
less ``pgcn::scan.replays``, on the trace's clock, less the union of the
device ops' intervals), ms a run over the traced window's run spans."""

from portbench.metrics._program import minus, run_spans, union

REPLAYS = "pgcn::scan.replays"


def read(ctx):
    runs = run_spans(ctx)
    if runs is None or not ctx.trace.intervals:
        return None
    lo, hi = ctx.trace.window
    clipped = [(max(s, lo), min(e, hi)) for s, e in runs]
    own = minus(union(clipped), union((s, e) for name, s, e in ctx.trace.host
                                      if name == REPLAYS))
    idle = minus(own, union(ctx.trace.intervals))
    return sum(e - s for s, e in idle) * 1e3 / len(runs)
