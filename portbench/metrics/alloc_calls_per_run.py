"""Whole-run loop: the caching allocator's ``cudaMalloc`` and ``cudaFree``
calls during a run (the runtime calls of the traced window that start
inside a run span, ``pgcn::fit`` / ``pgcn::fit_seeds``), a run over the
window's run spans."""

from portbench.metrics._program import per_run

CALLS = ("cudaMalloc", "cudaFree")


def read(ctx):
    runs = per_run(ctx, CALLS)
    if runs is None:
        return None
    return sum(len(events) for events in runs) / len(runs)
