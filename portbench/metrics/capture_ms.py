"""Whole-run loop: the capture of the epoch as one CUDA graph
(``torch.cuda.graph``: its garbage collection and ``empty_cache``, the
capture and the instantiation; the program's span ``pgcn::scan.capture``),
ms a run over the traced window's run spans."""

from portbench.metrics._program import span_ms


def read(ctx):
    return span_ms(ctx, ("pgcn::scan.capture",))
