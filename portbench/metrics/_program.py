"""What the readers of the program's spans share: the spans ``pgcn::...``
that the program's ``utils.timer.span`` leaves on a traced window's host
timeline (``Trace.host``), grouped by the run span they fall in
(``pgcn::fit`` / ``pgcn::fit_seeds``), and interval arithmetic on the
trace's clock. An untraced run, or a program older than its spans, has no
run span and gives None."""

from __future__ import annotations

RUN_SPANS = ("pgcn::fit", "pgcn::fit_seeds")


def run_spans(ctx) -> list | None:
    """The (start, end) of each run span of the traced window, or None."""
    tr = ctx.trace
    if tr is None:
        return None
    runs = sorted((s, e) for name, s, e in tr.host if name in RUN_SPANS)
    return runs or None


def per_run(ctx, names: tuple) -> list | None:
    """For each run span, the host events called one of ``names`` that
    start inside it, as (name, start, end); None without run spans."""
    runs = run_spans(ctx)
    if runs is None:
        return None
    events = [(name, s, e) for name, s, e in ctx.trace.host if name in names]
    return [[ev for ev in events if lo <= ev[1] < hi] for lo, hi in runs]


def span_ms(ctx, plus: tuple, minus: tuple = ()) -> float | None:
    """The seconds of the spans named in ``plus`` less those named in
    ``minus``, in ms a run over the window's run spans; None where a run
    lacks one of the names."""
    runs = per_run(ctx, plus + minus)
    if runs is None:
        return None
    total = 0.0
    for events in runs:
        seconds: dict = {}
        for name, s, e in events:
            seconds[name] = seconds.get(name, 0.0) + (e - s)
        if any(name not in seconds for name in plus + minus):
            return None
        total += sum(seconds[n] for n in plus) - sum(seconds[n] for n in minus)
    return total * 1e3 / len(runs)


def union(intervals) -> list:
    """Sorted, disjoint [start, end] pairs covering ``intervals``."""
    out: list = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        elif e > s:
            out.append([s, e])
    return out


def minus(a: list, b: list) -> list:
    """The parts of the disjoint sorted pairs ``a`` outside those of ``b``."""
    out, j = [], 0
    for s, e in a:
        while j < len(b) and b[j][1] <= s:
            j += 1
        k, at = j, s
        while k < len(b) and b[k][0] < e:
            if b[k][0] > at:
                out.append([at, b[k][0]])
            at = max(at, b[k][1])
            k += 1
        if at < e:
            out.append([at, e])
    return out
