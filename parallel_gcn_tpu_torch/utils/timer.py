"""Named accumulating timers, the time of one call on the card, and the
program's spans.

Port of ``parallel_gcn_tpu/utils/timer.py`` (reference include/timer.h,
src/timer.cpp). The reference's host timers cannot time asynchronous CUDA
work; here a ``Timer`` on a CUDA device records a CUDA event at ``start``
and at ``stop`` and reads the elapsed time after waiting for the second, so
a span is the device time between the two points of the stream. On the CPU
it reads the host clock. For per-op device time use ``utils.profiling``.

``span(name)`` marks a phase of the program on the host: it enters
``torch.profiler.record_function("pgcn::<name>")``, so a run under
``torch.profiler`` holds the phase on the clock of the device's kernels,
and yields a ``Span`` whose seconds (host clock) the program's own timings
read. A span adds no device work and no sync: it ends where the host leaves
it. ``run_span`` opens the span of one training run and keeps the spans
closed inside it, for the run's ``phases:`` line (``run_phases``).
"""

from __future__ import annotations

import statistics
import threading
import time
from collections import defaultdict
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Callable, Iterator

import torch

# every span's name starts with it, on the profiler's timeline too
PREFIX = "pgcn::"


class Timer:
    """Named accumulating timers (reference: timer_start/stop/total) on
    ``device``: CUDA events on a CUDA device, the host clock on the CPU."""

    def __init__(self, device: str | torch.device = "cpu"):
        self.cuda = torch.device(device).type == "cuda"
        self._starts: dict = {}
        self._totals: dict[str, float] = defaultdict(float)
        self._counts: dict[str, int] = defaultdict(int)

    def start(self, name: str) -> None:
        if self.cuda:
            event = torch.cuda.Event(enable_timing=True)
            event.record()
            self._starts[name] = event
        else:
            self._starts[name] = time.perf_counter()

    def stop(self, name: str) -> float:
        """Stop ``name``; returns the span in seconds (on CUDA after waiting
        for the stream to reach this point)."""
        start = self._starts.pop(name)
        if self.cuda:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            end.synchronize()
            dt = start.elapsed_time(end) / 1e3
        else:
            dt = time.perf_counter() - start
        self._totals[name] += dt
        self._counts[name] += 1
        return dt

    def total(self, name: str) -> float:
        return self._totals[name]

    def average(self, name: str) -> float:
        return self._totals[name] / max(self._counts[name], 1)

    def report(self) -> str:
        return "\n".join(
            f"{name}: total={self._totals[name]:.6f}s "
            f"avg={self.average(name) * 1e3:.4f}ms n={self._counts[name]}"
            for name in sorted(self._totals))


def events_ms(fn: Callable[[], object], reps: int) -> float:
    """The median over up to three batches of ``fn()`` calls, ``reps`` calls
    in all after a warm-up call, of each batch's mean milliseconds a call on
    the current CUDA stream: a pair of CUDA events around a batch of calls
    queued back to back, so a call that keeps the device busy is timed by
    the device and one whose launch costs more than its work by the host's
    enqueue (a batch's mean is what one event pair around all ``reps`` calls
    gives; the median sets aside a batch that an outlier slowed)."""
    fn()
    torch.cuda.synchronize()
    batches = min(3, reps)
    sizes = [reps // batches + (b < reps % batches) for b in range(batches)]
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in sizes]
    for (start, end), n in zip(events, sizes):
        start.record()
        for _ in range(n):
            fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(start.elapsed_time(end) / n
                             for (start, end), n in zip(events, sizes))


@dataclass
class Span:
    """One phase of the program: its name (``pgcn::...``) and the host
    clock at its start and end (``perf_counter``)."""

    name: str
    start_s: float = 0.0
    end_s: float = 0.0

    @property
    def seconds(self) -> float:
        return self.end_s - self.start_s


# the spans closed inside this thread's open run (``run_span``), if one is open
_run = threading.local()


@contextmanager
def span(name: str) -> Iterator[Span]:
    """Mark the phase ``name`` (module docstring); yields its ``Span``,
    whose times are set when the block ends."""
    s = Span(name=PREFIX + name)
    with torch.profiler.record_function(s.name):
        s.start_s = time.perf_counter()
        try:
            yield s
        finally:
            s.end_s = time.perf_counter()
    spans = getattr(_run, "spans", None)
    if spans is not None:
        spans.append(s)


@contextmanager
def run_span(name: str) -> Iterator[None]:
    """The span ``name`` of one training run; the spans closed inside it
    are kept for ``run_phases`` until it ends."""
    outer = getattr(_run, "spans", None)
    _run.spans = []
    try:
        with span(name):
            yield
    finally:
        _run.spans = outer


def run_phases() -> str | None:
    """The spans closed so far in this thread's open run, as ``name
    seconds`` in the order they opened; None outside a run."""
    spans = getattr(_run, "spans", None)
    if spans is None:
        return None
    return ", ".join(f"{s.name[len(PREFIX):]} {s.seconds:.3f} s"
                     for s in sorted(spans, key=lambda s: s.start_s))
