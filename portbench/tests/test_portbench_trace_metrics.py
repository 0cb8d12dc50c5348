"""The readers of the program's spans (``metrics/_program.py`` and the six
whole-run-loop metrics) on hand-made traces: the expected ms, calls and
idle time, and None where the trace holds no run span (an untraced run, or
a program older than its spans); then on the trace of a real run on the
CPU."""

import pytest
import torch

from portbench import devtrace, harness
from portbench.metrics import (_program, alloc_calls_per_run, capture_ms, first_epoch_ms,
                               preagg_ms, run_idle_ms, run_tail_ms)

READERS = (preagg_ms, first_epoch_ms, capture_ms, run_tail_ms, alloc_calls_per_run,
           run_idle_ms)


def _ctx(trace, runs=()):
    cell = harness.Cell(name="t", workload={}, config={"family": "gcn"}, traffic={"lanes": 1})
    return harness.Context(cell=cell, runs=list(runs), setup={}, trace=trace, work={},
                           graph={}, peaks=None)


def _trace(host, intervals=((0.0, 30.0),), window=(0.0, 30.0)):
    return devtrace.Trace(ops={}, intervals=list(intervals), host=list(host), window=window)


def _spans(t, preagg=True, allocs=0, frees=0):
    """One run's host events from ``t``: build 0.1 s (pre-aggregation
    0.04 s in it), prepare 0.05 s (capture 0.02 s in it), replays 1.6 s,
    result 0.003 s, test eval 0.007 s, and ``allocs`` cudaMalloc and
    ``frees`` cudaFree calls in the capture."""
    out = [("portbench::run", t, t + 1.8), ("pgcn::fit", t, t + 1.8),
           ("pgcn::build", t, t + 0.1),
           ("pgcn::scan.prepare", t + 0.1, t + 0.15),
           ("pgcn::scan.capture", t + 0.12, t + 0.14),
           ("pgcn::scan.replays", t + 0.15, t + 1.75),
           ("pgcn::scan.result", t + 1.75, t + 1.753),
           ("pgcn::test_eval", t + 1.753, t + 1.76), ("aten::add", t + 0.01, t + 0.02)]
    out += [("cudaMalloc", t + 0.121 + i * 1e-4, t + 0.121 + i * 1e-4 + 5e-5)
            for i in range(allocs)]
    out += [("cudaFree", t + 0.125 + i * 1e-4, t + 0.125 + i * 1e-4 + 5e-5)
            for i in range(frees)]
    if preagg:
        out.append(("pgcn::preagg", t + 0.05, t + 0.09))
    return out


@pytest.fixture
def window():
    """Two runs in the traced window, with allocator calls outside the
    run spans (the harness's own) that are not counted."""
    host = [*_spans(1.0, allocs=3, frees=5), *_spans(5.0, allocs=4, frees=2),
            ("cudaMalloc", 0.5, 0.6), ("cudaFree", 4.0, 4.1)]
    return _ctx(_trace(host))


def test_the_program_readers_by_hand(window):
    assert preagg_ms.read(window) == pytest.approx(40.0)
    assert first_epoch_ms.read(window) == pytest.approx(30.0)
    assert capture_ms.read(window) == pytest.approx(20.0)
    assert run_tail_ms.read(window) == pytest.approx(10.0)
    assert alloc_calls_per_run.read(window) == pytest.approx((3 + 5 + 4 + 2) / 2)


def test_a_span_missing_from_one_run_reads_none():
    ctx = _ctx(_trace([*_spans(1.0), *_spans(5.0, preagg=False)]))
    assert preagg_ms.read(ctx) is None and capture_ms.read(ctx) == pytest.approx(20.0)


@pytest.mark.parametrize("reader", READERS, ids=lambda m: m.__name__.split(".")[-1])
def test_without_the_programs_records_the_readers_read_none(window, reader):
    # an untraced run
    assert reader.read(_ctx(None)) is None
    # the parent commit's program: the trace holds no pgcn:: span
    parent = [(name, s, e) for name, s, e in window.trace.host if not name.startswith("pgcn::")]
    assert reader.read(_ctx(_trace(parent))) is None


def test_run_idle_counts_idle_in_runs_outside_their_replays():
    # run 1 (0–10 s, replays 2–8 s) is busy 0–1, 8.5–9 outside its replays:
    # idle 1–2, 8–8.5, 9–10 = 2.5 s; the device idles 2–2.5 inside the
    # replays (not counted). Run 2 (11–13 s, no replays) is busy 11.5–12:
    # idle 1.5 s. The gap between the runs (10–11 s) is not counted.
    host = [("portbench::run", 0.0, 10.0), ("pgcn::fit", 0.0, 10.0),
            ("pgcn::scan.replays", 2.0, 8.0), ("cudaFree", 9.2, 9.8),
            ("pgcn::fit_seeds", 11.0, 13.0)]
    busy = [(0.0, 0.5), (0.25, 1.0), (2.5, 3.0), (3.0, 8.0), (8.5, 9.0), (11.5, 12.0)]
    ctx = _ctx(_trace(host, busy, window=(0.0, 14.0)))
    assert run_idle_ms.read(ctx) == pytest.approx((2.5 + 1.5) * 1e3 / 2)
    # the device busy throughout reads 0
    assert run_idle_ms.read(_ctx(_trace(host, [(0.0, 14.0)], window=(0.0, 14.0)))) == 0.0


def test_run_idle_reads_none_without_run_spans_or_a_trace():
    host = [("portbench::run", 0.0, 10.0), ("cudaFree", 9.2, 9.8)]
    assert run_idle_ms.read(_ctx(_trace(host, [(0.0, 1.0)]))) is None
    assert run_idle_ms.read(_ctx(None)) is None


def test_interval_arithmetic():
    assert _program.union([(3, 4), (0, 1), (0.5, 2), (2, 2.5), (5, 5)]) == \
        [[0, 2.5], [3, 4]]
    assert _program.minus([[0, 10], [12, 14]], [[-1, 1], [2, 3], [9, 13]]) == \
        [[1, 2], [3, 9], [13, 14]]
    assert _program.minus([[0, 1]], []) == [[0, 1]]


def test_the_readers_find_the_spans_of_a_real_run():
    """Two ``fit`` runs of a small GCN on the CPU under ``torch.profiler``,
    inside the benchmark's window span, read through ``devtrace``: the
    spans the CPU has (no capture there) are found in each run, the others
    read None, and no device op means no idle time to read."""
    from torch.profiler import ProfilerActivity, profile

    from parallel_gcn_tpu_torch import train
    from parallel_gcn_tpu_torch.config import Config
    from parallel_gcn_tpu_torch.data.parser import to_device
    from parallel_gcn_tpu_torch.data.synthetic import make_synthetic_dataset

    ds = make_synthetic_dataset("trace", n_nodes=300, n_edges=4000, input_dim=12,
                                n_classes=4, n_train=150, n_val=60, feature_nnz_per_row=4,
                                n_communities=4)
    dds = to_device(ds, device=torch.device("cpu"))
    cfg = Config()
    cfg.gcn.hidden_dims, cfg.gcn.dropouts, cfg.gcn.epochs = (8,), (0.0, 0.3), 3
    cfg.tpu.backend, cfg.train.verbose, cfg.train.mode = "segment", False, "scan"
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with harness._span(devtrace.WINDOW_SPAN):
            for _ in range(2):
                train.fit(cfg, dds)
    ctx = _ctx(devtrace.read_trace(prof))
    assert len(_program.run_spans(ctx)) == 2
    assert preagg_ms.read(ctx) > 0 and run_tail_ms.read(ctx) > 0
    assert capture_ms.read(ctx) is None and first_epoch_ms.read(ctx) is None
    assert alloc_calls_per_run.read(ctx) == 0
    assert run_idle_ms.read(ctx) is None
