"""The program's spans (``utils.timer.span`` / ``run_span``): the spans of
``fit`` (``mode=scan`` and ``mode=eager``) and of ``fit_seeds`` and how they
nest, the loop's times read off its spans, the run's ``phases:`` line, no
span inside an epoch, the data set-up's stage spans, the spans on the
profiler's timeline, and on an NVIDIA GPU the capture's span."""

from contextlib import contextmanager

import pytest
import torch

from parallel_gcn_tpu_torch import scan, train
from parallel_gcn_tpu_torch import seeds as sd
from parallel_gcn_tpu_torch.config import Config
from parallel_gcn_tpu_torch.data import graph, parser
from parallel_gcn_tpu_torch.data.parser import (prepare_device_dataset, prepare_host_dataset,
                                                to_device)
from parallel_gcn_tpu_torch.data.synthetic import make_synthetic_dataset
from parallel_gcn_tpu_torch.scan import ScanLoop
from parallel_gcn_tpu_torch.seeds import LaneScanLoop
from parallel_gcn_tpu_torch.utils import timer

torch.set_num_threads(1)
CPU = torch.device("cpu")
SEED = 2**33 + 17

# span -> its parent, by mode (the CPU's scan captures nothing)
NESTING = {
    "scan": {"fit": None, "build": "fit", "preagg": "build", "scan.prepare": "fit",
             "scan.replays": "fit", "scan.result": "fit", "test_eval": "fit"},
    "eager": {"fit": None, "build": "fit", "preagg": "build", "test_eval": "fit"},
    "seeds": {"fit_seeds": None, "build": "fit_seeds", "scan.prepare": "fit_seeds",
              "scan.replays": "fit_seeds", "scan.result": "fit_seeds",
              "test_eval": "fit_seeds"},
}


@pytest.fixture
def spans(monkeypatch):
    """Every span closed while the test runs, as (name, parent, Span, opened
    inside an epoch) in the order they closed; ``spans.in_epoch`` is set
    while a loop's ``_epoch`` runs."""
    out, stack = _Spans(), []
    real = timer.span

    @contextmanager
    def recording(name):
        parent, inside = (stack[-1] if stack else None), out.in_epoch
        stack.append(name)
        try:
            with real(name) as s:
                yield s
        finally:
            stack.pop()
        out.append((name, parent, s, inside))

    for module in (timer, scan, sd, train, graph, parser):
        monkeypatch.setattr(module, "span", recording)
    return out


class _Spans(list):
    in_epoch = False

    def named(self, name):
        return [s for n, _, s, _ in self if n == name]

    def nesting(self):
        return {n: p for n, p, _, _ in self}


def _dds(device=CPU):
    ds = make_synthetic_dataset("trace", n_nodes=300, n_edges=4000, input_dim=12, n_classes=4,
                                n_train=150, n_val=60, feature_nnz_per_row=4,
                                n_communities=4)
    return to_device(ds, device=device)


def _cfg(mode="scan", epochs=4):
    cfg = Config()
    cfg.gcn.hidden_dims, cfg.gcn.dropouts = (8,), (0.0, 0.3)
    cfg.gcn.epochs, cfg.gcn.early_stopping = epochs, 0
    cfg.tpu.backend, cfg.tpu.seed = "segment", SEED
    cfg.train.verbose, cfg.train.mode = False, mode
    return cfg


def _inside(spans) -> bool:
    """Every span lies inside the run's own span, which closed last."""
    whole = spans[-1][2]
    return all(whole.start_s <= s.start_s <= s.end_s <= whole.end_s for _, _, s, _ in spans)


@pytest.mark.parametrize("mode", ["scan", "eager"])
def test_fit_records_its_phases(mode, spans):
    dds = _dds()
    del spans[:]
    res = train.fit(_cfg(mode), dds)
    assert spans.nesting() == NESTING[mode] and len(spans) == len(NESTING[mode])
    assert _inside(spans) and spans[-1][0] == "fit"
    assert all(s.name == timer.PREFIX + n for n, _, s, _ in spans)
    if mode == "scan":
        # off CUDA the loop prepares nothing, so its set-up reads 0; the
        # epochs run in the replays' span
        assert res.setup_time_s == 0.0 and res.replays == 0
        (replays,) = spans.named("scan.replays")
        assert res.avg_epoch_time_s * res.epochs_run == pytest.approx(replays.seconds,
                                                                      rel=1e-9)


def test_fit_seeds_records_its_lanes(spans):
    dds = _dds()
    del spans[:]
    res = sd.fit_seeds(_cfg(), dds, [SEED, 7])
    assert spans.nesting() == NESTING["seeds"] and len(spans) == len(NESTING["seeds"])
    assert _inside(spans) and spans[-1][0] == "fit_seeds"
    (replays,) = spans.named("scan.replays")
    assert res.avg_epoch_time_s * 4 == pytest.approx(replays.seconds, rel=1e-9)


def test_the_loop_times_are_read_off_its_spans(monkeypatch, spans):
    # prepare as on CUDA: 1 eager epoch first, so 3 of 4 epochs are queued after it
    def prepare(self):
        self._epoch()
        self.queued = 1

    monkeypatch.setattr(ScanLoop, "prepare", prepare)
    loop = train.make_scan_loop(*_loop_parts())
    del spans[:]
    res = loop.run()
    (replays,), (prepared,) = spans.named("scan.replays"), spans.named("scan.prepare")
    assert res.epoch_s * 3 == pytest.approx(replays.seconds, rel=1e-9)
    assert prepared.seconds > 0
    assert [n for n, _, _, _ in spans] == ["scan.prepare", "scan.replays", "scan.result"]


def _loop_parts():
    cfg, dds = _cfg(), _dds()
    model = train.build_model(cfg, dds)
    opt = train.init_adam(list(model.weights))
    return model, cfg, dds, opt, torch.Generator().manual_seed(3)


def test_the_verbose_scan_prints_the_phases(capsys):
    cfg = _cfg()
    cfg.train.verbose = True
    train.fit(cfg, _dds())
    out = capsys.readouterr().out
    line = next(ln for ln in out.splitlines() if ln.startswith("phases: "))
    assert all(f"{name} " in line for name in ("build", "preagg", "scan.prepare",
                                               "scan.replays", "scan.result"))


def test_a_run_span_keeps_its_phases_and_restores_the_outer_run():
    assert timer.run_phases() is None
    with timer.run_span("fit"):
        assert timer.run_phases() == ""
        with timer.span("build"):
            with timer.span("preagg"):
                pass
        with timer.run_span("fit_seeds"):
            with timer.span("test_eval"):
                pass
            assert timer.run_phases().startswith("test_eval ")
        phases = timer.run_phases()
    assert timer.run_phases() is None
    # the spans closed in the run, in the order they opened; the inner run's
    # span and its phases are its own
    assert [p.split(" ")[0] for p in phases.split(", ")] == ["build", "preagg"]


def test_no_span_opens_inside_an_epoch(monkeypatch, spans):
    """The spans note whether an epoch runs as they open, and the count of
    spans does not grow with the epochs."""
    epochs = [0]

    def watched(epoch):
        def run(self):
            spans.in_epoch = True
            epochs[0] += 1
            try:
                epoch(self)
            finally:
                spans.in_epoch = False
        return run

    monkeypatch.setattr(ScanLoop, "_epoch", watched(ScanLoop._epoch))
    monkeypatch.setattr(LaneScanLoop, "_epoch", watched(LaneScanLoop._epoch))
    dds = _dds()
    counts = []
    for run in (lambda: train.fit(_cfg(epochs=3), dds), lambda: train.fit(_cfg(epochs=6), dds),
                lambda: sd.fit_seeds(_cfg(epochs=3), dds, [1, 2])):
        before = len(spans)
        run()
        counts.append(len(spans) - before)
    assert epochs[0] == 3 + 6 + 3 and spans
    assert not [n for n, _, _, inside in spans if inside]
    assert counts[0] == counts[1]


def test_checkpoints_are_spans_and_keep_their_seconds(tmp_path, spans):
    cfg = _cfg(epochs=4)
    cfg.train.checkpoint_dir, cfg.train.checkpoint_every = str(tmp_path), 2
    res = train.fit(cfg, _dds())
    # epoch 2 between the replays, then the final one
    assert [p for n, p, _, _ in spans if n == "checkpoint"] == ["scan.replays", "fit"]
    assert res.checkpoint_s == [s.seconds for s in spans.named("checkpoint")]


def test_spans_reach_the_profiler():
    from torch.profiler import ProfilerActivity, profile

    dds = _dds()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        train.fit(_cfg(), dds)
    events = [(e.name[len(timer.PREFIX):], e.time_range.start, e.time_range.end)
              for e in prof.events() if e.name.startswith(timer.PREFIX)]
    assert sorted(n for n, _, _ in events) == sorted(NESTING["scan"])
    (lo, hi), = [(s, e) for n, s, e in events if n == "fit"]
    assert all(lo <= s <= e <= hi for _, s, e in events)


def test_the_data_set_up_keeps_its_keys_and_spans_them(spans):
    cfg = Config()
    cfg.tpu.backend, cfg.tpu.reorder = "segment", "community"
    spec = dict(n_nodes=400, n_edges=5000, input_dim=10, n_classes=4, n_train=200, n_val=80,
                feature_nnz_per_row=4)
    ds = prepare_host_dataset(cfg, "synth-medium", spec=spec)
    _, dds = prepare_device_dataset(cfg, "synth-medium", CPU, host=ds)
    assert {"load_s", "reorder_s", "permute_s"} <= set(ds.setup)
    assert {"pack_s", "copy_s"} <= set(dds.setup)
    got: dict = {}
    for name, parent, s, _ in spans:
        assert parent is None
        got[name] = got.get(name, 0.0) + s.seconds
    for key, setup in (("load", ds.setup), ("reorder", ds.setup), ("permute", ds.setup),
                       ("pack", dds.setup), ("copy", dds.setup)):
        assert setup[f"{key}_s"] == pytest.approx(got[f"data.{key}"], rel=1e-12)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA graph capture)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_a_scan_on_the_card_records_one_capture(card, spans):
    dds = _dds(card)
    del spans[:]
    res = train.fit(_cfg(epochs=5), dds)
    assert [p for n, p, _, _ in spans if n == "scan.capture"] == ["scan.prepare"]
    (prepared,), (replays,) = spans.named("scan.prepare"), spans.named("scan.replays")
    assert res.setup_time_s == prepared.seconds > 0
    assert res.avg_epoch_time_s * res.replays == pytest.approx(replays.seconds, rel=1e-9)
