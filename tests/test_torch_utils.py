"""The port's utils/timer and utils/profiling against the JAX package's
timer, on the CPU; the profiler's op table and its lost-record check."""

import time

import pytest
import torch

from parallel_gcn_tpu.utils.timer import Timer as JaxTimer
from parallel_gcn_tpu_torch.config import Config
from parallel_gcn_tpu_torch.data.parser import to_device
from parallel_gcn_tpu_torch.data.synthetic import make_synthetic_dataset
from parallel_gcn_tpu_torch.optim import init_adam
from parallel_gcn_tpu_torch.train import build_model, epoch_seeds, make_epoch_step
from parallel_gcn_tpu_torch.utils import profiling
from parallel_gcn_tpu_torch.utils import timer as timer_mod
from parallel_gcn_tpu_torch.utils.timer import Timer

torch.set_num_threads(1)


def _fake_clock(monkeypatch, ticks):
    it = iter(ticks)
    monkeypatch.setattr(time, "perf_counter", lambda: next(it))


def test_timer_totals_averages_and_report_match_jax(monkeypatch):
    # the same start/stop sequence on a fake clock through both timers
    ticks = [0.0, 0.25, 1.0, 1.5, 2.0, 2.125, 3.0, 3.001]
    names = ["epoch", "epoch", "epoch", "eval"]
    reports, totals = [], []
    for timer in (Timer("cpu"), JaxTimer()):
        _fake_clock(monkeypatch, list(ticks))
        spans = []
        for name in names:
            timer.start(name)
            spans.append(timer.stop(name))
        assert spans == pytest.approx([0.25, 0.5, 0.125, 0.001])
        totals.append((timer.total("epoch"), timer.average("epoch"), timer.total("eval")))
        reports.append(timer.report())
    assert totals[0] == totals[1] == pytest.approx((0.875, 0.875 / 3, 0.001))
    assert reports[0] == reports[1]
    assert "epoch: total=0.875000s avg=291.6667ms n=3" in reports[0]


def test_timer_on_cpu_reads_the_host_clock():
    timer = Timer("cpu")
    for _ in range(2):
        timer.start("sleep")
        time.sleep(0.01)
        timer.stop("sleep")
    assert 0.02 <= timer.total("sleep") < 1.0
    assert timer.average("sleep") == pytest.approx(timer.total("sleep") / 2)
    assert timer.average("never") == 0.0


def _small_step():
    ds = make_synthetic_dataset("prof", n_nodes=200, n_edges=2000, input_dim=16, n_classes=4,
                                n_train=100, n_val=50, feature_nnz_per_row=4, n_communities=4)
    cfg = Config()
    cfg.gcn.hidden_dims, cfg.gcn.dropouts = (8,), (0.0, 0.2)
    cfg.tpu.backend = "segment"
    dds = to_device(ds, device=torch.device("cpu"))
    model = build_model(cfg, dds)
    step = make_epoch_step(model, cfg, dds)
    opt = init_adam(list(model.weights))
    gen = torch.Generator().manual_seed(0)
    return lambda: step(opt, epoch_seeds(gen, 2)).tolist()


def test_op_table_of_a_cpu_profile(capsys):
    out, prof = profiling.profile_fn(_small_step(), reps=2, device="cpu")
    assert len(out) == 4 and prof.device == "cpu" and prof.steps == 2
    assert len(prof.host_ms) == 2 and prof.attempts == 1 and not prof.shortfall
    rows = profiling.summarize_trace(prof, top=8)
    assert 0 < len(rows) <= 8
    assert all(isinstance(n, str) and ms > 0 and c > 0 for n, ms, c in rows)
    assert [ms for _, ms, _ in rows] == sorted((ms for _, ms, _ in rows), reverse=True)
    names = {n for n, _, _ in profiling.summarize_trace(prof, top=1000)}
    assert "aten::mm" in names and not any(n.startswith("ProfilerStep") for n in names)
    profiling.print_trace_summary(prof, top=3)
    ms = profiling.report("small step", prof)
    text = capsys.readouterr().out
    assert len([ln for ln in text.splitlines() if " ms  x" in ln]) == 3
    assert "in CPU ops (self time; the CPU, no device time)" in text
    assert "device idle" not in text and ms == pytest.approx(prof.op_ms)


def _trace(names):
    return {"traceEvents": [{"ph": "X", "cat": "kernel", "name": n, "dur": 10.0} for n in names]
            + [{"ph": "X", "cat": "cpu_op", "name": "aten::mm", "dur": 99.0}]}


K2 = "void (anonymous namespace)::dropout_kernel<__nv_bfloat16, true>(args)"
K2_LANES = "void (anonymous namespace)::dropout_lanes_kernel<__nv_bfloat16, true>(args)"
K4 = "void spmm_pipe_kernel<signed char, __nv_bfloat16, true>(args)"
WALK = "void pgcn_seg::items_walk_kernel<__nv_bfloat16, 4, GatherOp>(args)"
K4_F32 = "void (anonymous namespace)::spmm_walk_kernel<4, 2>(args)"
K4_WIDE = "void (anonymous namespace)::spmm_pipe_kernel_wgmma<true>(CUtensorMap_st, args)"
BCSR = "bcsr/bcsr_scaled/bcsr_rect/bcsr_f32/bcsr_scaled_f32/bcsr_rect_f32/bcsr_scaled_wide"


def test_lost_record_flag_on_a_trace_missing_a_launch(capsys):
    ops = profiling.trace_ops(_trace([K2, K2_LANES, K4, WALK, WALK]))
    assert ops[K4] == [pytest.approx(0.01), 1] and "aten::mm" not in ops
    whole = {"relu_dropout": 1, "relu_dropout_lanes": 1, "bcsr_scaled": 1, "gather_sum": 2}
    assert profiling.lost_records(ops, whole) == {}
    short = profiling.lost_records(ops, {**whole, "bcsr_scaled": 2, "dropout": 1})
    assert short == {BCSR: (1, 2), "dropout/relu_dropout": (1, 2)}
    prof = profiling.Profile(device="cuda", steps=1, ops=ops, host_ms=[1.0], records=5,
                             shortfall=short, attempts=2)
    profiling.report("built short", prof, host_ms=1.0)
    text = capsys.readouterr().out
    assert "the trace is short after 2 traces" in text
    assert f"{BCSR} 1 records of 2 launches" in text
    assert "device idle 95.0%" in text  # 0.05 ms of kernels in 1 ms


def test_f32_tile_spmm_launches_are_checked():
    # the f32 body's launches count under their own keys, its records by the walk kernel
    ops = profiling.trace_ops(_trace([K4_F32, K4]))
    assert profiling.lost_records(ops, {"bcsr_scaled_f32": 1, "bcsr_scaled": 1}) == {}
    assert profiling.lost_records(ops, {"bcsr_f32": 2, "bcsr_scaled": 1}) == {BCSR: (2, 3)}


def test_wide_tile_spmm_launches_are_checked():
    # K4's wide body counts under its own key, its records by the pipe kernels' name
    ops = profiling.trace_ops(_trace([K4_WIDE, K4_WIDE, K4]))
    assert profiling.lost_records(ops, {"bcsr_scaled_wide": 2, "bcsr_scaled": 1}) == {}
    assert profiling.lost_records(ops, {"bcsr_scaled_wide": 3, "bcsr_scaled": 1}) == {
        BCSR: (3, 4)}


def test_a_short_trace_is_profiled_once_more():
    calls = []
    # a CPU trace holds no kernel record, so any counted launch is missing
    _, prof = profiling.profile_fn(lambda: calls.append(1), reps=2, warmup=1, device="cpu",
                                   per_step={"dropout": 1})
    assert len(calls) == 2 * (1 + 2) and prof.attempts == 2
    assert prof.shortfall == {"dropout/relu_dropout": (0, 2)}


@pytest.mark.parametrize("name, cat", [
    (K2_LANES, "K2 relu_dropout (lanes)"),
    ("void (anonymous namespace)::dropout_lanes_kernel<float, false>(x)", "K1 dropout (lanes)"),
    ("void (anonymous namespace)::dropout_lanes_bwd_kernel<__nv_bfloat16>(x)",
     "K2 relu_dropout backward (lanes)"),
    ("void (anonymous namespace)::dx_wfrag_kernel(x)", "K10 fused dX (lanes)"),
    ("void (anonymous namespace)::fwd_fma_shared_kernel<1>(x)", "K10 fused fwd (lanes)"),
    (K2, "K2 relu_dropout"),
    ("void (anonymous namespace)::dropout_kernel<float, false>(x)", "K1 dropout"),
    (K4, "K3/K4 tile SpMM"), (K4_F32, "K3/K4 tile SpMM"), (K4_WIDE, "K3/K4 tile SpMM"),
    (WALK, "scatter/index (residual)"),
    ("sm90_xmma_gemm_bf16bf16_bf16f32", "GEMMs"), ("Memcpy DtoD", "copies"),
    ("elementwise_kernel<add>", "other elementwise")])
def test_categories(name, cat):
    assert profiling.category(name) == cat


def test_events_ms_is_the_median_of_batch_means(monkeypatch):
    # CUDA events stood in for by a fake clock that each call advances
    clock = [0.0]

    class Event:
        def __init__(self, enable_timing):
            assert enable_timing

        def record(self):
            self.t = clock[0]

        def elapsed_time(self, end):
            return (end.t - self.t) * 1e3

    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    durations = iter([0.1] + [0.001] * 14 + [0.05] + [0.001] * 5)  # warm-up, then 20 calls

    def fn():
        clock[0] += next(durations)

    # batches of 7, 7 and 6 calls: 1 ms, 1 ms and (50 + 5) / 6 ms a call
    assert timer_mod.events_ms(fn, 20) == pytest.approx(1.0)
    assert next(durations, None) is None
