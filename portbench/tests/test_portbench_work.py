"""The work counts against hand counts on toy shapes, and the readers that
turn a trace into shares of the peak and of the roofline."""

import pytest

from portbench import devtrace, harness
from portbench.metrics import agg_roofline, idle_pct, mem_growth_mib, mfu_pct
from portbench.reference import gcn, sage

P = {"n_layers": 2, "hidden_dims": 5, "dropouts": [0.0, 0.5]}


def test_gcn_work_by_hand():
    # N=10 nodes, nnz=30, 4 -> 5 -> 3. Layer 0 reads Â·X (no input dropout):
    # forward and dW 2·10·4·5 each; its val product is the next train one.
    # Layer 1: forward, dW, dX and val 2·10·5·3 each; Â at 3 columns in the
    # forward, the backward and the val forward.
    # The val forward shares its read of Â with the train forward (the
    # previous update's weights); the backward waits for the forward.
    w = gcn.work(P, 10, 30, 4, 3)
    assert w["flops"] == 2 * 400 + 4 * 300 + 3 * 2 * 30 * 3
    assert w["agg"] == [(3, 3), (3,)] and w["agg_run"] == [(4,)]


def test_gcn_work_with_input_dropout_aggregates_layer_0():
    w = gcn.work({**P, "dropouts": [0.5, 0.5]}, 10, 30, 4, 3)
    assert w["flops"] == 3 * 400 + 4 * 300 + 3 * 2 * 30 * 5 + 3 * 2 * 30 * 3
    assert w["agg"] == [(5, 5), (5,), (3, 3), (3,)] and w["agg_run"] == []


def test_sage_work_by_hand():
    # two products a layer (self, neigh); layer 0: forward and dW; layer 1:
    # forward, dW, dX and val; Â at 5 (forward, backward), at 3 (and val)
    w = sage.work(P, 10, 30, 4, 3)
    assert w["flops"] == 2 * 2 * 400 + 2 * 4 * 300 + 2 * 2 * 30 * 5 + 3 * 2 * 30 * 3
    assert w["agg"] == [(5,), (5,), (3, 3), (3,)]


class _Run:
    def __init__(self, epochs, lanes=1, allocated=None):
        self.epochs_run, self.seconds, self.replays, self.epoch_s = [epochs] * lanes, 1.0, 0, 0.0
        self.graph_launches, self.allocated_bytes = {}, allocated


def _ctx(ops, window=(0.0, 2.0), intervals=((0.0, 0.5), (0.25, 1.0)), runs=None, n=1000,
         nnz=10_000, params=P, dims=(4, 3), peaks=(1e12, 1e11, 1e9)):
    tr = devtrace.Trace(ops=ops, intervals=list(intervals), host=[], window=window)
    cell = harness.Cell(name="t", workload={}, config={"family": "gcn"},
                        traffic={"lanes": 1})
    work = gcn.work(params, n, nnz, *dims)
    return harness.Context(cell=cell, runs=runs or [_Run(10)], setup={}, trace=tr, work=work,
                           graph=dict(n=n, nnz=nnz, input_dim=dims[0], n_classes=dims[1],
                                      dtype_bytes=2),
                           peaks=dict(zip(("bf16_flops", "f32_flops", "bytes_per_s"), peaks)))


def test_roofline_share_by_hand():
    # per epoch two reads of Â: the train and the val forward at 3 columns,
    # (1e4·8 + 2·1e3·(3+3)·2)/1e9 = 104e-6 s (over 2·1e4·6/1e12), and the
    # backward, (1e4·8 + 2·1e3·3·2)/1e9 = 92e-6 s; once a run Â·X at 4 f32
    # columns: (8e4 + 2·1e3·4·4)/1e9 = 112e-6 s
    ctx = _ctx({"spmm_pipe_kernel<x>": [0.05, 30], "pgcn_seg::items_walk_kernel": [0.01, 30]})
    least = 10 * (104e-6 + 92e-6) + 112e-6
    assert agg_roofline.read(ctx) == pytest.approx(100 * least / 0.06)


def test_roofline_share_of_a_seed_batch_by_hand():
    # 4 lanes read Â once a group: (8e4 + 4·2·1e3·6·2)/1e9 = 176e-6 s and
    # (8e4 + 4·2·1e3·3·2)/1e9 = 128e-6 s an epoch; Â·X once a run, 112e-6
    ctx = _ctx({"spmm_pipe_kernel<x>": [0.05, 30]}, runs=[_Run(10, lanes=4), _Run(10, lanes=4)])
    least = 2 * (10 * (176e-6 + 128e-6) + 112e-6)
    assert agg_roofline.read(ctx) == pytest.approx(100 * least / 0.05)


def test_roofline_least_time_of_the_reddit_cells_by_hand():
    """gcn-reddit (602 -> 600 -> 41, dropouts 0 / 0.1, bf16) at Reddit's sizes:
    an epoch reads Â twice, at 41 + 41 columns and at 41, whether one lane
    trains or four; the lanes add their activations only."""
    n, nnz = 232_965, 11_839_884
    params = {"n_layers": 2, "hidden_dims": 600, "dropouts": [0.0, 0.1]}
    kw = dict(n=n, nnz=nnz, params=params, dims=(602, 41), peaks=(989e12, 67e12, 3.35e12))
    ops = {"spmm_pipe_kernel<x>": [1.0, 1]}
    one = agg_roofline.read(_ctx(ops, runs=[_Run(1)], **kw))
    four = agg_roofline.read(_ctx(ops, runs=[_Run(1, lanes=4)], **kw))
    ax = (nnz * 8 + 2 * n * 602 * 4) / 3.35e12
    solo = (2 * nnz * 8 + 2 * n * 2 * (82 + 41)) / 3.35e12
    batch = (2 * nnz * 8 + 4 * 2 * n * 2 * (82 + 41)) / 3.35e12
    assert one == pytest.approx(100 * (solo + ax))
    assert four == pytest.approx(100 * (batch + ax))


def test_mfu_and_idle_by_hand():
    ctx = _ctx({"nvjet_gemm": [0.5, 10]})
    flops = 10 * ctx.work["flops"] + 2 * 10_000 * 4
    assert mfu_pct.read(ctx) == pytest.approx(100 * flops / (2.0 * 1e12))
    assert idle_pct.read(ctx) == pytest.approx(50.0)


def test_memory_growth_by_hand():
    runs = [_Run(10, allocated=a * 2**20) for a in (100, 164, 228, 292)]
    assert mem_growth_mib.read(_ctx({}, runs=runs)) == pytest.approx(64.0)
    assert mem_growth_mib.read(_ctx({}, runs=runs[:1])) is None
    assert mem_growth_mib.read(_ctx({}, runs=[_Run(10), _Run(10)])) is None


def test_idle_gaps_are_named_by_span_and_innermost_host_op():
    tr = devtrace.Trace(ops={}, intervals=[(0.0, 1.0), (1.5, 2.0)],
                        host=[("portbench::run", 0.0, 2.0), ("aten::to", 1.1, 1.4),
                              ("aten::copy_", 1.2, 1.3)], window=(0.0, 2.0))
    assert tr.idle_gaps() == [("portbench::run / aten::to", pytest.approx(0.5))]
    assert tr.busy_s() == pytest.approx(1.5)
