"""Seed-batched whole run: S GCN training runs over one graph at once.

The counterpart of the JAX harnesses' ``jax.vmap(one)`` over
``train._make_scan_run`` (``harness/accuracy.py:62-73``, ``tuning.py``,
``seed_select.py``), which train N seeds in one program. ``fit_seeds(cfg,
dds, seeds)`` runs lane s as ``train.fit`` runs ``cfg`` with ``seed=s``: the
Glorot init from a generator seeded s, the dropout seeds of ``epoch_seeds``
from another seeded s in the same order, the same Adam and L2 on W0 only,
and, with early stopping off, the deferred-eval schedule.

What the lanes share: Â, X and the pre-aggregated Â·X, and every
aggregation. A lane's activations sit side by side with the others' as
[rows, S·F], lane s in columns s·F … s·F+F−1, so each layer's aggregation
is one ``graphsum`` over S·F columns (the tile SpMM and the ordered sums
compute each column alone, so a lane's columns are those of its solo run),
and the dropout kernels mask every lane in one launch with lane s's seed at
lane s's solo element index (``ops.cuda_dropout``, seed lanes). The
deferred eval stacks train | val per lane.

What each lane keeps: its weights, Adam state, loss, accuracy and L2. The
GEMMs run lane by lane on contiguous [rows, F] operands, the shapes of a
solo run, and every reduction runs over a solo run's shapes, so on the card
lane s is ``fit(seed=s)`` bit for bit on the tile and segment backends (the
dense backend's Â·[N, S·F] is one cuBLAS product whose algorithm follows
the shape). A batched GEMM is later speed work.

Early stopping runs per lane, as the JAX loop does under ``vmap``
(``train.py:736-770``): a stop flag a lane; a stopped lane's weights, Adam
state, history and epoch counter are held with ``torch.where``; the run
ends when every lane has stopped, the host reading the flags every
``scan.POLL_EPOCHS`` epochs. On CUDA the epoch is captured once as one CUDA
graph (``scan.ScanLoop``); on the CPU the same epoch runs uncaptured.
"""

from __future__ import annotations

import copy
import time
from dataclasses import dataclass, field
from typing import Callable, Sequence

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from parallel_gcn_tpu_torch.config import Config
from parallel_gcn_tpu_torch.data.parser import TEST, TRAIN, VAL, DeviceDataset
from parallel_gcn_tpu_torch.models.gcn import GCNModel, layer_entry
from parallel_gcn_tpu_torch.ops.loss import l2_penalty
from parallel_gcn_tpu_torch.ops.sparse_matmul import feature_transform
from parallel_gcn_tpu_torch.optim import AdamState, adam_step, init_adam
from parallel_gcn_tpu_torch.scan import ScanLoop, ScanResult
from parallel_gcn_tpu_torch.train import (_ce_fn, _eval_inputs, build_model, epoch_seeds,
                                          init_weights, l2_term, preaggregate_input,
                                          scan_schedule)

_QUEUED = "ROADMAP Queue 1"


@dataclass
class SeedsResult:
    seeds: list[int]
    history: list[np.ndarray]  # lane s: [epochs_run[s], 4] as FitResult.history
    epochs_run: list[int]
    val_loss: np.ndarray  # [S]: the last recorded epoch's val loss and accuracy
    val_acc: np.ndarray
    test_loss: np.ndarray  # [S]: on each lane's final weights
    test_acc: np.ndarray
    weights: list[list[torch.Tensor]]  # lane s's float32 weights
    # the host time of epochs 2..N (on CUDA the graph's replays), one sync, per epoch
    avg_epoch_time_s: float
    total_time_s: float
    setup_time_s: float = 0.0  # CUDA: epoch 1 (eager) and the capture
    replays: int = 0
    graph_launches: dict = field(default_factory=dict)  # kernels, collectives a replay


def check_config(cfg: Config) -> None:
    """Refuse what a seed batch does not run, naming where it is queued."""
    if cfg.gcn.model != "gcn":
        raise ValueError(f"fit_seeds trains the GCN; seed batches of model={cfg.gcn.model} are "
                         f"queued ({_QUEUED}: seed batches for SAGE, GIN and the GAT)")
    if cfg.tpu.fuse_dropout_matmul:
        raise ValueError("fit_seeds has no fused dropout⊗matmul (K10 takes one seed); "
                         "set fuse_dropout_matmul=false")
    if cfg.tpu.n_devices > 1 or cfg.tpu.tp > 1:
        raise ValueError("fit_seeds trains on one device; seed batches of the mesh are not "
                         f"ported ({_QUEUED})")
    if cfg.train.mode == "eager":
        raise ValueError("fit_seeds runs the whole-run path (mode=scan), as the JAX harnesses "
                         "batch only the whole-run program")


class _Join(torch.autograd.Function):
    """Per-lane [rows, F] tensors side by side as [rows, S·F]; the backward
    hands each lane a contiguous [rows, F] cotangent, as its solo run's."""

    @staticmethod
    def forward(ctx, *parts):
        ctx.widths = [p.shape[1] for p in parts]
        return torch.cat(parts, dim=1)

    @staticmethod
    def backward(ctx, g):
        return tuple(p.contiguous() for p in g.split(ctx.widths, dim=1))


class _Split(torch.autograd.Function):
    """[rows, S·F] as S contiguous [rows, F] tensors (the inverse of
    ``_Join``)."""

    @staticmethod
    def forward(ctx, x, lanes):
        return tuple(p.contiguous() for p in x.chunk(lanes, dim=1))

    @staticmethod
    def backward(ctx, *grads):
        return torch.cat(grads, dim=1), None


class _StackedLanes(torch.autograd.Function):
    """The deferred schedule's last aggregation over lanes: per lane the
    train half ``a_t`` and the val half ``a_e`` side by side, all lanes in
    one ``aggregate``; returns each lane's aggregated train half, then each
    lane's val half. The gradient flows to the train halves only, as the
    aggregation of their cotangents (``train._StackedAggregate`` per lane)."""

    @staticmethod
    def forward(ctx, aggregate, lanes, *halves):
        ctx.aggregate, ctx.lanes = aggregate, lanes
        a_t, a_e = halves[:lanes], halves[lanes:]
        c = a_t[0].shape[1]
        out = aggregate(torch.cat([t for pair in zip(a_t, a_e) for t in pair], dim=1))
        lt = [out[:, 2 * c * s:2 * c * s + c].contiguous() for s in range(lanes)]
        le = [out[:, 2 * c * s + c:2 * c * (s + 1)].contiguous() for s in range(lanes)]
        ctx.mark_non_differentiable(*le)
        return (*lt, *le)

    @staticmethod
    def backward(ctx, *grads):
        lanes = ctx.lanes
        g = ctx.aggregate(torch.cat(grads[:lanes], dim=1))
        return (None, None, *(p.contiguous() for p in g.chunk(lanes, dim=1)),
                *([None] * lanes))


class LaneGCN:
    """The GCN forward of S lanes over ``model``'s aggregation and knobs
    (``models.gcn.GCNModel``, whose own weights are lane 0's), lane s with
    the weights ``weights[s]``. A layer's input is ``joined`` ([rows, S·F])
    or one [rows, F] tensor that every lane reads (the input features)."""

    def __init__(self, model: GCNModel, weights: list[list[torch.Tensor]]):
        self.model, self.weights, self.lanes = model, weights, len(weights)

    def layer_pre(self, h, joined: bool, layer: int, seed, training: bool,
                  pre_relu: bool) -> list[torch.Tensor]:
        """Each lane's ``GCNModel.layer_pre``: [relu →] dropout (one launch
        over the lanes, ``seed`` a slot of S seeds) → its feature transform."""
        m = self.model
        if training and m.dropouts[layer] > 0 and not joined:
            raise ValueError("a lane's dropout masks its own columns: pass the input as "
                             "[rows, S·F]")
        h = layer_entry(h, m.dropouts[layer], seed, training, pre_relu)
        parts = _Split.apply(h, self.lanes) if joined else [h] * self.lanes
        return [feature_transform(p, w[layer], m.compute_dtype)
                for p, w in zip(parts, self.weights)]

    def _layer(self, h, joined: bool, graph, layer: int, seed, training: bool,
               skip_agg: bool):
        out = _Join.apply(*self.layer_pre(h, joined, layer, seed, training,
                                          self.model.defers_relu(layer)))
        return out if skip_agg else self.model.aggregate(out, graph)

    def layer(self, h, joined: bool, graph, layer: int, seed, training: bool,
              skip_agg: bool):
        """Layer ``layer`` over the lanes, [rows, S·F'] (``GCNModel.layer``,
        recomputed in the backward with ``remat``)."""
        args = (h, joined, graph, layer, seed, training, skip_agg)
        if self.model.remat and training:
            return checkpoint(self._layer, *args, use_reentrant=False,
                              preserve_rng_state=False)
        return self._layer(*args)

    def prefix(self, x, joined: bool, graph, *, training: bool, seeds: Sequence,
               preagg: bool) -> tuple[torch.Tensor, bool]:
        """Layers 0..L-2 (``GCNModel.prefix``): (their output, joined)."""
        m = self.model
        h = x.to(m.compute_dtype)
        prev = None
        for layer in range(m.n_layers - 1):
            h = self.layer(h, joined, graph, layer, seeds[layer], training,
                           layer == 0 and preagg)
            joined = True
            if m.residual:
                if layer > 0 and prev is not None and prev.shape == h.shape:
                    h = h + prev
                h = torch.relu(h)
                prev = h
        return h, joined

    def forward(self, x, joined: bool, graph, *, training: bool, seeds: Sequence,
                preagg: bool) -> list[torch.Tensor]:
        """Each lane's logits, float32 [rows, C] (``GCNModel.forward``)."""
        last = self.model.n_layers - 1
        h, joined = self.prefix(x, joined, graph, training=training, seeds=seeds, preagg=preagg)
        out = self.layer(h, joined, graph, last, seeds[last], training, last == 0 and preagg)
        return [p.float() for p in _Split.apply(out, self.lanes)]

    def deferred(self, x_train, train_joined: bool, x_eval, graph, seeds, *,
                 train_preagg: bool, eval_preagg: bool):
        """Each lane's train logits and deferred val logits
        (``train.fused_deferred_forward``), float32."""
        m, lanes = self.model, self.lanes
        L = m.n_layers
        share = all(d == 0 for d in m.dropouts[:L - 1]) and train_preagg == eval_preagg
        ht, joined = self.prefix(x_train, train_joined, graph, training=True, seeds=seeds,
                                 preagg=train_preagg)
        pre_relu = m.defers_relu(L - 1)
        at = self.layer_pre(ht, joined, L - 1, seeds[L - 1], True, pre_relu)
        with torch.no_grad():
            he, e_joined = (ht, joined) if share else self.prefix(
                x_eval, False, graph, training=False, seeds=[None] * L, preagg=eval_preagg)
            ae = self.layer_pre(he, e_joined, L - 1, None, False, pre_relu)
        out = _StackedLanes.apply(lambda h: m.aggregate(h, graph), lanes, *at, *ae)
        return [t.float() for t in out[:lanes]], [t.float() for t in out[lanes:]]


class LaneSeedSlots:
    """The device memory the dropout kernels read a lane batch's seeds from:
    int64 [n_layers, S]; ``slots[l]`` is layer l's S seeds (``scan.SeedSlots``
    over lanes)."""

    def __init__(self, n_layers: int, lanes: int, device):
        self.buf = torch.zeros((n_layers, lanes), dtype=torch.int64, device=device)
        self.slots = list(self.buf.unbind())

    def load(self, rows: torch.Tensor) -> None:
        """Write the next epoch's seeds, ``rows`` int64 [S, n_layers]."""
        self.buf.copy_(rows.t())


class LaneScanLoop(ScanLoop):
    """``scan.ScanLoop`` over S lanes: ``step(slots)`` returns each lane's
    metrics [4]; ``lane_state[s]`` lists what lane s's step updates in place;
    ``table`` is int64 [S, epochs, n_layers]. Each lane keeps its own epoch
    counter, history and stop flag, with the solo loop's operations on each
    (so a lane stops where its solo run stops); ``stopped`` is set when every
    lane has stopped."""

    def __init__(self, step: Callable, *, lane_state: list[list[torch.Tensor]], seeds,
                 table: torch.Tensor, k: int, final_val: Callable | None, device):
        super().__init__(step, state=[t for st in lane_state for t in st], seeds=seeds,
                         table=table, k=k, final_val=final_val, device=device)
        lanes = len(lane_state)
        self.lane_state = lane_state
        self.lane_ids = torch.arange(lanes, device=self.device)
        self.lane_idx = torch.zeros(lanes, dtype=torch.int64, device=self.device)
        self.lane_stopped = torch.zeros(lanes, dtype=torch.bool, device=self.device)
        self.history = torch.zeros((lanes, self.epochs, 4), dtype=torch.float32,
                                   device=self.device)

    def _epoch(self) -> None:
        self.seeds.load(self.table[self.lane_ids, self.lane_idx])
        k = self.k
        if k:
            saved = [[t.detach().clone() for t in st] for st in self.lane_state]
            was_stopped = self.lane_stopped.clone()
        rows = self.step(self.seeds.slots)
        with torch.no_grad():
            for s, metrics in enumerate(rows):
                idx, hist = self.lane_idx[s:s + 1], self.history[s]
                if k:
                    was = was_stopped[s]
                    for t, old in zip(self.lane_state[s], saved[s]):
                        t.copy_(torch.where(was, old, t))
                    metrics = torch.where(was, hist.index_select(0, idx)[0], metrics)
                hist.index_copy_(0, idx, metrics.view(1, 4))
                if k:
                    last_k = hist[:, 2].index_select(0, (idx + self.window).clamp(min=0))
                    self.lane_stopped[s].logical_or_(
                        (idx[0] + 1 >= k) & (metrics[2] > last_k.mean()))
                    idx.add_((~was).long())
                else:
                    idx.add_(1)
            if k:
                self.stopped.copy_(self.lane_stopped.all())

    def _result(self, setup_s: float, epoch_s: float, replays: int) -> ScanResult:
        """A ``ScanResult`` whose ``history`` and ``epochs_run`` are lists,
        one entry a lane."""
        if self.final_val is not None:
            with torch.no_grad():
                for hist, (loss, acc) in zip(self.history, self.final_val()):
                    val = torch.stack([loss, acc])
                    hist[:, 2:] = torch.cat([hist[1:, 2:], val[None]])
        runs = self.lane_idx.tolist()
        history = self.history.cpu().numpy()
        return ScanResult(history=[history[s, :e] for s, e in enumerate(runs)],
                          epochs_run=runs, setup_s=setup_s, epoch_s=epoch_s, replays=replays,
                          graph_launches=dict(self.graph_launches))


def _lane_metrics(logits: list, ce_fn, dds: DeviceDataset, split: int):
    """Each lane's (CE, accuracy) of ``split``."""
    mask = dds.split == split
    return [ce_fn(t, dds.labels, mask, dds.split_counts[split]) for t in logits]


def make_lane_step(lm: LaneGCN, cfg: Config, dds: DeviceDataset, x_train, train_joined: bool,
                   opt_states: list[AdamState], deferred: bool) -> Callable:
    """One epoch of every lane, ``(slots) -> [metrics[4]] a lane``: the
    plain epoch of ``train.make_epoch_step`` or the deferred one of
    ``train.make_deferred_step``, lane by lane where a lane's solo run
    reduces. Updates the lanes' weights and Adam states in place."""
    adam, model = cfg.adam, lm.model
    wd, L = adam.weight_decay, model.n_layers
    x_eval, eval_preagg = _eval_inputs(model, dds)
    ce_fn = _ce_fn(cfg)
    weights = [w for ws in lm.weights for w in ws]

    def adam_all(grads):
        for s, ws in enumerate(lm.weights):
            adam_step(ws, grads[s * L:(s + 1) * L], opt_states[s],
                      learning_rate=adam.learning_rate, weight_decay=wd, beta1=adam.beta1,
                      beta2=adam.beta2, eps=adam.eps)

    def pens():
        return [l2_term(wd, l2_penalty(ws[0])) for ws in lm.weights]

    def deferred_step(slots):
        lt, le = lm.deferred(x_train, train_joined, x_eval, dds.graph, slots,
                             train_preagg=model.input_preagg, eval_preagg=eval_preagg)
        train = _lane_metrics(lt, ce_fn, dds, TRAIN)
        with torch.no_grad():
            val = _lane_metrics(le, ce_fn, dds, VAL)
        grads = torch.autograd.grad([ce for ce, _ in train], weights)
        with torch.no_grad():
            # the L2 term of the PRE-update W0, as the solo deferred step
            rows = [torch.stack([ce.detach() + pen, acc, vce + pen, vacc])
                    for (ce, acc), (vce, vacc), pen in zip(train, val, pens())]
        adam_all(grads)
        return rows

    def plain_step(slots):
        logits = lm.forward(x_train, train_joined, dds.graph, training=True, seeds=slots,
                            preagg=model.input_preagg)
        train = _lane_metrics(logits, ce_fn, dds, TRAIN)
        grads = torch.autograd.grad([ce for ce, _ in train], weights)
        with torch.no_grad():
            train_loss = [ce.detach() + pen for (ce, _), pen in zip(train, pens())]
        adam_all(grads)
        with torch.no_grad():
            val = _lane_metrics(lm.forward(x_eval, False, dds.graph, training=False,
                                               seeds=[None] * L, preagg=eval_preagg),
                                ce_fn, dds, VAL)
            return [torch.stack([tl, acc, vce + pen, vacc])
                    for tl, (_, acc), (vce, vacc), pen in zip(train_loss, train, val, pens())]

    return deferred_step if deferred else plain_step


def make_lane_eval_fn(lm: LaneGCN, cfg: Config, dds: DeviceDataset, split: int) -> Callable:
    """``() -> [(loss, acc)] a lane`` of ``split`` on the lanes' current
    weights (``train.make_eval_fn``)."""
    wd = cfg.adam.weight_decay
    x_eval, eval_preagg = _eval_inputs(lm.model, dds)
    ce_fn = _ce_fn(cfg)

    def eval_fn():
        with torch.no_grad():
            logits = lm.forward(x_eval, False, dds.graph, training=False,
                                seeds=[None] * lm.model.n_layers, preagg=eval_preagg)
            return [(ce + l2_term(wd, l2_penalty(ws[0])), acc)
                    for (ce, acc), ws in zip(_lane_metrics(logits, ce_fn, dds, split),
                                             lm.weights)]

    return eval_fn


def lane_weights(cfg: Config, dds: DeviceDataset, seeds: Sequence[int]) -> list[list]:
    """Each lane's Glorot init, as ``train.init_weights`` draws it for
    ``cfg`` with ``seed=s``."""
    out = []
    for s in seeds:
        lane_cfg = copy.deepcopy(cfg)
        lane_cfg.tpu.seed = s
        out.append(init_weights(lane_cfg, dds.input_dim, dds.output_dim))
    return out


@dataclass
class SeedRun:
    """A seed batch ready to train: its lanes (``lm``), its whole-run loop and
    the test split's eval (``[(loss, acc)] a lane``)."""

    seeds: list[int]
    lm: LaneGCN
    loop: LaneScanLoop
    test: Callable


def seed_run(cfg: Config, dds: DeviceDataset, seeds: Sequence[int],
             weights: list[list[torch.Tensor]] | None = None) -> SeedRun:
    """Build ``fit_seeds``' batch: the lanes' weights (``weights[s]``,
    float32 in JAX leaf order, or the Glorot init of seed s), Adam states and
    seed table, the shared Â·X, and the loop over ``cfg.gcn.epochs``."""
    check_config(cfg)
    seeds = [int(s) for s in seeds]
    if not seeds:
        raise ValueError("fit_seeds needs at least one seed")
    weights = lane_weights(cfg, dds, seeds) if weights is None else weights
    if len(weights) != len(seeds):
        raise ValueError(f"{len(seeds)} seeds but {len(weights)} weight lists")
    lanes = len(seeds)
    model = build_model(cfg, dds, weights[0])
    lane_w = [list(model.weights)] + [
        [torch.nn.Parameter(w.to(dds.device).float().contiguous()) for w in ws]
        for ws in weights[1:]]
    lm = LaneGCN(model, lane_w)
    if cfg.tpu.input_preagg:
        dds = preaggregate_input(model, dds)
    # a training input dropout masks each lane's own copy of the features
    train_joined = cfg.gcn.dropouts[0] > 0
    x_train = dds.x.repeat(1, lanes) if train_joined else dds.x
    opt_states = [init_adam(ws) for ws in lane_w]
    epochs = cfg.gcn.epochs
    k, deferred = scan_schedule(model, cfg)
    table = torch.tensor(
        [[epoch_seeds(gen, model.n_layers) for _ in range(epochs)]
         for gen in (torch.Generator().manual_seed(s) for s in seeds)],
        dtype=torch.int64).reshape(lanes, epochs, model.n_layers).to(dds.device)
    loop = LaneScanLoop(make_lane_step(lm, cfg, dds, x_train, train_joined, opt_states, deferred),
                        lane_state=[[*ws, *st.m, *st.v, st.step]
                                    for ws, st in zip(lane_w, opt_states)],
                        seeds=LaneSeedSlots(model.n_layers, lanes, dds.device), table=table, k=k,
                        final_val=make_lane_eval_fn(lm, cfg, dds, VAL) if deferred else None,
                        device=dds.device)
    return SeedRun(seeds=seeds, lm=lm, loop=loop, test=make_lane_eval_fn(lm, cfg, dds, TEST))


def fit_seeds(cfg: Config, dds: DeviceDataset, seeds: Sequence[int], *,
              weights: list[list[torch.Tensor]] | None = None,
              verbose: bool | None = None) -> SeedsResult:
    """Train ``cfg``'s GCN once a seed, every seed at once (module
    docstring): lane s is ``train.fit`` of ``cfg`` with ``seed=s``.
    ``weights[s]`` (float32, JAX leaf order) replaces lane s's Glorot init.
    Writes no checkpoints; ``check_config`` lists what it refuses."""
    verbose = cfg.train.verbose if verbose is None else verbose
    run = seed_run(cfg, dds, seeds, weights)
    if dds.device.type == "cuda":
        torch.cuda.synchronize(dds.device)
    t0 = time.perf_counter()
    scan = run.loop.run()
    total = time.perf_counter() - t0
    test = [(float(loss), float(acc)) for loss, acc in run.test()]
    last = [h[max(e - 1, 0)] if e else np.zeros(4, np.float32)
            for h, e in zip(scan.history, scan.epochs_run)]
    result = SeedsResult(
        seeds=run.seeds, history=scan.history, epochs_run=scan.epochs_run,
        val_loss=np.array([r[2] for r in last]), val_acc=np.array([r[3] for r in last]),
        test_loss=np.array([t[0] for t in test]), test_acc=np.array([t[1] for t in test]),
        weights=[[w.detach() for w in ws] for ws in run.lm.weights],
        avg_epoch_time_s=scan.epoch_s, total_time_s=total, setup_time_s=scan.setup_s,
        replays=scan.replays, graph_launches=scan.graph_launches)
    if verbose:
        for s, e, va, ta in zip(run.seeds, result.epochs_run, result.val_acc, result.test_acc):
            print(f"seed={s} epochs_run={e} val_acc={va:.5f} test_acc={ta:.5f}")
        print(f"seeds: {len(run.seeds)} lanes, {scan.epoch_s * 1e3:.3f} ms/epoch, "
              f"total {total:.3f} s")
    return result
