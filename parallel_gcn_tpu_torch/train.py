"""Training loop — counterpart of GCN::run / train_epoch / eval.

Port of ``parallel_gcn_tpu/train.py``. Reference semantics
(src/gcn.cu:293-455):
  * per epoch: forward(train) → metrics → backward → Adam → eval(val) on the
    updated weights;
  * reported loss = CE/num_samples + wd·||W0||²/2, for train and eval;
  * early stopping: after epoch e ≥ k, stop if val_loss > mean of the last k
    val losses (window includes the current epoch).

Two modes, as in the JAX package. ``mode=scan`` (the default) is the
whole-run path (``scan.ScanLoop``): the epochs stay on the device, one CUDA
graph replayed per epoch, early stopping decided on the device, and with
early stopping off the deferred-eval schedule of ``fused_deferred_forward``
for a GCN of two or more layers. ``mode=eager`` reads each epoch's metrics
on the host before the next epoch starts.

Dropout seeds come from one ``torch.Generator`` seeded with ``cfg.tpu.seed``:
per epoch, one 62-bit seed per layer, and for a GAT also one int32
attention-dropout seed per layer (``epoch_seeds``). Both modes draw them in
the same order and hand them to the kernels through device slots
(``scan.SeedSlots``), so they draw the same masks.

Checkpoints (``utils.checkpoint``, the JAX package's format and file names):
with ``checkpoint_dir`` a run writes ``ckpt_final.npz`` at its end and, every
``checkpoint_every`` epochs, ``ckpt_{epoch:06d}.npz`` (``mode=eager``: at
epochs that are multiples of it; ``mode=scan``: every that many epochs of
this run, with early stopping off). ``resume_from`` loads weights, Adam
state and epoch, trains the epochs after it, and continues the seed stream
there (``skip_epochs``), so a resumed run repeats the uninterrupted one's
last epochs.
"""

from __future__ import annotations

import json
import os
import time
import warnings
from dataclasses import dataclass, field, replace
from typing import Callable

import numpy as np
import torch

from parallel_gcn_tpu_torch.config import Config
from parallel_gcn_tpu_torch.convert import adam_state_from_numpy
from parallel_gcn_tpu_torch.data.parser import TEST, TRAIN, VAL, DeviceDataset
from parallel_gcn_tpu_torch.models.gat import GATModel, init_gat_params
from parallel_gcn_tpu_torch.models.gcn import GCNModel, init_params, set_matmul_precision
from parallel_gcn_tpu_torch.models.sage import (GINModel, SAGEModel, init_gin_params,
                                                init_sage_params)
from parallel_gcn_tpu_torch.ops.cuda_ce import masked_softmax_xent_fused
from parallel_gcn_tpu_torch.ops.graphsum import resolve_backend
from parallel_gcn_tpu_torch.ops.loss import l2_penalty, masked_softmax_xent
from parallel_gcn_tpu_torch.optim import AdamState, adam_step, init_adam
from parallel_gcn_tpu_torch.parallel.collectives import mesh_command
from parallel_gcn_tpu_torch.scan import ScanLoop, SeedSlots, seed_table, upload_seeds
from parallel_gcn_tpu_torch.utils.checkpoint import Checkpoint, load_checkpoint, save_checkpoint
from parallel_gcn_tpu_torch.utils.timer import run_phases, run_span, span

Model = GCNModel | GATModel | SAGEModel | GINModel

_SEED_HIGH = 2**62
_ATTN_SEED_HIGH = 2**31 - 1


@dataclass
class FitResult:
    weights: list  # float32 tensors, one per layer
    # [epochs_run, 4]: train_loss, train_acc, val_loss, val_acc; a resumed
    # run's epochs after its checkpoint
    history: np.ndarray
    epochs_run: int
    test_loss: float
    test_acc: float
    # eager: the loop's time over its epochs; scan: the host time of epochs
    # 2..N (on CUDA the graph's replays), ended by one sync, per epoch
    avg_epoch_time_s: float
    total_time_s: float
    setup_time_s: float = 0.0  # scan on CUDA: epoch 1 (eager) and the capture
    replays: int = 0  # scan on CUDA: replays of the captured epoch
    graph_launches: dict = field(default_factory=dict)  # kernels, collectives a replay
    start_epoch: int = 0  # epochs of the checkpoint a resumed run started from
    checkpoint_s: list = field(default_factory=list)  # seconds of each checkpoint written


def _gat_backend(cfg: Config, graph, backend: str) -> str:
    """The GAT aggregation backend for the resolved graph ``backend``, with
    the JAX package's config errors."""
    if backend in ("hybrid", "bcsr"):
        if graph.bcsr is None:
            raise ValueError("model=gat backend=hybrid/bcsr needs a tile-built graph")
        if cfg.tpu.edge_chunk:
            raise ValueError(
                "edge_chunk streams the SEGMENT attention; the tile backend "
                "already bounds memory at O(N·heads) — unset edge_chunk or set "
                "backend=segment"
            )
        return "tile"
    if not graph.coo_complete:
        raise ValueError(
            "model=gat backend=segment needs complete COO triplets — this graph "
            "carries only a tile pack; set backend=hybrid"
        )
    return "dense" if backend == "dense" else "segment"


def init_weights(cfg: Config, input_dim: int, output_dim: int) -> list[torch.Tensor]:
    """The Glorot init of ``cfg.gcn.model``'s leaves from ``cfg.tpu.seed``,
    float32 on the CPU, in JAX's leaf order."""
    gen = torch.Generator().manual_seed(cfg.tpu.seed)
    init = {"gat": lambda *a: init_gat_params(*a, cfg.gcn.heads), "sage": init_sage_params,
            "gin": init_gin_params}.get(cfg.gcn.model, init_params)
    return init(gen, input_dim, cfg.gcn.hidden_dims, output_dim)


def build_model(cfg: Config, dds: DeviceDataset,
                weights: list[torch.Tensor] | None = None) -> Model:
    """The configured model (``model=gcn|gat|sage|gin``) on ``dds``'s
    device, with ``weights`` (the family's leaves in JAX leaf order) or a
    Glorot init from ``cfg.tpu.seed``. Sets the matmul precision
    (process-wide)."""
    family = cfg.gcn.model
    gat = family == "gat"
    backend = resolve_backend(dds.graph, cfg.tpu.backend, cfg.tpu.dense_threshold)
    gat_backend = _gat_backend(cfg, dds.graph, backend) if gat else None
    if cfg.tpu.tp > 1:
        # JAX's fit has no tp either: its CLI sends tp to the mesh
        raise ValueError(f"tp={cfg.tpu.tp} (tensor parallelism) trains on the mesh, one process "
                         f"per GPU: {mesh_command(cfg.tpu.n_devices or 1, cfg.tpu.tp)}")
    set_matmul_precision(cfg.tpu.matmul_precision)
    if weights is None:
        weights = init_weights(cfg, dds.input_dim, dds.output_dim)
    weights = [w.to(dds.device) for w in weights]
    if gat:
        return GATModel(
            weights,
            cfg.gcn.dropouts,
            heads=cfg.gcn.heads,
            attn_dropout=cfg.gcn.attn_dropout,
            backend=gat_backend,
            compute_dtype=cfg.tpu.compute_dtype,
            residual=cfg.gcn.residual,
            remat=cfg.gcn.remat,
            edge_chunk=cfg.tpu.edge_chunk,
        )
    common = dict(residual=cfg.gcn.residual, backend=backend, edge_chunk=cfg.tpu.edge_chunk,
                  dense_threshold=cfg.tpu.dense_threshold,
                  compute_dtype=cfg.tpu.compute_dtype, remat=cfg.gcn.remat)
    if family == "sage":
        return SAGEModel(weights, cfg.gcn.dropouts, **common)
    if family == "gin":
        return GINModel(weights, cfg.gcn.dropouts, gin_eps=cfg.gcn.gin_eps, **common)
    return GCNModel(weights, cfg.gcn.dropouts,
                    fuse_dropout_matmul=cfg.tpu.fuse_dropout_matmul, **common)


def _ce_fn(cfg: Config) -> Callable:
    """The masked softmax-CE of ``cfg.tpu.ce_impl``: ``pallas`` is the fused
    kernel (K9, ``ops.cuda_ce``); ``auto`` and ``xla`` are the plain torch
    expression of ``ops.loss``, as ``auto`` resolves in the JAX package."""
    if cfg.tpu.ce_impl == "pallas":
        return masked_softmax_xent_fused
    return masked_softmax_xent


def l2_term(wd: float, sq: torch.Tensor) -> torch.Tensor:
    """wd·Σw²/2 of ``sq`` = Σw² of W0 (``l2_penalty``, summed over the feat
    ranks under tensor parallelism), the reported-loss regularizer
    (src/gcn.cu:440-455)."""
    return float(np.float32(wd)) * sq / 2.0


def preaggregate_input(model: GCNModel, dds: DeviceDataset) -> DeviceDataset:
    """Hoist the input layer's aggregation out of the epoch loop.

    Â·(X·W0) == (Â·X)·W0, so Â·X is computed once here, stored in the
    compute dtype. With zero input dropout it replaces ``dds.x`` and the
    model skips layer 0's aggregation in every forward; otherwise it is kept
    in ``dds.x_agg`` for the eval forwards only. Exact (reassociation)."""
    if model.input_preagg or dds.x_agg is not None:
        return dds
    with torch.no_grad():
        x_agg = model.aggregate(dds.x, dds.graph).to(model.compute_dtype)
    if model.dropouts[0] == 0.0:
        model.input_preagg = True
        return replace(dds, x=x_agg)
    return replace(dds, x_agg=x_agg)


def _eval_inputs(model: Model, dds: DeviceDataset):
    x_eval = dds.x_agg if dds.x_agg is not None else dds.x
    return x_eval, model.input_preagg or dds.x_agg is not None


def make_epoch_step(model: Model, cfg: Config, dds: DeviceDataset) -> Callable:
    """One-epoch function ``(opt_state, seeds) -> metrics[4]`` (a float32
    tensor on the device: train_loss, train_acc, val_loss, val_acc). Updates
    ``model.weights`` and ``opt_state`` in place."""
    adam = cfg.adam
    wd = adam.weight_decay
    n_train = dds.split_counts[TRAIN]
    n_val = dds.split_counts[VAL]
    train_mask = dds.split == TRAIN
    val_mask = dds.split == VAL
    x_eval, eval_preagg = _eval_inputs(model, dds)
    weights = list(model.weights)
    ce_fn = _ce_fn(cfg)

    def epoch_step(opt_state: AdamState, seeds: list[int]) -> torch.Tensor:
        logits = model(dds.x, dds.graph, training=True, seeds=seeds)
        ce, train_acc = ce_fn(logits, dds.labels, train_mask, n_train)
        grads = torch.autograd.grad(ce, weights)
        with torch.no_grad():
            # the L2 term of the PRE-update W0 (src/gcn.cu:314)
            train_loss = ce.detach() + l2_term(wd, l2_penalty(weights[0]))
        adam_step(weights, grads, opt_state, learning_rate=adam.learning_rate,
                  weight_decay=wd, beta1=adam.beta1, beta2=adam.beta2, eps=adam.eps)
        with torch.no_grad():
            val_logits = model(x_eval, dds.graph, training=False,
                               input_preagg=eval_preagg)
            val_ce, val_acc = ce_fn(val_logits, dds.labels, val_mask, n_val)
            val_loss = val_ce + l2_term(wd, l2_penalty(weights[0]))
            return torch.stack([train_loss, train_acc, val_loss, val_acc])

    return epoch_step


def make_eval_fn(model: Model, cfg: Config, dds: DeviceDataset,
                 split: int) -> Callable:
    """``() -> (loss, acc)`` tensors of ``split`` on the current weights."""
    mask = dds.split == split
    n = dds.split_counts[split]
    wd = cfg.adam.weight_decay
    x_eval, eval_preagg = _eval_inputs(model, dds)
    ce_fn = _ce_fn(cfg)

    def eval_fn():
        with torch.no_grad():
            logits = model(x_eval, dds.graph, training=False, input_preagg=eval_preagg)
            ce, acc = ce_fn(logits, dds.labels, mask, n)
            return ce + l2_term(wd, l2_penalty(model.weights[0])), acc

    return eval_fn


class _StackedAggregate(torch.autograd.Function):
    """``Â·[a_t | a_e]`` as one aggregation of the two halves side by side;
    the gradient flows to the train half ``a_t`` only, as the aggregation of
    its cotangent (Â is symmetric). ``aggregate`` runs Â·h without
    autograd; ``reduce``, when given, first sums the stacked halves' partial
    products over the feat ranks (tensor parallelism), a sum whose
    transpose is the identity."""

    @staticmethod
    def forward(ctx, a_t, a_e, aggregate, reduce=None):
        ctx.aggregate = aggregate
        n_cols = a_t.shape[1]
        stacked = torch.cat([a_t, a_e], dim=1)
        out = aggregate(stacked if reduce is None else reduce(stacked))
        lt, le = out[:, :n_cols].contiguous(), out[:, n_cols:].contiguous()
        ctx.mark_non_differentiable(le)
        return lt, le

    @staticmethod
    def backward(ctx, g_t, g_e):
        return ctx.aggregate(g_t.contiguous()), None, None, None


def fused_deferred_forward(model: GCNModel, x_train, x_eval, graph, seeds, *,
                           train_preagg: bool, eval_preagg: bool):
    """Train forward and DEFERRED val forward, with the last layer's
    aggregation stacked along the feature dimension (JAX
    ``train._fused_deferred_forward``): (train logits, val logits), f32.

    The val forward the reference runs after epoch e's Adam step uses the
    weights epoch e+1's train forward starts from, so epoch e+1 runs both
    on the same weights, and the two last-layer products [n, C] ride one
    aggregation at 2·C columns instead of two at C (one K4 call, or on the
    mesh one K3 call and one collective; the backward aggregates the train
    half only). The caller moves the val metrics back one epoch and runs one
    standalone val eval after the last epoch. The layers before the last
    are shared outright when all their dropouts are 0 and both forwards read
    the same input (both pre-aggregated or neither). Gradients flow through
    the train logits only. ``model.aggregate`` must be self-adjoint (the GCN
    and mesh GCN aggregations are). A tensor-parallel mesh GCN's last layer
    gives partial products, which its ``stack_reduce`` sums over the feat
    ranks in one collective before the aggregation (JAX
    ``forward_stacked_tp``)."""
    L = model.n_layers
    if L < 2:
        raise ValueError("deferred-eval fusion needs the last layer's aggregation")
    seeds = list(seeds) if seeds is not None else [None] * L
    share = all(d == 0 for d in model.dropouts[: L - 1]) and train_preagg == eval_preagg
    ht = model.prefix(x_train, graph, training=True, seeds=seeds, preagg=train_preagg)
    pre_relu = model.defers_relu(L - 1)
    at = model.layer_pre(ht, L - 1, seeds[L - 1], True, pre_relu=pre_relu)
    with torch.no_grad():
        he = ht if share else model.prefix(x_eval, graph, training=False,
                                            seeds=[None] * L, preagg=eval_preagg)
        ae = model.layer_pre(he, L - 1, None, False, pre_relu=pre_relu)
    lt, le = _StackedAggregate.apply(at, ae, lambda h: model.aggregate(h, graph),
                                     getattr(model, "stack_reduce", None))
    return lt.float(), le.float()


def make_deferred_step(model: GCNModel, cfg: Config, dds: DeviceDataset) -> Callable:
    """The deferred-eval epoch (``fused_deferred_forward``): ``(opt_state,
    seeds) -> metrics[4]``, this epoch's train loss and accuracy and the val
    loss and accuracy of the weights it started from. Updates
    ``model.weights`` and ``opt_state`` in place."""
    adam = cfg.adam
    wd = adam.weight_decay
    n_train = dds.split_counts[TRAIN]
    n_val = dds.split_counts[VAL]
    train_mask = dds.split == TRAIN
    val_mask = dds.split == VAL
    x_eval, eval_preagg = _eval_inputs(model, dds)
    weights = list(model.weights)
    ce_fn = _ce_fn(cfg)

    def step(opt_state: AdamState, seeds) -> torch.Tensor:
        lt, le = fused_deferred_forward(model, dds.x, x_eval, dds.graph, seeds,
                                        train_preagg=model.input_preagg,
                                        eval_preagg=eval_preagg)
        ce, train_acc = ce_fn(lt, dds.labels, train_mask, n_train)
        with torch.no_grad():
            val_ce, val_acc = ce_fn(le, dds.labels, val_mask, n_val)
        grads = torch.autograd.grad(ce, weights)
        with torch.no_grad():
            # the L2 term of the PRE-update W0: the reference's for the train
            # loss, and the weights the deferred val forward ran on
            pen = l2_term(wd, l2_penalty(weights[0]))
            metrics = torch.stack([ce.detach() + pen, train_acc, val_ce + pen, val_acc])
        adam_step(weights, grads, opt_state, learning_rate=adam.learning_rate,
                  weight_decay=wd, beta1=adam.beta1, beta2=adam.beta2, eps=adam.eps)
        return metrics

    return step


def scan_schedule(model: Model, cfg: Config, epochs: int | None = None) -> tuple[int, bool]:
    """(k, deferred) of a whole-run path of ``epochs`` epochs (default
    ``cfg.gcn.epochs``; a resumed run's are the ones after its checkpoint):
    the early-stopping window k (0 when it exceeds the epochs, where the
    rule can never fire) and whether the epochs run the deferred-eval
    schedule (k = 0, a GCN with a last aggregation to stack), as the JAX
    package's ``_make_scan_run`` decides."""
    epochs = cfg.gcn.epochs if epochs is None else epochs
    k = cfg.gcn.early_stopping
    if k > epochs:
        k = 0
    deferred = (k == 0 and epochs > 0 and model.n_layers >= 2
                and model.supports_deferred_eval)
    return k, deferred


def make_scan_loop(model: Model, cfg: Config, dds: DeviceDataset, opt_state: AdamState,
                   gen: torch.Generator, start: int = 0,
                   checkpoint: Callable[[int], None] | None = None) -> ScanLoop:
    """The whole-run loop of the epochs after ``start`` (``scan.ScanLoop``),
    with every epoch's seeds drawn from ``gen`` now; ``checkpoint``, when
    given, every ``checkpoint_every`` epochs (``scan_checkpoints``)."""
    epochs = max(cfg.gcn.epochs - start, 0)
    k, deferred = scan_schedule(model, cfg, epochs)
    gat = isinstance(model, GATModel)
    if deferred:
        step, final_val = make_deferred_step(model, cfg, dds), make_eval_fn(model, cfg, dds, VAL)
    else:
        step, final_val = make_epoch_step(model, cfg, dds), None
    table = seed_table([epoch_seeds(gen, model.n_layers, attention=gat)
                        for _ in range(epochs)], dds.device)
    return ScanLoop(lambda slots: step(opt_state, slots),
                    state=[*model.weights, *opt_state.m, *opt_state.v, opt_state.step],
                    seeds=SeedSlots(model.n_layers, gat, dds.device), table=table, k=k,
                    final_val=final_val, device=dds.device,
                    every=cfg.train.checkpoint_every if checkpoint else 0,
                    checkpoint=checkpoint)


def scan_checkpoints(cfg: Config, start: int, save: Callable | None,
                     verbose: bool) -> Callable[[int], None] | None:
    """The whole-run path's periodic checkpoint writer ``(n) -> None`` (the
    state after epoch ``start + n``) or None, with the JAX package's
    warnings (``train._drive_scan_run``): a resumed tail shorter than the
    early-stopping window, and periodic checkpoints refused with early
    stopping on (only ``ckpt_final.npz`` is written then)."""
    k, every = cfg.gcn.early_stopping, cfg.train.checkpoint_every
    remaining = max(cfg.gcn.epochs - start, 0)
    if start and 0 < remaining < k and verbose:
        print(f"warning: {remaining} epochs remain after resume but the early_stopping "
              f"window needs {k} post-resume val losses — the stopping rule cannot fire "
              "on this tail")
    if save is None or not every:
        return None
    if k:
        # a long run silently losing its periodic checkpoints must be heard
        warnings.warn("scan-mode periodic checkpoints require early_stopping=0 (fused "
                      "chunks would reset the stopping window); only ckpt_final.npz will be "
                      "written — use mode=eager for periodic checkpoints with early "
                      "stopping", stacklevel=3)
        return None
    return lambda n: save(f"ckpt_{start + n:06d}.npz", start + n)


def checkpoint_writer(cfg: Config, model: Model, opt_state: AdamState, seed: int,
                      times: list, *, write: bool = True,
                      barrier: Callable[[], None] | None = None,
                      gather: Callable[[], tuple] | None = None,
                      verbose: bool = False) -> Callable[[str, int], None] | None:
    """``save(name, epoch)``: the run's weights, Adam state and generator
    seed as ``cfg.train.checkpoint_dir``/name, its seconds appended to
    ``times``; None without a checkpoint_dir. ``gather()``, when given, runs
    on every process and returns the full (weights, Adam state) to write
    (tensor parallelism's shards gathered over the feat ranks). Only a
    process with ``write`` writes (the mesh's rank 0); every process then
    waits at ``barrier``."""
    ckpt_dir = cfg.train.checkpoint_dir
    if not ckpt_dir:
        return None

    def save(name: str, epoch: int) -> None:
        with span("checkpoint") as written:
            weights, state = (list(model.weights), opt_state) if gather is None else gather()
            if write:
                save_checkpoint(os.path.join(ckpt_dir, name), weights, state,
                                epoch, keys=model.layer_keys, seed=seed)
            if barrier is not None:
                barrier()
        times.append(written.seconds)
        if verbose:
            print(f"checkpoint {name} (epoch {epoch}) written in {times[-1]:.3f} s")

    return save


def resume_state(resume_from: str | None, weights, seed: int, device, verbose: bool):
    """(checkpoint or None, weights, start epoch, generator seed) of a run:
    the file's at ``resume_from`` (its weights as float32 tensors on
    ``device``, its seed where it stored one; prints the JAX package's
    "resumed from" line), else ``weights``, epoch 0 and ``seed``."""
    if not resume_from:
        return None, weights, 0, seed
    if weights is not None:
        raise ValueError("a run takes weights or resume_from, not both")
    t0 = time.perf_counter()
    ck = load_checkpoint(resume_from)
    weights = [torch.from_numpy(w).to(device) for w in ck.weights]
    if verbose:
        print(f"resumed from {resume_from} at epoch {ck.epoch} (loaded in "
              f"{time.perf_counter() - t0:.3f} s)")
    return ck, weights, ck.epoch, seed if ck.seed is None else ck.seed


def resumed_adam(ck: Checkpoint | None, weights: list[torch.Tensor]) -> AdamState:
    """Adam's state from the checkpoint ``ck``, or a fresh one for
    ``weights``."""
    if ck is None:
        return init_adam(weights)
    return adam_state_from_numpy(ck.step, ck.m, ck.v, weights[0].device)


def skip_epochs(gen: torch.Generator, epochs: int, n_layers: int, attention: bool) -> None:
    """Advance ``gen`` past the seeds of ``epochs`` epochs (``epoch_seeds``):
    a resumed run draws epoch ``epochs + 1``'s seeds next, the counterpart
    of the JAX package's ``_advance_key``."""
    for _ in range(epochs):
        epoch_seeds(gen, n_layers, attention)


def print_scan(result, epochs: int, start: int = 0) -> None:
    """The whole-run path's report: the epoch lines after the run, as the
    JAX package's scan prints them (no per-epoch time), then "Early
    stopping..." when it fired, the loop's timing and, inside a run's span
    (``utils.timer.run_span``), the run's phases so far."""
    for e, (tl, ta, vl, va) in enumerate(result.history):
        print(f"epoch={start + e + 1} train_loss={tl:.5f} train_acc={ta:.5f} "
              f"val_loss={vl:.5f} val_acc={va:.5f}")
    if start + result.epochs_run < epochs:
        print("Early stopping...")
    if result.replays:
        print(f"scan: epoch 1 and the capture in {result.setup_s:.3f} s, {result.replays} "
              f"replays of one CUDA graph, {result.epoch_s * 1e3:.3f} ms/epoch; launches a "
              f"replay: {json.dumps(result.graph_launches, sort_keys=True)}")
    phases = run_phases()
    if phases is not None:
        print(f"phases: {phases}")


def epoch_seeds(gen: torch.Generator, n_layers: int, attention: bool = False) -> list[int]:
    """One dropout seed per layer for the next epoch; with ``attention``
    (GAT) two per layer, ``[feature_0, attention_0, feature_1, ...]``, the
    attention seeds int32 in [0, 2³¹−1) for the tile kernels' hash mask."""
    feat = torch.randint(0, _SEED_HIGH, (n_layers,), generator=gen).tolist()
    if not attention:
        return feat
    attn = torch.randint(0, _ATTN_SEED_HIGH, (n_layers,), generator=gen).tolist()
    return [s for pair in zip(feat, attn) for s in pair]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def fit(
    cfg: Config,
    dds: DeviceDataset,
    *,
    weights: list[torch.Tensor] | None = None,
    verbose: bool | None = None,
    resume_from: str | None = None,
) -> FitResult:
    """Full training run: init → epochs (+ early stopping) → test eval.

    ``mode=scan`` runs the whole-run path (``make_scan_loop``), ``mode=eager``
    the per-epoch loop. ``resume_from`` (a checkpoint of either package)
    replaces the init and the fresh Adam state with the file's and trains
    the epochs after its epoch; ``checkpoint_dir`` / ``checkpoint_every``
    write checkpoints (module docstring). ``gat_scan_check`` is accepted and
    does nothing: the JAX package's guard contains failures of XLA's
    whole-run program on the TPU, and a captured epoch holds the eager
    epoch's memory. The run goes in the span ``pgcn::fit``
    (``utils.timer.run_span``) with ``build`` (``preagg`` in it), the
    loop's ``scan.*``, ``checkpoint`` and ``test_eval`` in it."""
    with run_span("fit"):
        return _fit(cfg, dds, weights, cfg.train.verbose if verbose is None else verbose,
                    resume_from)


def _build(cfg: Config, dds: DeviceDataset, weights, verbose: bool, resume_from: str | None):
    """What ``fit`` sets up before its loop: the model, the dataset (with
    the input pre-aggregated where that applies), the Adam state, the seed
    generator, the first epoch, the test eval, the checkpoint writer and
    its list of seconds. Ends with a sync."""
    ck, weights, start, seed = resume_state(resume_from, weights, cfg.tpu.seed, dds.device,
                                            verbose)
    model = build_model(cfg, dds, weights)
    gat = isinstance(model, GATModel)
    if cfg.tpu.input_preagg and not isinstance(model, GCNModel):
        # Â·(X·W0) == (Â·X)·W0 is a GCN identity; GAT's aggregation is
        # data-dependent and SAGE/GIN interleave transforms and sums, so the
        # knob (on by default) has nothing to hoist
        if verbose:
            print(f"note: input_preagg has no {cfg.gcn.model.upper()} analog — ignored")
    elif cfg.tpu.input_preagg:
        with span("preagg") as preagg:
            dds = preaggregate_input(model, dds)
            _sync(dds.device)
        if verbose:
            print(f"setup: the input's pre-aggregation (Â·X at {dds.input_dim} columns) in "
                  f"{preagg.seconds:.3f} s")
    opt_state = resumed_adam(ck, list(model.weights))
    gen = torch.Generator().manual_seed(seed)
    skip_epochs(gen, start, model.n_layers, gat)
    test_fn = make_eval_fn(model, cfg, dds, TEST)
    ckpt_s: list = []
    save = checkpoint_writer(cfg, model, opt_state, seed, ckpt_s, verbose=verbose)
    _sync(dds.device)
    return model, dds, opt_state, gen, start, test_fn, save, ckpt_s


def _fit(cfg: Config, dds: DeviceDataset, weights, verbose: bool,
         resume_from: str | None) -> FitResult:
    """``fit``'s run inside its run span (the run's state is freed as this
    returns, inside the span)."""
    with span("build"):
        model, dds, opt_state, gen, start, test_fn, save, ckpt_s = _build(
            cfg, dds, weights, verbose, resume_from)
    gat = isinstance(model, GATModel)
    scan = None
    t0 = time.perf_counter()
    if cfg.train.mode == "scan":
        scan = make_scan_loop(model, cfg, dds, opt_state, gen, start,
                              scan_checkpoints(cfg, start, save, verbose)).run()
        total_time = time.perf_counter() - t0
        history, epochs_run = scan.history, scan.epochs_run
        if verbose:
            print_scan(scan, cfg.gcn.epochs, start)
    else:
        history, epochs_run = eager_loop(make_epoch_step(model, cfg, dds), opt_state, cfg,
                                         SeedSlots(model.n_layers, gat, dds.device),
                                         lambda: epoch_seeds(gen, model.n_layers, gat),
                                         dds.device, verbose, start, save)
        total_time = time.perf_counter() - t0
    if save is not None:
        save("ckpt_final.npz", start + epochs_run)

    with span("test_eval"):
        test_loss, test_acc = (float(v) for v in test_fn())
    if verbose:
        print(f"test_loss={test_loss:.5f} test_acc={test_acc:.5f}")
        print(f"total time: {total_time:.5f}")
    return fit_result(model, history, epochs_run, test_loss, test_acc, total_time, scan,
                      start_epoch=start, checkpoint_s=ckpt_s)


def eager_loop(epoch_step: Callable, opt_state: AdamState, cfg: Config, seeds: SeedSlots,
               draw: Callable, device, verbose: bool, start: int = 0,
               save: Callable[[str, int], None] | None = None) -> tuple[np.ndarray, int]:
    """The per-epoch loop over the epochs after ``start``: each epoch's
    seeds (``draw()``) uploaded in one non-blocking copy into ``seeds``, its
    metrics read on the host, a checkpoint written by ``save`` at epochs that
    are multiples of ``checkpoint_every``, the stopping rule applied over
    this run's epochs. Returns (history, epochs run)."""
    k = cfg.gcn.early_stopping
    every = cfg.train.checkpoint_every if save is not None else 0
    rows = []
    for epoch in range(start + 1, cfg.gcn.epochs + 1):
        te = time.perf_counter()
        seeds.load(upload_seeds(draw(), device))
        tl, ta, vl, va = epoch_step(opt_state, seeds.slots).tolist()  # waits for the device
        rows.append((tl, ta, vl, va))
        if every and epoch % every == 0:
            save(f"ckpt_{epoch:06d}.npz", epoch)
        if verbose:
            print(
                f"epoch={epoch} train_loss={tl:.5f} train_acc={ta:.5f} "
                f"val_loss={vl:.5f} val_acc={va:.5f} "
                f"time={time.perf_counter() - te:.5f}"
            )
        if k > 0 and len(rows) >= k and vl > float(np.mean([r[2] for r in rows[-k:]])):
            if verbose:
                print("Early stopping...")
            break
    return np.asarray(rows, dtype=np.float32).reshape(-1, 4), len(rows)


def fit_result(model, history, epochs_run, test_loss, test_acc, total_time,
               scan=None, **extra) -> FitResult:
    """The run's ``FitResult``; with ``scan`` (a ``scan.ScanResult``) its
    epoch time, set-up and captured epoch; ``extra`` the resume's start
    epoch and the checkpoints' seconds."""
    avg = scan.epoch_s if scan is not None else total_time / max(epochs_run, 1)
    if scan is not None:
        extra.update(setup_time_s=scan.setup_s, replays=scan.replays,
                     graph_launches=scan.graph_launches)
    return FitResult(
        weights=[w.detach() for w in model.weights],
        history=history,
        epochs_run=epochs_run,
        test_loss=test_loss,
        test_acc=test_acc,
        avg_epoch_time_s=avg,
        total_time_s=total_time,
        **extra,
    )
