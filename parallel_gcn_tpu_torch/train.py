"""Training loop — counterpart of GCN::run / train_epoch / eval.

Port of ``parallel_gcn_tpu/train.py`` (eager path). Reference semantics
(src/gcn.cu:293-455):
  * per epoch: forward(train) → metrics → backward → Adam → eval(val) on the
    updated weights;
  * reported loss = CE/num_samples + wd·||W0||²/2, for train and eval;
  * early stopping: after epoch e ≥ k, stop if val_loss > mean of the last k
    val losses (window includes the current epoch).

Dropout seeds come from one ``torch.Generator`` seeded with ``cfg.tpu.seed``:
per epoch, one 62-bit seed per layer, and for a GAT also one int32
attention-dropout seed per layer (``epoch_seeds``).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, replace
from typing import Callable

import numpy as np
import torch

from parallel_gcn_tpu_torch.config import Config
from parallel_gcn_tpu_torch.data.parser import TEST, TRAIN, VAL, DeviceDataset
from parallel_gcn_tpu_torch.models.gat import GATModel, init_gat_params
from parallel_gcn_tpu_torch.models.gcn import GCNModel, init_params, set_matmul_precision
from parallel_gcn_tpu_torch.ops.cuda_ce import masked_softmax_xent_fused
from parallel_gcn_tpu_torch.ops.graphsum import resolve_backend
from parallel_gcn_tpu_torch.ops.loss import l2_penalty, masked_softmax_xent
from parallel_gcn_tpu_torch.optim import AdamState, adam_step, init_adam

Model = GCNModel | GATModel

_SEED_HIGH = 2**62
_ATTN_SEED_HIGH = 2**31 - 1


@dataclass
class FitResult:
    weights: list  # float32 tensors, one per layer
    history: np.ndarray  # [epochs_run, 4]: train_loss, train_acc, val_loss, val_acc
    epochs_run: int
    test_loss: float
    test_acc: float
    avg_epoch_time_s: float
    total_time_s: float


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


def build_model(cfg: Config, dds: DeviceDataset,
                weights: list[torch.Tensor] | None = None) -> Model:
    """The configured model (``model=gcn`` or ``gat``) on ``dds``'s device,
    with ``weights`` (a GAT's in JAX leaf order) or a Glorot init from
    ``cfg.tpu.seed``. Sets the matmul precision (process-wide)."""
    gat = cfg.gcn.model == "gat"
    backend = resolve_backend(dds.graph, cfg.tpu.backend, cfg.tpu.dense_threshold)
    gat_backend = _gat_backend(cfg, dds.graph, backend) if gat else None
    unported = {
        f"model={cfg.gcn.model}": cfg.gcn.model not in ("gcn", "gat"),
        "remat": cfg.gcn.remat,
        f"tp={cfg.tpu.tp}": cfg.tpu.tp > 1,
        "edge_chunk with model=gat": gat and cfg.tpu.edge_chunk > 0,
    }
    missing = [k for k, v in unported.items() if v]
    if missing:
        raise NotImplementedError(
            f"not yet ported to parallel_gcn_tpu_torch: {', '.join(missing)}"
        )
    set_matmul_precision(cfg.tpu.matmul_precision)
    if weights is None:
        gen = torch.Generator().manual_seed(cfg.tpu.seed)
        if gat:
            weights = init_gat_params(gen, dds.input_dim, cfg.gcn.hidden_dims,
                                      dds.output_dim, cfg.gcn.heads)
        else:
            weights = init_params(gen, dds.input_dim, cfg.gcn.hidden_dims,
                                  dds.output_dim)
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
        )
    return GCNModel(
        weights,
        cfg.gcn.dropouts,
        residual=cfg.gcn.residual,
        backend=backend,
        edge_chunk=cfg.tpu.edge_chunk,
        dense_threshold=cfg.tpu.dense_threshold,
        compute_dtype=cfg.tpu.compute_dtype,
        fuse_dropout_matmul=cfg.tpu.fuse_dropout_matmul,
    )


def _ce_fn(cfg: Config) -> Callable:
    """The masked softmax-CE of ``cfg.tpu.ce_impl``: ``pallas`` is the fused
    kernel (K9, ``ops.cuda_ce``); ``auto`` and ``xla`` are the plain torch
    expression of ``ops.loss``, as ``auto`` resolves in the JAX package."""
    if cfg.tpu.ce_impl == "pallas":
        return masked_softmax_xent_fused
    return masked_softmax_xent


def _l2_term(wd: float, w0: torch.Tensor) -> torch.Tensor:
    """wd·||W0||²/2, the reported-loss regularizer (src/gcn.cu:440-455)."""
    return float(np.float32(wd)) * l2_penalty(w0) / 2.0


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
            train_loss = ce.detach() + _l2_term(wd, weights[0])
        adam_step(weights, grads, opt_state, learning_rate=adam.learning_rate,
                  weight_decay=wd, beta1=adam.beta1, beta2=adam.beta2, eps=adam.eps)
        with torch.no_grad():
            val_logits = model(x_eval, dds.graph, training=False,
                               input_preagg=eval_preagg)
            val_ce, val_acc = ce_fn(val_logits, dds.labels, val_mask, n_val)
            val_loss = val_ce + _l2_term(wd, weights[0])
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
            return ce + _l2_term(wd, model.weights[0]), acc

    return eval_fn


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
) -> FitResult:
    """Full training run: init → epoch loop (+ early stopping) → test eval.

    ``mode=scan`` runs this eager loop too (the whole-run path is not yet
    ported); ``checkpoint_dir`` raises NotImplementedError."""
    verbose = cfg.train.verbose if verbose is None else verbose
    if cfg.train.checkpoint_dir:
        raise NotImplementedError(
            "checkpoints are not yet ported to parallel_gcn_tpu_torch"
        )
    if cfg.train.mode == "scan" and verbose:
        print("note: mode=scan (whole-run path) is not yet ported — "
              "running the eager epoch loop")
    model = build_model(cfg, dds, weights)
    gat = isinstance(model, GATModel)
    if cfg.tpu.input_preagg and gat:
        # Â·(X·W0) == (Â·X)·W0 is a GCN identity; GAT's aggregation is
        # data-dependent, so the knob (on by default) has nothing to hoist
        if verbose:
            print("note: input_preagg has no GAT analog — ignored")
    elif cfg.tpu.input_preagg:
        dds = preaggregate_input(model, dds)
    opt_state = init_adam(list(model.weights))
    gen = torch.Generator().manual_seed(cfg.tpu.seed)
    epoch_step = make_epoch_step(model, cfg, dds)
    test_fn = make_eval_fn(model, cfg, dds, TEST)

    k = cfg.gcn.early_stopping
    rows = []
    loss_history: list[float] = []
    _sync(dds.device)
    t0 = time.perf_counter()
    for epoch in range(1, cfg.gcn.epochs + 1):
        te = time.perf_counter()
        metrics = epoch_step(opt_state, epoch_seeds(gen, model.n_layers, attention=gat))
        tl, ta, vl, va = metrics.tolist()  # waits for the device
        rows.append((tl, ta, vl, va))
        if verbose:
            print(
                f"epoch={epoch} train_loss={tl:.5f} train_acc={ta:.5f} "
                f"val_loss={vl:.5f} val_acc={va:.5f} "
                f"time={time.perf_counter() - te:.5f}"
            )
        if k > 0:
            loss_history.append(vl)
            if len(loss_history) >= k and vl > float(np.mean(loss_history[-k:])):
                if verbose:
                    print("Early stopping...")
                break
    total_time = time.perf_counter() - t0
    history = np.asarray(rows, dtype=np.float32).reshape(-1, 4)
    epochs_run = len(rows)

    test_loss, test_acc = (float(v) for v in test_fn())
    if verbose:
        print(f"test_loss={test_loss:.5f} test_acc={test_acc:.5f}")
        print(f"total time: {total_time:.5f}")
    return FitResult(
        weights=[w.detach() for w in model.weights],
        history=history,
        epochs_run=epochs_run,
        test_loss=test_loss,
        test_acc=test_acc,
        avg_epoch_time_s=total_time / max(epochs_run, 1),
        total_time_s=total_time,
    )
