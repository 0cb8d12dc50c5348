"""``remat`` in parallel_gcn_tpu_torch: every family's layers recomputed in
the backward (``torch.utils.checkpoint``), as the JAX package wraps them in
``jax.checkpoint``.

On one card (the CPU's plain versions) the GCN (the deferred scan schedule
and the eager loop), the GAT on the tile backend, SAGE and GIN train with
feature and attention dropout, with and without ``remat``: history, test
metrics and weights bit-equal, and each training layer runs twice a step
with ``remat`` (the recompute) and once without. The recompute redraws the
same masks because the dropout reads its seed from the same slot. The same
in a gloo world of 2 (``fit_parallel``, ``mode=scan``; the recompute issues
the layer's collectives again on both ranks) over the GCN's int8 slabs, the
GAT's mesh packs, and SAGE and GIN over flat and int8 slabs.
"""

import numpy as np
import pytest
import torch

from parallel_gcn_tpu_torch import train as ttrain
from parallel_gcn_tpu_torch.config import Config
from parallel_gcn_tpu_torch.data.parser import to_device
from parallel_gcn_tpu_torch.data.synthetic import make_synthetic_dataset
from parallel_gcn_tpu_torch.models.gat import GATModel
from parallel_gcn_tpu_torch.models.gcn import GCNModel
from parallel_gcn_tpu_torch.models.sage import GINModel, SAGEModel
from test_torch_parallel import fit_routes, mesh_config, mesh_dataset, run_world

torch.set_num_threads(1)

CPU = torch.device("cpu")
TILES = dict(hybrid=True, tile_dtype="int8", tile_size=128, min_tile_nnz=520)


def _dataset():
    return make_synthetic_dataset(
        "remat", n_nodes=500, n_edges=8000, input_dim=24, n_classes=6,
        n_train=280, n_val=100, feature_nnz_per_row=8, n_communities=6,
    )


def _config(family, mode, remat, epochs=5):
    cfg = Config()
    cfg.gcn.model, cfg.gcn.remat = family, remat
    cfg.gcn.hidden_dims, cfg.gcn.dropouts = (16,), (0.3, 0.3)
    cfg.gcn.epochs, cfg.gcn.early_stopping = epochs, 0
    cfg.tpu.backend, cfg.tpu.tile_dtype = "hybrid", "int8"
    cfg.tpu.tile_size, cfg.tpu.min_tile_nnz = 128, 520
    cfg.train.verbose, cfg.train.mode = False, mode
    if family == "gat":
        cfg.gcn.heads, cfg.gcn.hidden_dims, cfg.gcn.attn_dropout = 2, (8,), 0.3
    return cfg


def _same_run(a, b):
    np.testing.assert_array_equal(a.history, b.history)
    assert (a.test_loss, a.test_acc) == (b.test_loss, b.test_acc)
    for x, y in zip(a.weights, b.weights):
        assert torch.equal(x, y)


@pytest.mark.parametrize("family,mode", [("gcn", "scan"), ("gcn", "eager"), ("gat", "scan"),
                                         ("sage", "scan"), ("sage", "eager"),
                                         ("gin", "scan")])
def test_remat_equals_the_plain_run(family, mode):
    dds = to_device(_dataset(), device=CPU, **TILES)
    plain = ttrain.fit(_config(family, mode, False), dds)
    remat = ttrain.fit(_config(family, mode, True), dds)
    assert plain.history[-1, 0] < plain.history[0, 0]
    _same_run(remat, plain)
    if family == "gcn" and mode == "scan":
        # the GCN's default scan schedule, which trains through
        # fused_deferred_forward and so through GCNModel.prefix
        assert ttrain.scan_schedule(ttrain.build_model(_config(family, mode, True), dds),
                                    _config(family, mode, True))[1]


@pytest.mark.parametrize("family,cls", [("gcn", GCNModel), ("gat", GATModel),
                                        ("sage", SAGEModel), ("gin", GINModel)])
def test_remat_recomputes_each_layer(family, cls, monkeypatch):
    """A training step with ``remat`` runs each layer twice (forward and its
    recompute in the backward), without once; eval forwards once."""
    dds = to_device(_dataset(), device=CPU, **TILES)
    calls = []
    orig = cls._layer

    def counted(self, *args, **kw):
        calls.append(1)
        return orig(self, *args, **kw)

    monkeypatch.setattr(cls, "_layer", counted)
    for remat in (False, True):
        cfg = _config(family, "eager", remat)
        model = ttrain.build_model(cfg, dds)
        seeds = ttrain.epoch_seeds(torch.Generator().manual_seed(0), model.n_layers,
                                   attention=family == "gat")
        calls.clear()
        logits = model(dds.x, dds.graph, training=True, seeds=seeds)
        torch.autograd.grad(logits.square().sum(), list(model.weights))
        assert len(calls) == model.n_layers * (2 if remat else 1), (remat, len(calls))
        calls.clear()
        with torch.no_grad():
            model(dds.x, dds.graph, training=False)
        assert len(calls) == model.n_layers


def test_remat_equals_the_plain_run_in_a_world_of_2(tmp_path):
    ds = mesh_dataset()
    runs = {}
    for route in ("gcn-hybrid-boundary", "gat-tiles-boundary", "sage-flat-all_gather",
                  "gin-hybrid-boundary"):
        cfg = mesh_config(route)
        w = [t.numpy() for t in ttrain.init_weights(cfg, ds.input_dim, ds.output_dim)]
        for remat in (False, True):
            runs[f"{route} remat={remat}"] = (route, None, w, dict(
                mode="scan", dropouts=(0.3, 0.3), remat=remat))
    results = run_world(fit_routes, 2, tmp_path, runs, 4)
    for rank, got in enumerate(results):
        for name in runs:
            if name.endswith("remat=True"):
                plain = got[name.replace("remat=True", "remat=False")]
                np.testing.assert_array_equal(got[name][0], plain[0], err_msg=f"{name} {rank}")
                assert got[name][1] == plain[1], name
                assert plain[0][-1, 0] < plain[0][0, 0], name
