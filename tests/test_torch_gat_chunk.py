"""The GAT's streaming segment attention (``edge_chunk``) of
parallel_gcn_tpu_torch against the JAX package and against its own
unchunked attention.

- At attention dropout 0 the chunked forward and its loss gradients match
  JAX's ``_attend_segment_chunked`` (``GATModel(edge_chunk=...)``) with
  chunks of 64 and 100 edges (100: a shorter last chunk), rtol 2e-5 / atol
  2e-5 for the forward, rtol 2e-4 / atol 2e-5 for the gradients (the bounds
  of ``tests/test_torch_gat.py``).
- The chunked attention equals the port's unchunked one within 1e-5 at
  attention dropout 0 and 0.5: the chunks draw their slices of the
  unchunked mask through K1's element offset.
- ``fit`` with ``edge_chunk`` matches JAX's epoch trajectory for 5 epochs at
  dropout 0 (1e-5), and the unchunked ``fit`` with feature and attention
  dropout within rtol 2e-4 / atol 2e-5 (the bound of JAX's own test).
- At world 2 (gloo), JAX's ``test_gat_parallel_edge_chunk_matches_unchunked``
  setting with the all_gather and boundary halos: chunked against unchunked
  within rtol 2e-4 / atol 2e-5, and at dropout 0 against JAX's
  ``fit_parallel`` within 1e-5.
- The tile backend refuses ``edge_chunk`` (ValueError), on one card and on
  the mesh.

JAX is imported inside the tests only: the gloo ranks import this module.
"""

import warnings

import numpy as np
import pytest
import torch

from parallel_gcn_tpu_torch.config import Config
from parallel_gcn_tpu_torch.convert import params_from_numpy
from parallel_gcn_tpu_torch.data.graph import add_self_loops_csr, build_graph, random_graph
from parallel_gcn_tpu_torch.data.parser import Dataset, to_device
from parallel_gcn_tpu_torch.models.gat import GATModel, attend_chunked, edge_chunks
from parallel_gcn_tpu_torch.parallel import train_parallel as tpl
from parallel_gcn_tpu_torch.train import fit
from test_torch_parallel import run_world

torch.set_num_threads(1)
CPU = torch.device("cpu")
N, F_IN, C, H = 300, 10, 4, 2


def _params(seed=1, hidden=6):
    import jax

    from parallel_gcn_tpu.models.gat import init_gat_params as jax_init_gat_params

    jp = jax_init_gat_params(jax.random.PRNGKey(seed), F_IN, [hidden], C, H)
    return jp, jax.tree.map(np.asarray, jp)


def _data():
    csr, _ = random_graph(N, 8, seed=3)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((N, F_IN)).astype(np.float32)
    return csr, x


def _loss(logits):
    return (logits * torch.cos(logits)).sum()


@pytest.mark.parametrize("chunk", [64, 100])
def test_chunked_attention_matches_jax(chunk):
    import jax
    import jax.numpy as jnp

    from parallel_gcn_tpu.data.graph import build_graph as jax_build_graph
    from parallel_gcn_tpu.models.gat import GATModel as JaxGAT

    csr, x = _data()
    jp, pnp = _params()
    graph = build_graph(csr, device=CPU)
    jg = jax_build_graph(csr)
    assert graph.n_nodes == jg.n_nodes and chunk < graph.n_edges_pad
    xp = np.zeros((graph.n_nodes, F_IN), np.float32)
    xp[:N] = x
    model = GATModel(params_from_numpy(pnp), (0.0, 0.0), heads=H, backend="segment",
                     edge_chunk=chunk)
    out = model(torch.from_numpy(xp), graph, training=True)
    grads = torch.autograd.grad(_loss(out), list(model.weights))
    assert len(model._chunks) == 1  # both layers share the graph's chunks

    jm = JaxGAT(n_layers=2, dropouts=(0.0, 0.0), heads=H, backend="segment",
                edge_chunk=chunk)

    def jloss(params):
        logits = jm.apply(params, jnp.asarray(xp), jg, training=True)
        return jnp.sum(logits * jnp.cos(logits)), logits

    (_, jout), jgrads = jax.value_and_grad(jloss, has_aux=True)(jp)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), rtol=2e-5, atol=2e-5)
    for a, b in zip(grads, jax.tree.leaves(jgrads)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("rate", [0.0, 0.5])
@pytest.mark.parametrize("chunk", [64, 100])
def test_chunked_attention_equals_unchunked(rate, chunk):
    """One layer's attention output within 1e-5 of the unchunked softmax at
    the same attention-dropout mask, and the model's gradients within rtol
    1e-4 / atol 1e-5 (the sums run in another order)."""
    csr, x = _data()
    _, pnp = _params()
    graph = build_graph(csr, device=CPU)
    n = graph.n_nodes
    rng = np.random.default_rng(1)
    s = torch.from_numpy(rng.standard_normal((n, H)).astype(np.float32))
    t = torch.from_numpy(rng.standard_normal((n, H)).astype(np.float32))
    hw = torch.from_numpy(rng.standard_normal((n, H, 5)).astype(np.float32))
    model = GATModel(params_from_numpy(pnp), (0.0, 0.0), heads=H, backend="segment",
                     attn_dropout=rate)
    ref = model._attend_segment(graph, hw, s, t, 12345, training=True)
    chunks = edge_chunks(graph.row, graph.col, graph.val, n, n, chunk)
    assert all(c.start % 4 == 0 for c in chunks) and len(chunks) > 2
    got = attend_chunked(chunks, s, t, hw, 12345, rate)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-5, atol=1e-5)
    if rate:
        # the mask is the unchunked one: dropping changed the output
        plain = attend_chunked(chunks, s, t, hw)
        assert (plain - got).abs().max() > 1e-2

    xp = torch.zeros((n, F_IN))
    xp[:N] = torch.from_numpy(x)
    grads = {}
    for ch in (0, chunk):
        m = GATModel(params_from_numpy(pnp), (0.0, 0.0), heads=H, backend="segment",
                     attn_dropout=rate, edge_chunk=ch)
        out = m(xp, graph, training=True, seeds=[1, 5, 2, 7])
        grads[ch] = (out.detach(), torch.autograd.grad(_loss(out), list(m.weights)))
    np.testing.assert_allclose(grads[chunk][0].numpy(), grads[0][0].numpy(), rtol=1e-5,
                               atol=1e-5)
    for a, b in zip(grads[chunk][1], grads[0][1]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4, atol=1e-5)


def _configure(cfg, epochs, chunk, dropouts=(0.0, 0.0), attn=0.0):
    cfg.gcn.model, cfg.gcn.heads = "gat", H
    cfg.gcn.hidden_dims, cfg.gcn.dropouts = (8,), dropouts
    cfg.gcn.attn_dropout = attn
    cfg.gcn.epochs, cfg.gcn.early_stopping = epochs, 0
    cfg.tpu.backend, cfg.tpu.edge_chunk = "segment", chunk
    cfg.tpu.matmul_precision = "highest"
    cfg.train.verbose, cfg.train.mode = False, "eager"
    return cfg


def _dataset():
    from parallel_gcn_tpu_torch.data.synthetic import make_synthetic_dataset

    return make_synthetic_dataset(
        "traj", n_nodes=500, n_edges=8000, input_dim=24, n_classes=6,
        n_train=280, n_val=100, feature_nnz_per_row=8, n_communities=6,
    )


def test_chunked_fit_matches_jax_trajectory():
    """5 epochs at dropout 0 with ``edge_chunk`` 1000 (of 8,000+ edges)
    against JAX's epoch step from the same parameters: losses within 1e-5,
    accuracies within one node."""
    import jax

    from parallel_gcn_tpu import train as jtrain
    from parallel_gcn_tpu.config import Config as JaxConfig
    from parallel_gcn_tpu.data.parser import to_device as jax_to_device
    from parallel_gcn_tpu.optim import init_adam as jax_init_adam
    from parallel_gcn_tpu_torch import train as ttrain
    from parallel_gcn_tpu_torch.optim import init_adam

    epochs = 5
    ds = _dataset()
    jcfg, tcfg = _configure(JaxConfig(), epochs, 1000), _configure(Config(), epochs, 1000)
    jdds = jax_to_device(ds)
    jmodel = jtrain.build_model(jcfg, jdds)
    assert jmodel.edge_chunk == 1000 and jmodel.backend == "segment"
    jw = jtrain.init_model_params(jcfg, jax.random.PRNGKey(3), ds.input_dim, ds.output_dim)
    w_np = jax.tree.map(np.asarray, jw)
    jopt = jax_init_adam(jw)
    jstep = jtrain.make_epoch_step(jmodel, jcfg, jdds)
    key = jax.random.PRNGKey(0)
    jhist = []
    for _ in range(epochs):
        jw, jopt, key, m = jstep(jw, jopt, key)
        jhist.append(np.asarray(m))

    tdds = to_device(ds, device=CPU)
    tmodel = ttrain.build_model(tcfg, tdds, params_from_numpy(w_np))
    assert tmodel.edge_chunk == 1000 and tmodel.backend == "segment"
    topt = init_adam(list(tmodel.weights))
    tstep = ttrain.make_epoch_step(tmodel, tcfg, tdds)
    gen = torch.Generator().manual_seed(0)
    thist = np.stack([tstep(topt, ttrain.epoch_seeds(gen, 2, attention=True)).numpy()
                      for _ in range(epochs)])
    jhist = np.stack(jhist)
    np.testing.assert_allclose(thist[:, [0, 2]], jhist[:, [0, 2]], atol=1e-5, rtol=0)
    assert (np.abs(thist[:, 1] - jhist[:, 1]) * ds.train_dim <= 1.01).all()
    assert (np.abs(thist[:, 3] - jhist[:, 3]) * ds.val_dim <= 1.01).all()


@pytest.mark.parametrize("mode", ["eager", "scan"])
def test_chunked_fit_tracks_unchunked_with_dropout(mode):
    """Feature dropout 0.3 and attention dropout 0.3, 8 epochs: the same
    masks, so the trajectories part by rounding only."""
    ds = _dataset()
    dds = to_device(ds, device=CPU)
    runs = {}
    for chunk in (0, 1000):
        cfg = _configure(Config(), 8, chunk, dropouts=(0.3, 0.3), attn=0.3)
        cfg.train.mode = mode
        runs[chunk] = fit(cfg, dds)
    np.testing.assert_allclose(runs[1000].history, runs[0].history, rtol=2e-4, atol=2e-5)
    assert runs[1000].test_acc == pytest.approx(runs[0].test_acc, abs=1e-4)


def _community_dataset(n=150, f=12, c=3, seed=0):
    """``tests/test_model.py``'s ``_synthetic`` (a separable community
    graph) built with the port's CSR builder, so that a rank imports no
    JAX."""
    rng = np.random.default_rng(seed)
    labels = (np.arange(n) * c // n).astype(np.int32)
    nb = {i: set() for i in range(n)}
    for _ in range(n * 3):
        a = int(rng.integers(0, n))
        pool = np.where(labels == labels[a])[0] if rng.random() < 0.9 else np.arange(n)
        b = int(pool[rng.integers(0, len(pool))])
        if a != b:
            nb[a].add(b)
            nb[b].add(a)
    csr = add_self_loops_csr([np.array(sorted(nb[i]), dtype=np.int32) for i in range(n)])
    x = rng.standard_normal((n, f)).astype(np.float32) * 0.2
    x[np.arange(n), labels] += 2.0
    split = rng.choice([1, 2, 3], size=n, p=[0.5, 0.25, 0.25]).astype(np.int32)
    return Dataset(name="t", graph=csr, feature_csr=None, features=x, labels=labels,
                   split=split, n_nodes=n, input_dim=f, output_dim=c)


def mesh_gat_config(halo: str, chunk: int, dropout: float, weight_decay=None) -> Config:
    """JAX's ``test_gat_parallel_edge_chunk_matches_unchunked`` setting."""
    cfg = Config()
    cfg.gcn.model, cfg.gcn.heads, cfg.gcn.remat = "gat", 2, True
    cfg.gcn.hidden_dims, cfg.gcn.dropouts = (8,), (dropout, dropout)
    cfg.gcn.epochs, cfg.gcn.early_stopping = 8, 0
    cfg.tpu.backend, cfg.tpu.seed, cfg.tpu.halo = "segment", 7, halo
    cfg.tpu.matmul_precision, cfg.tpu.edge_chunk = "highest", chunk
    cfg.tpu.halo_fallback = False
    if weight_decay is not None:
        cfg.adam.weight_decay = weight_decay
    cfg.train.verbose, cfg.train.mode = False, "eager"
    return cfg


def fit_gat_chunk_runs(rank, world, runs):
    """``fit_parallel`` of each run (name -> (halo, chunk, dropout, weight
    decay, initial weights or None)): (history, test_acc, chunks built)."""
    ds = _community_dataset()
    out = {}
    for name, (halo, chunk, dropout, wd, w) in runs.items():
        cfg = mesh_gat_config(halo, chunk, dropout, wd)
        rank_run = tpl.build_rank(cfg, ds, rank, world, halo, CPU)
        n_edges = rank_run.graph.coo[0].shape[0]
        res = tpl.fit_parallel(cfg, ds, n_devices=world, device="cpu",
                               weights=None if w is None else [torch.from_numpy(a) for a in w])
        out[name] = (res.history, res.test_acc, -(-n_edges // chunk) if chunk else 0)
    return out


@pytest.mark.parametrize("halo", ["all_gather", "boundary"])
def test_mesh_chunked_gat_matches_unchunked_and_jax(tmp_path, halo):
    import jax

    from parallel_gcn_tpu.parallel.train_parallel import fit_parallel as jax_fit_parallel
    from test_torch_parallel_train import _jax_config, _jax_dataset, _jax_init

    ds = _community_dataset()
    jcfg = _jax_config(mesh_gat_config(halo, 100, 0.0, weight_decay=0.0))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        ref = jax_fit_parallel(jcfg, _jax_dataset(ds), n_devices=2)
    w = [t.numpy() for t in params_from_numpy(jax.tree.map(np.asarray, _jax_init(jcfg, ds)))]
    runs = {"unchunked": (halo, 0, 0.3, None, None), "chunked": (halo, 100, 0.3, None, None),
            "chunked rate 0": (halo, 100, 0.0, 0.0, w)}
    results = run_world(fit_gat_chunk_runs, 2, tmp_path, runs)
    for rank, got in enumerate(results):
        (a, acc_a, _), (b, acc_b, n_chunks) = got["unchunked"], got["chunked"]
        assert n_chunks > 2, n_chunks
        np.testing.assert_allclose(b, a, rtol=2e-4, atol=2e-5, err_msg=f"rank {rank}")
        assert acc_b == pytest.approx(acc_a, abs=1e-4)
        hist, test_acc, _ = got["chunked rate 0"]
        np.testing.assert_allclose(hist, np.asarray(ref.history), rtol=0, atol=1e-5,
                                   err_msg=f"rank {rank} against JAX")
        assert test_acc == pytest.approx(ref.test_acc, abs=1e-7)


def test_tile_backend_refuses_edge_chunk():
    from test_torch_parallel import mesh_config, mesh_dataset

    ds = _dataset()
    hybrid = to_device(ds, device=CPU, hybrid=True, tile_dtype="int8", tile_size=128,
                       min_tile_nnz=520)
    cfg = _configure(Config(), 1, 1024)
    cfg.tpu.backend = "hybrid"
    from parallel_gcn_tpu_torch import train as ttrain

    with pytest.raises(ValueError, match="edge_chunk"):
        ttrain.build_model(cfg, hybrid)
    cfg = mesh_config("gat-tiles-boundary")
    cfg.tpu.edge_chunk = 1024
    with pytest.raises(ValueError, match="edge_chunk"):
        tpl.fit_parallel(cfg, mesh_dataset(), n_devices=1, device="cpu")
