"""parallel_gcn_tpu_torch trainer with the opt-in fused kernels.

``ce_impl=pallas`` (K9): a 10-epoch dropouts-0 GCN trajectory of the port's
epoch step against the JAX package's ``make_epoch_step`` with K9 (and the
tile SpMM) in interpret mode, from identical weights: losses agree to atol
1e-4, accuracies to one node per split. ``fuse_dropout_matmul`` (K10): the
port's fused and unfused paths share K1's mask, so their 5-epoch histories
agree within 1e-5 (f32, matmul precision highest). Plus ``build_model`` and
the CLI with both knobs, a GAT epoch with K9, and
``sparse_feature_transform`` against JAX.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import parallel_gcn_tpu.ops.pallas_bcsr as pb
import parallel_gcn_tpu.ops.pallas_ce as pce
from parallel_gcn_tpu import train as jtrain
from parallel_gcn_tpu.config import Config as JaxConfig
from parallel_gcn_tpu.data.parser import to_device as jax_to_device
from parallel_gcn_tpu.ops.sparse_matmul import (
    sparse_feature_transform as jax_sparse_feature_transform,
)
from parallel_gcn_tpu.optim import init_adam as jax_init_adam
from parallel_gcn_tpu_torch import train as ttrain
from parallel_gcn_tpu_torch.cli import main as cli_main
from parallel_gcn_tpu_torch.config import Config
from parallel_gcn_tpu_torch.convert import params_from_numpy
from parallel_gcn_tpu_torch.data.parser import TEST, to_device
from parallel_gcn_tpu_torch.data.synthetic import make_synthetic_dataset
from parallel_gcn_tpu_torch.ops import cuda_ce, cuda_dropout, cuda_fused
from parallel_gcn_tpu_torch.ops.cuda_ce import masked_softmax_xent_fused
from parallel_gcn_tpu_torch.ops.loss import masked_softmax_xent
from parallel_gcn_tpu_torch.ops.sparse_matmul import sparse_feature_transform
from parallel_gcn_tpu_torch.optim import init_adam

torch.set_num_threads(1)

CPU = torch.device("cpu")
LAYOUT = dict(hybrid=True, tile_dtype="int8", tile_size=128, min_tile_nnz=520)


@pytest.fixture(autouse=True)
def interpret_mode():
    from jax.experimental.pallas import tpu as pltpu

    old = pb._INTERPRET[0], pce._INTERPRET[0]
    pb._INTERPRET[0], pce._INTERPRET[0] = pltpu.InterpretParams(), True
    yield
    pb._INTERPRET[0], pce._INTERPRET[0] = old


def _configure(cfg, epochs, dropouts=(0.0, 0.0)):
    cfg.gcn.hidden_dims, cfg.gcn.dropouts = (16,), dropouts
    cfg.gcn.epochs, cfg.gcn.early_stopping = epochs, 0
    cfg.adam.weight_decay = 5e-4
    cfg.tpu.backend, cfg.tpu.tile_dtype = "hybrid", "int8"
    cfg.tpu.tile_size, cfg.tpu.min_tile_nnz = 128, 520
    cfg.tpu.ce_impl, cfg.tpu.matmul_precision = "pallas", "highest"
    cfg.train.verbose, cfg.train.mode = False, "eager"
    return cfg


def _dataset():
    return make_synthetic_dataset(
        "traj", n_nodes=500, n_edges=8000, input_dim=24, n_classes=6,
        n_train=280, n_val=100, feature_nnz_per_row=8, n_communities=6,
    )


def test_pallas_ce_trajectory_matches_jax():
    epochs = 10
    ds = _dataset()
    jcfg, tcfg = _configure(JaxConfig(), epochs), _configure(Config(), epochs)

    jdds = jax_to_device(ds, **LAYOUT)
    jmodel = jtrain.build_model(jcfg, jdds)
    jmodel, jdds = jtrain.preaggregate_input(jmodel, jdds)
    jw = jtrain.init_model_params(jcfg, jax.random.PRNGKey(3), ds.input_dim, ds.output_dim)
    w_np = [np.asarray(w) for w in jw]
    jopt = jax_init_adam(jw)
    jstep = jtrain.make_epoch_step(jmodel, jcfg, jdds)
    key = jax.random.PRNGKey(0)
    jhist = []
    for _ in range(epochs):
        jw, jopt, key, m = jstep(jw, jopt, key)
        jhist.append(np.asarray(m))

    tdds = to_device(ds, device=CPU, **LAYOUT)
    tmodel = ttrain.build_model(tcfg, tdds, params_from_numpy(w_np, CPU))
    tdds = ttrain.preaggregate_input(tmodel, tdds)
    assert ttrain._ce_fn(tcfg) is masked_softmax_xent_fused
    topt = init_adam(list(tmodel.weights))
    tstep = ttrain.make_epoch_step(tmodel, tcfg, tdds)
    gen = torch.Generator().manual_seed(0)
    thist = [tstep(topt, ttrain.epoch_seeds(gen, 2)).numpy() for _ in range(epochs)]

    jhist, thist = np.stack(jhist), np.stack(thist)
    np.testing.assert_allclose(thist[:, [0, 2]], jhist[:, [0, 2]], atol=1e-4, rtol=0)
    assert (np.abs(thist[:, 1] - jhist[:, 1]) * ds.train_dim <= 1.01).all()
    assert (np.abs(thist[:, 3] - jhist[:, 3]) * ds.val_dim <= 1.01).all()
    assert thist[-1, 0] < thist[0, 0]

    jtest = jtrain.make_eval_fn(jmodel, jcfg, jdds, TEST)(jw)
    ttest = ttrain.make_eval_fn(tmodel, tcfg, tdds, TEST)()
    assert float(ttest[0]) == pytest.approx(float(jtest[0]), abs=1e-4)
    assert abs(float(ttest[1]) - float(jtest[1])) * ds.test_dim <= 1.01


def test_ce_impl_selects_the_loss():
    cfg = Config()
    for impl, fn in (("auto", masked_softmax_xent), ("xla", masked_softmax_xent),
                     ("pallas", masked_softmax_xent_fused)):
        cfg.tpu.ce_impl = impl
        assert ttrain._ce_fn(cfg) is fn


@pytest.mark.parametrize("dropouts,preagg", [((0.3, 0.3), False), ((0.0, 0.1), True)])
def test_fused_and_unfused_trajectories_agree(dropouts, preagg, monkeypatch):
    """Both paths draw K1's mask from the same seeds, so the knob changes a
    trajectory by matmul rounding only. Without pre-aggregation layer 0
    runs the fused branch with need_dx=False."""
    ds = _dataset()
    w_np = [np.asarray(w) for w in jtrain.init_model_params(
        _configure(JaxConfig(), 1), jax.random.PRNGKey(5), ds.input_dim, ds.output_dim)]
    need_dx = []
    fused_apply = cuda_fused._DropoutMatmul.apply

    def spy(x, w, seed, rate, dx):
        need_dx.append(dx)
        return fused_apply(x, w, seed, rate, dx)

    monkeypatch.setattr(cuda_fused._DropoutMatmul, "apply", spy)
    hist = {}
    for fuse in (False, True):
        cfg = _configure(Config(), 5, dropouts)
        cfg.tpu.fuse_dropout_matmul, cfg.tpu.input_preagg = fuse, preagg
        res = ttrain.fit(cfg, to_device(ds, device=CPU, **LAYOUT),
                         weights=params_from_numpy(w_np, CPU))
        hist[fuse] = res.history
    np.testing.assert_allclose(hist[True], hist[False], atol=1e-5, rtol=0)
    assert hist[True][-1, 0] < hist[True][0, 0]
    want = [False, True] if dropouts[0] > 0 else [True]
    assert need_dx == want * 5


def test_build_model_accepts_both_knobs():
    cfg = _configure(Config(), 1, (0.2, 0.2))
    cfg.tpu.fuse_dropout_matmul = True
    model = ttrain.build_model(cfg, to_device(_dataset(), device=CPU, **LAYOUT))
    assert model.fuse_dropout_matmul


def test_gat_trains_with_pallas_ce_on_tiles(monkeypatch):
    calls = []
    run = cuda_ce._run

    def spy(logits, labels, mask, num, write_grad):
        calls.append(write_grad)
        return run(logits, labels, mask, num, write_grad)

    monkeypatch.setattr(cuda_ce, "_run", spy)
    cfg = _configure(Config(), 1, (0.0, 0.2))
    cfg.gcn.model, cfg.gcn.heads, cfg.gcn.hidden_dims = "gat", 2, (4,)
    cfg.tpu.fuse_dropout_matmul = True  # a no-op for the GAT, as in JAX
    res = ttrain.fit(cfg, to_device(_dataset(), device=CPU, **LAYOUT))
    assert res.epochs_run == 1 and np.isfinite(res.history).all()
    assert calls == [True, False, False]  # train, val, test


def test_cli_trains_with_both_knobs_on_cpu(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("PGCN_CACHE_DIR", str(tmp_path))
    before = (dict(cuda_ce.launches), dict(cuda_fused.launches),
              dict(cuda_dropout.launches))
    rc = cli_main(["synth-medium", "device=cpu", "ce_impl=pallas",
                   "fuse_dropout_matmul=true", "epochs=2", "hidden_dims=8", "mode=eager"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "epoch=2 " in out and "test_acc=" in out and "epochs_run=2" in out
    # the CPU takes the plain versions
    assert (cuda_ce.launches, cuda_fused.launches, cuda_dropout.launches) == before


def test_sparse_feature_transform_matches_jax():
    rng = np.random.default_rng(7)
    n, f, h = 40, 64, 16
    dense = (rng.random((n, f)) < 0.15) * rng.standard_normal((n, f))
    w = rng.standard_normal((f, h)).astype(np.float32)
    rows, cols = np.nonzero(dense)
    vals = dense[rows, cols].astype(np.float32)
    jargs = (jnp.asarray(rows.astype(np.int32)), jnp.asarray(cols.astype(np.int32)),
             jnp.asarray(vals))
    targs = (torch.from_numpy(rows), torch.from_numpy(cols), torch.from_numpy(vals))
    want = jax_sparse_feature_transform(*jargs, jnp.asarray(w), n)
    wt = torch.from_numpy(w).requires_grad_(True)
    got = sparse_feature_transform(*targs, wt, n)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got.detach().numpy(), dense.astype(np.float32) @ w,
                               rtol=2e-5, atol=2e-5)
    jgrad = jax.grad(
        lambda w: jnp.sum(jax_sparse_feature_transform(*jargs, w, n) ** 2))(jnp.asarray(w))
    (got ** 2).sum().backward()
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(jgrad), rtol=1e-4, atol=1e-4)
