"""Seed lanes: the laned dropout against the solo one, ``fit_seeds``' lanes
against solo ``fit`` runs, and against the JAX package's ``vmap``ped
whole-run program (``harness/accuracy.py:62-73``), on the CPU."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parallel_gcn_tpu import train as jtrain
from parallel_gcn_tpu.config import Config as JaxConfig
from parallel_gcn_tpu.data.parser import to_device as jax_to_device
from parallel_gcn_tpu.optim import init_adam as jax_init_adam
from parallel_gcn_tpu_torch import seeds as sd
from parallel_gcn_tpu_torch import train
from parallel_gcn_tpu_torch.config import Config
from parallel_gcn_tpu_torch.convert import params_from_numpy
from parallel_gcn_tpu_torch.data.parser import TEST, to_device
from parallel_gcn_tpu_torch.data.synthetic import make_synthetic_dataset
from parallel_gcn_tpu_torch.ops import cuda_dropout as cd

torch.set_num_threads(1)
CPU = torch.device("cpu")
SEEDS = [3, 11, 40]


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("width, offset", [(41, 0), (64, 0), (1433, 0), (64, 8)])
def test_laned_dropout_plain_is_the_solo_mask_lane_by_lane(relu, dtype, width, offset):
    rows, lanes = 37, len(SEEDS)
    gen = torch.Generator().manual_seed(width)
    x = torch.randn(rows, lanes * width, generator=gen).to(dtype)
    slot = torch.tensor(SEEDS, dtype=torch.int64)
    for seed in (SEEDS, slot):
        got = cd.dropout_plain(x, seed, 0.3, relu, offset)
        for s, one in enumerate(SEEDS):
            solo = cd.dropout_plain(x[:, s * width:(s + 1) * width].contiguous(), one, 0.3,
                                    relu, offset)
            assert torch.equal(got[:, s * width:(s + 1) * width], solo)
    # the wrappers' CPU branch and the backward, through autograd
    xr = x.clone().requires_grad_(True)
    fn = cd.relu_dropout if relu else cd.dropout
    out = fn(xr, slot, 0.3) if relu else fn(xr, slot, 0.3, offset)
    assert torch.equal(out, cd.dropout_plain(x, SEEDS, 0.3, relu, 0 if relu else offset))
    out.backward(torch.ones_like(out))
    for s, one in enumerate(SEEDS):
        xs = x[:, s * width:(s + 1) * width].contiguous().requires_grad_(True)
        solo = fn(xs, one, 0.3) if relu else fn(xs, one, 0.3, offset)
        solo.backward(torch.ones_like(solo))
        assert torch.equal(xr.grad[:, s * width:(s + 1) * width], xs.grad)


def test_laned_dropout_refuses_a_ragged_batch():
    with pytest.raises(ValueError, match="seed lanes need"):
        cd.dropout_plain(torch.zeros(4, 10), [1, 2, 3], 0.5)
    with pytest.raises(ValueError, match="uint64"):
        cd.lane_seeds([1, -2], CPU)


def _dataset():
    return make_synthetic_dataset(
        "lanes", n_nodes=400, n_edges=6000, input_dim=20, n_classes=5,
        n_train=200, n_val=80, feature_nnz_per_row=6, n_communities=5)


LAYOUTS = {"hybrid": dict(hybrid=True, tile_dtype="int8", tile_size=128, min_tile_nnz=300),
           "segment": {}, "dense": dict(dense=True)}


def _cfg(backend, dtype, k, epochs=12, dropouts=(0.0, 0.3)):
    cfg = Config()
    cfg.gcn.hidden_dims, cfg.gcn.dropouts = (16,), dropouts
    cfg.gcn.epochs, cfg.gcn.early_stopping = epochs, k
    cfg.adam.learning_rate = 0.5 if k else 0.01
    cfg.tpu.backend, cfg.tpu.compute_dtype = backend, dtype
    cfg.tpu.matmul_precision = "highest"
    cfg.train.verbose = False
    return cfg


def _close(got, want, dtype):
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    else:
        np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3 * np.abs(want).max())


@pytest.mark.parametrize("backend", list(LAYOUTS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k", [0, 3])
def test_lanes_are_solo_fit_runs(backend, dtype, k):
    dds = to_device(_dataset(), device=CPU, **LAYOUTS[backend])
    # an input dropout too where the epoch has no deferred eval
    cfg = _cfg(backend, dtype, k, epochs=30 if k else 12,
               dropouts=(0.2, 0.3) if k else (0.0, 0.3))
    res = sd.fit_seeds(cfg, dds, SEEDS)
    assert res.seeds == SEEDS and len(res.history) == len(SEEDS)
    for s, seed in enumerate(SEEDS):
        solo_cfg = copy.deepcopy(cfg)
        solo_cfg.tpu.seed = seed
        solo = train.fit(solo_cfg, dds)
        assert res.epochs_run[s] == solo.epochs_run
        _close(res.history[s], solo.history, dtype)
        _close(np.array([res.test_loss[s], res.test_acc[s]]),
               np.array([solo.test_loss, solo.test_acc]), dtype)
        assert res.val_acc[s] == res.history[s][-1, 3]
        for got, want in zip(res.weights[s], solo.weights):
            _close(got.numpy(), want.numpy(), dtype)
    if k:  # the lanes stop at different epochs, each where its solo run stops
        assert len(set(res.epochs_run)) > 1 and max(res.epochs_run) < 30


@pytest.mark.parametrize("knob", ["residual", "remat", "ce_impl"])
def test_lanes_with_residual_remat_and_fused_ce(knob):
    cfg = _cfg("segment", "float32", 0, epochs=6)
    if knob == "residual":
        cfg.gcn.n_layers, cfg.gcn.hidden_dims = 3, (16, 16)
        cfg.gcn.dropouts, cfg.gcn.residual = (0.0, 0.2, 0.3), True
    elif knob == "remat":
        cfg.gcn.remat = True
    else:
        cfg.tpu.ce_impl = "pallas"
    dds = to_device(_dataset(), device=CPU)
    res = sd.fit_seeds(cfg, dds, SEEDS[:2])
    for s, seed in enumerate(SEEDS[:2]):
        solo_cfg = copy.deepcopy(cfg)
        solo_cfg.tpu.seed = seed
        _close(res.history[s], train.fit(solo_cfg, dds).history, "float32")


def _jax_cfg(k, epochs):
    cfg = JaxConfig()
    cfg.gcn.hidden_dims, cfg.gcn.dropouts = (16,), (0.0, 0.0)
    cfg.gcn.epochs, cfg.gcn.early_stopping = epochs, k
    cfg.adam.learning_rate = 0.5 if k else 0.01
    cfg.tpu.backend, cfg.tpu.matmul_precision = "segment", "highest"
    cfg.train.verbose = False
    return cfg


@pytest.mark.parametrize("k, epochs", [(0, 15), (3, 40)])
def test_lanes_match_the_jax_vmapped_whole_run(k, epochs):
    ds = _dataset()
    jcfg = _jax_cfg(k, epochs)
    jdds = jax_to_device(ds)
    jmodel = jtrain.build_model(jcfg, jdds)
    jmodel, jdds = jtrain.preaggregate_input(jmodel, jdds)
    run = jtrain._make_scan_run(jmodel, jcfg, jdds)
    test_fn = jtrain.make_eval_fn(jmodel, jcfg, jdds, TEST)

    def one(init_key, run_key):  # harness/accuracy.py:62-70
        w = jtrain.init_model_params(jcfg, init_key, jdds.input_dim, jdds.output_dim)
        weights, _, metrics, epochs_run = run(w, jax_init_adam(w), run_key)
        _, test_acc = test_fn(weights)
        return metrics[jnp.maximum(epochs_run - 1, 0)][3], test_acc, epochs_run, metrics

    seeds = jnp.asarray(SEEDS)
    init_keys = jax.vmap(jax.random.PRNGKey)(seeds)
    j_val, j_test, j_epochs, j_hist = (np.asarray(a) for a in jax.vmap(one)(
        init_keys, jax.vmap(jax.random.PRNGKey)(seeds + 10_000)))

    cfg = _cfg("segment", "float32", k, epochs=epochs, dropouts=(0.0, 0.0))
    dds = to_device(ds, device=CPU)
    weights = [params_from_numpy([np.asarray(w) for w in jtrain.init_model_params(
        jcfg, key, ds.input_dim, ds.output_dim)], CPU) for key in init_keys]
    res = sd.fit_seeds(cfg, dds, SEEDS, weights=weights)
    assert list(j_epochs) == res.epochs_run
    if k:
        assert len(set(res.epochs_run)) > 1
    for s in range(len(SEEDS)):
        e = res.epochs_run[s]
        np.testing.assert_allclose(res.history[s], j_hist[s, :e], rtol=0, atol=1e-5)
    # an accuracy is a count over the split divided by its size: within
    # 1e-5 is the same count (the two divisions may round one ulp apart)
    np.testing.assert_allclose(res.val_acc, j_val, rtol=0, atol=1e-5)
    np.testing.assert_allclose(res.test_acc, j_test, rtol=0, atol=1e-5)


@pytest.mark.parametrize("over, match", [
    (dict(model="gat"), "model=gat"), (dict(model="sage"), "model=sage"),
    (dict(model="gin"), "model=gin"), (dict(fuse_dropout_matmul=True), "fuse_dropout_matmul"),
    (dict(n_devices=2), "one device"), (dict(tp=2), "one device"),
    (dict(mode="eager"), "mode=scan")])
def test_fit_seeds_refusals(over, match):
    cfg = _cfg("segment", "float32", 0)
    for key, val in over.items():
        section = cfg.gcn if hasattr(cfg.gcn, key) else (
            cfg.train if hasattr(cfg.train, key) else cfg.tpu)
        setattr(section, key, val)
    with pytest.raises(ValueError, match=match) as err:
        sd.fit_seeds(cfg, None, SEEDS)
    assert match != "model=sage" or "ROADMAP" in str(err.value)
