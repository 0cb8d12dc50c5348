"""SAGE and GIN in parallel_gcn_tpu_torch against the JAX package.

From the same numpy-seeded graph and the JAX package's parameters carried
across by ``convert.params_from_numpy``:
- the forward against ``golden_sage_forward`` / ``golden_gin_forward``
  (rtol 2e-5, atol 2e-5, the JAX package's own tolerance) and against JAX's
  ``apply`` (rtol 1e-5, atol 1e-5), and the weight gradients against
  ``jax.grad`` (rtol 1e-4, atol 1e-5·max|grad|: GIN's sums reach 10³), on
  the segment, dense and hybrid int8
  backends (JAX's tile kernel in interpret mode, as ``tests/test_sage.py``
  runs it);
- ``fit`` in ``mode=eager`` and ``mode=scan`` at dropout 0 against JAX's
  ``fit(mode=scan)``, f32 at ``matmul_precision=highest``: histories within
  1e-5, test accuracy within 1e-6;
- checkpoints: the per-layer key lists, a port file resumed by JAX and a JAX
  file resumed by the port (each within 1e-5 of the other package's
  uninterrupted run), and a port resume bit-equal to its own run;
- the model contract (leaf order, the decayed leaf, no pre-aggregation, the
  plain scan schedule with one seed per layer), the CLI, and that ``jax``
  stays out of ``sys.modules`` for the port.
Worlds of 2 are in ``tests/test_torch_sage_mesh.py``.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import parallel_gcn_tpu.ops.pallas_bcsr as pb
from parallel_gcn_tpu import train as jtrain
from parallel_gcn_tpu.config import Config as JaxConfig
from parallel_gcn_tpu.data.graph import build_graph as jax_build_graph
from parallel_gcn_tpu.data.parser import to_device as jax_to_device
from parallel_gcn_tpu.golden import golden_gin_forward, golden_sage_forward
from parallel_gcn_tpu.models.sage import GINModel as JaxGIN
from parallel_gcn_tpu.models.sage import SAGEModel as JaxSAGE
from parallel_gcn_tpu.models.sage import init_gin_params as jax_init_gin
from parallel_gcn_tpu.models.sage import init_sage_params as jax_init_sage
from parallel_gcn_tpu.utils.checkpoint import load_checkpoint as jax_load_checkpoint
from parallel_gcn_tpu_torch import train as ttrain
from parallel_gcn_tpu_torch.cli import main as cli_main
from parallel_gcn_tpu_torch.config import Config
from parallel_gcn_tpu_torch.convert import params_from_numpy, params_to_numpy
from parallel_gcn_tpu_torch.data.graph import build_graph, random_graph
from parallel_gcn_tpu_torch.data.parser import to_device
from parallel_gcn_tpu_torch.data.synthetic import SYNTHETIC_SPECS, make_synthetic_dataset
from parallel_gcn_tpu_torch.models.sage import (GINModel, SAGEModel, init_gin_params,
                                                init_sage_params)
from parallel_gcn_tpu_torch.utils.checkpoint import load_checkpoint

torch.set_num_threads(1)

CPU = torch.device("cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TILES = dict(hybrid=True, tile_dtype="int8", tile_size=128, min_tile_nnz=520)
FAMILIES = {"sage": (SAGEModel, JaxSAGE, jax_init_sage, golden_sage_forward),
            "gin": (GINModel, JaxGIN, jax_init_gin, golden_gin_forward)}


@pytest.fixture(autouse=True)
def interpret_mode():
    from jax.experimental.pallas import tpu as pltpu

    old = pb._INTERPRET[0]
    pb._INTERPRET[0] = pltpu.InterpretParams()
    yield
    pb._INTERPRET[0] = old


# backend -> build_graph keywords of both packages
LAYOUTS = {
    "segment": dict(),
    "dense": dict(dense=True),
    "hybrid": dict(hybrid=True, tile_dtype="int8", tile_size=128, tile_cols=128,
                   min_tile_nnz=120),
}


def _graphs(backend):
    csr = random_graph(300, 8, seed=5)[0]
    kw = LAYOUTS[backend]
    jkw = {k: (jnp.int8 if v == "int8" else v) for k, v in kw.items()}
    tg, jg = build_graph(csr, device=CPU, **kw), jax_build_graph(csr, **jkw)
    if backend == "hybrid":
        assert tg.is_hybrid and jg.is_hybrid
    return csr, tg, jg


def _jax_params(family, f_in, hidden, classes, seed):
    init = FAMILIES[family][2]
    return init(jax.random.PRNGKey(seed), f_in, hidden, classes)


@pytest.mark.parametrize("backend", sorted(LAYOUTS))
@pytest.mark.parametrize("family,eps,n_layers", [("sage", 0.0, 2), ("sage", 0.0, 3),
                                                 ("gin", 0.0, 2), ("gin", 0.4, 3)])
def test_forward_and_grads_match_golden_and_jax(backend, family, eps, n_layers):
    cls, jcls, _, golden = FAMILIES[family]
    csr, tg, jg = _graphs(backend)
    rng = np.random.default_rng(n_layers)
    x = np.zeros((tg.n_nodes, 10), np.float32)
    x[: csr.n_rows] = rng.standard_normal((csr.n_rows, 10))
    cot = rng.standard_normal((tg.n_nodes, 4)).astype(np.float32)
    jp = _jax_params(family, 10, [6] * (n_layers - 1), 4, seed=n_layers)
    pnp = jax.tree.map(np.asarray, jp)
    extra = dict(gin_eps=eps) if family == "gin" else {}
    model = cls(params_from_numpy(pnp), (0.0,) * n_layers, backend=backend, **extra)
    jmodel = jcls(n_layers=n_layers, dropouts=(0.0,) * n_layers, backend=backend,
                  precision="highest", **extra)

    out = model(torch.from_numpy(x), tg, training=False)
    gold = golden(pnp, x[: csr.n_rows], csr, **({"eps": eps} if family == "gin" else {}))
    np.testing.assert_allclose(out.detach().numpy()[: csr.n_rows], gold, rtol=2e-5, atol=2e-5)
    jout = jmodel.apply(jp, jnp.asarray(x), jg, training=False)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), rtol=1e-5, atol=1e-5)

    (out * torch.from_numpy(cot)).sum().backward()
    jgrad = jax.grad(lambda p: jnp.sum(jmodel.apply(p, jnp.asarray(x), jg, training=False)
                                       * cot))(jp)
    want = jax.tree.leaves(jgrad)
    assert len(want) == len(model.weights)
    for w, g in zip(model.weights, want):
        g = np.asarray(g)
        np.testing.assert_allclose(w.grad.numpy(), g, rtol=1e-4, atol=1e-5 * np.abs(g).max())


def test_leaf_order_and_the_decayed_leaf():
    sage = init_sage_params(torch.Generator().manual_seed(0), 10, [6, 5], 3)
    assert [tuple(w.shape) for w in sage] == [(10, 6), (10, 6), (6, 5), (6, 5), (5, 3), (5, 3)]
    gin = init_gin_params(torch.Generator().manual_seed(0), 10, [6, 5], 3)
    assert [tuple(w.shape) for w in gin] == [(10, 6), (6, 6), (6, 5), (5, 5), (5, 3)]
    assert SAGEModel.keys_for(3) == [("neigh", "self")] * 3
    assert GINModel.keys_for(3) == [("w1", "w2"), ("w1", "w2"), ("w1",)]
    # leaf 0 is the JAX leaf optim.decayed_leaf decays: neigh_0, w1_0
    jp = jax_init_gin(jax.random.PRNGKey(1), 10, [6, 5], 3)
    flat = params_from_numpy(jax.tree.map(np.asarray, jp))
    np.testing.assert_array_equal(flat[0].numpy(), np.asarray(jp[0]["w1"]))
    back = params_to_numpy(flat, GINModel.keys_for(3))
    assert [sorted(layer) for layer in back] == [["w1", "w2"], ["w1", "w2"], ["w1"]]
    with pytest.raises(ValueError, match="do not fit"):
        GINModel(flat[:-1], (0.0,) * 3)
    model = SAGEModel(init_sage_params(torch.Generator(), 4, [3], 2), (0.0, 0.0))
    assert not model.supports_deferred_eval and not model.input_preagg
    with pytest.raises(ValueError, match="GCN rewrite"):
        model(torch.zeros(5, 4), None, training=False, input_preagg=True)


def _dataset():
    return make_synthetic_dataset(
        "sage", n_nodes=500, n_edges=8000, input_dim=24, n_classes=6,
        n_train=280, n_val=100, feature_nnz_per_row=8, n_communities=6,
    )


def _config(cfg, family, *, epochs=8, backend="hybrid", mode="scan", eps=0.0, ckpt_dir="",
            every=0):
    cfg.gcn.model, cfg.gcn.gin_eps = family, eps
    cfg.gcn.hidden_dims, cfg.gcn.dropouts = (16,), (0.0, 0.0)
    cfg.gcn.epochs, cfg.gcn.early_stopping = epochs, 0
    cfg.adam.learning_rate, cfg.adam.weight_decay = 0.01, 5e-4
    cfg.tpu.backend, cfg.tpu.tile_dtype = backend, "int8"
    cfg.tpu.tile_size, cfg.tpu.min_tile_nnz = 128, 520
    cfg.tpu.matmul_precision = "highest"
    cfg.train.verbose, cfg.train.mode = False, mode
    cfg.train.checkpoint_dir, cfg.train.checkpoint_every = ckpt_dir, every
    return cfg


def _jax_init(jcfg, ds):
    """JAX fit's initial weights (the init half of its key's first split)."""
    _, init_key = jax.random.split(jax.random.PRNGKey(jcfg.tpu.seed))
    return jax.tree.map(np.asarray, jtrain.init_model_params(jcfg, init_key, ds.input_dim,
                                                             ds.output_dim))


@pytest.mark.parametrize("family,backend,eps", [("sage", "hybrid", 0.0),
                                                ("sage", "segment", 0.0),
                                                ("gin", "hybrid", 0.0),
                                                ("gin", "segment", 0.3)])
def test_fit_matches_jax_scan(family, backend, eps):
    ds = _dataset()
    layout = TILES if backend == "hybrid" else {}
    jcfg = _config(JaxConfig(), family, backend=backend, eps=eps)
    jres = jtrain.fit(jcfg, jax_to_device(ds, **layout))
    w = params_from_numpy(_jax_init(jcfg, ds))
    dds = to_device(ds, device=CPU, **layout)
    for mode in ("scan", "eager"):
        tres = ttrain.fit(_config(Config(), family, backend=backend, eps=eps, mode=mode), dds,
                          weights=[t.clone() for t in w])
        assert tres.epochs_run == jres.epochs_run == 8
        np.testing.assert_allclose(tres.history, np.asarray(jres.history), rtol=0, atol=1e-5,
                                   err_msg=mode)
        assert tres.test_acc == pytest.approx(float(jres.test_acc), abs=1e-6)
    assert tres.history[-1, 0] < tres.history[0, 0]


def test_scan_schedule_is_plain_with_one_seed_per_layer():
    dds = to_device(_dataset(), device=CPU)
    for family in ("sage", "gin"):
        cfg = _config(Config(), family, backend="segment")
        model = ttrain.build_model(cfg, dds)
        assert ttrain.scan_schedule(model, cfg) == (0, False)
        loop = ttrain.make_scan_loop(model, cfg, dds, ttrain.init_adam(list(model.weights)),
                                     torch.Generator().manual_seed(0))
        assert loop.final_val is None and loop.table.shape == (8, 2)
        assert loop.seeds.attn is None


@pytest.mark.parametrize("family", ["sage", "gin"])
def test_checkpoints_move_between_the_packages(family, tmp_path):
    ds = _dataset()
    dds = to_device(ds, device=CPU)
    jdds = jax_to_device(ds)
    jcfg = _config(JaxConfig(), family, backend="segment", epochs=10)
    w = params_from_numpy(_jax_init(jcfg, ds))
    jplain = jtrain.fit(jcfg, jdds)
    plain = ttrain.fit(_config(Config(), family, backend="segment", epochs=10), dds,
                       weights=[t.clone() for t in w])

    # the port writes JAX's per-layer dicts; JAX reads and resumes them
    port_dir = str(tmp_path / "port")
    ttrain.fit(_config(Config(), family, backend="segment", epochs=10, ckpt_dir=port_dir,
                       every=4), dds, weights=[t.clone() for t in w])
    port_file = os.path.join(port_dir, "ckpt_000004.npz")
    jw, jopt, epoch, key = jax_load_checkpoint(port_file)
    assert epoch == 4 and int(jopt.step) == 4 and key is None
    if family == "sage":
        assert all(set(layer) == {"neigh", "self"} for layer in jw)
    else:
        assert set(jw[0]) == {"w1", "w2"} and set(jw[1]) == {"w1"}
    jres = jtrain.fit(_config(JaxConfig(), family, backend="segment", epochs=10), jdds,
                      resume_from=port_file)
    np.testing.assert_allclose(np.asarray(jres.history), plain.history[4:], rtol=0, atol=1e-5)

    # the port resumes its own file bit for bit, and a JAX file within 1e-5
    ck = load_checkpoint(port_file)
    assert ck.epoch == 4 and ck.step == 4 and len(ck.weights) == len(w)
    resumed = ttrain.fit(_config(Config(), family, backend="segment", epochs=10), dds,
                         resume_from=port_file)
    assert resumed.start_epoch == 4 and resumed.epochs_run == 6
    np.testing.assert_array_equal(resumed.history, plain.history[4:])
    jax_dir = str(tmp_path / "jax")
    jtrain.fit(_config(JaxConfig(), family, backend="segment", epochs=10, ckpt_dir=jax_dir,
                       every=4), jdds)
    from_jax = ttrain.fit(_config(Config(), family, backend="segment", epochs=10), dds,
                          resume_from=os.path.join(jax_dir, "ckpt_000004.npz"))
    np.testing.assert_allclose(from_jax.history, np.asarray(jplain.history)[4:], rtol=0,
                               atol=1e-5)
    assert from_jax.test_acc == pytest.approx(float(jplain.test_acc), abs=1e-6)


def test_fit_notes_preagg_and_never_imports_jax():
    code = (
        "import sys, torch\n"
        "from parallel_gcn_tpu_torch.config import Config\n"
        "from parallel_gcn_tpu_torch.data.parser import to_device\n"
        "from parallel_gcn_tpu_torch.data.synthetic import make_synthetic_dataset\n"
        "from parallel_gcn_tpu_torch.train import fit\n"
        "ds = make_synthetic_dataset('fit', n_nodes=400, n_edges=5000, input_dim=16,\n"
        "    n_classes=4, n_train=200, n_val=80, feature_nnz_per_row=6, n_communities=4)\n"
        "dds = to_device(ds, device=torch.device('cpu'), hybrid=True, tile_size=128,\n"
        "    tile_dtype='int8', min_tile_nnz=300)\n"
        "for family in ('sage', 'gin'):\n"
        "    cfg = Config()\n"
        "    cfg.gcn.model, cfg.gcn.hidden_dims, cfg.gcn.epochs = family, (8,), 2\n"
        "    cfg.gcn.dropouts, cfg.gcn.remat = (0.2, 0.2), True\n"
        "    cfg.tpu.input_preagg, cfg.train.mode = True, 'scan'\n"
        "    assert fit(cfg, dds, verbose=True).epochs_run == 2\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'parallel_gcn_tpu')]\n"
        "print('JAX_MODULES', bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "note: input_preagg has no SAGE analog — ignored" in proc.stdout
    assert "note: input_preagg has no GIN analog — ignored" in proc.stdout
    assert "JAX_MODULES []" in proc.stdout


@pytest.mark.parametrize("argv", [["model=sage"], ["model=gin", "gin_eps=0.1"]])
def test_cli_trains_sage_and_gin_on_cpu(argv, tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("PGCN_CACHE_DIR", str(tmp_path))
    rc = cli_main(["synth-medium", *argv, "hidden_dims=8", "epochs=2", "device=cpu",
                   "mode=eager", "remat=true"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "epoch=2 " in out and "test_acc=" in out and "epochs_run=2" in out
    assert cli_main(["no-such-dataset", *argv, "device=cpu"]) == 2


def test_gin_at_synth_reddits_rate_rises_in_both_packages(capsys):
    """GIN-0 at synth-reddit's learning rate 0.01 (its parameter file's,
    weight decay 5e-5, dropout 0) on a 2000-node cut of synth-reddit's
    generated graph at its widths 602 -> 600 -> 41 (its mean degree), f32
    on the segment backend: the train loss rises more than twofold after
    the first epoch in JAX's ``fit`` and in the port's, and the two
    histories agree within rtol 1e-5. The rise is the configuration's
    dynamics (an unnormalised sum over ~50 neighbours under Adam's steps at
    0.01), not a fault of either package; ``chip_smoke.py`` sees it at full
    size on the card."""
    spec = dict(SYNTHETIC_SPECS["synth-reddit"])
    cut = 2000 / spec["n_nodes"]
    spec.update({k: int(spec[k] * cut) for k in ("n_nodes", "n_edges", "n_train", "n_val")})
    ds = make_synthetic_dataset("gin-rate", **spec)
    cfgs = []
    for cfg in (JaxConfig(), Config()):
        _config(cfg, "gin", backend="segment", epochs=3)
        cfg.gcn.hidden_dims, cfg.adam.weight_decay = (600,), 5e-5
        cfgs.append(cfg)
    jres = jtrain.fit(cfgs[0], jax_to_device(ds))
    tres = ttrain.fit(cfgs[1], to_device(ds, device=CPU),
                      weights=params_from_numpy(_jax_init(cfgs[0], ds)))
    with capsys.disabled():
        print(f"\nGIN-0 at lr 0.01, 2000-node cut of synth-reddit: train loss JAX "
              f"{np.asarray(jres.history)[:, 0].tolist()}, port {tres.history[:, 0].tolist()}")
    np.testing.assert_allclose(tres.history, np.asarray(jres.history), rtol=1e-5, atol=0)
    for hist in (tres.history, np.asarray(jres.history)):
        assert hist[1, 0] > 2 * hist[0, 0], hist[:, 0]
