"""parallel_gcn_tpu_torch trainer on the GAT path against the JAX package.

A 10-epoch dropout-0 trajectory of the port's ``make_epoch_step`` with
``model=gat backend=hybrid`` (the tile backend) against JAX's, from the
parameters of a JAX draw carried by ``convert.params_from_numpy``:
losses agree to atol 1e-4, accuracies to one node per split. Plus the GAT
seeds, ``build_model``'s config errors (and the options it builds since
they were ported), ``fit``'s input_preagg note, the
package's import hygiene after a GAT fit and the CLI on the CPU.
"""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import parallel_gcn_tpu.ops.pallas_bcsr as pb
from parallel_gcn_tpu import train as jtrain
from parallel_gcn_tpu.config import Config as JaxConfig
from parallel_gcn_tpu.data.parser import to_device as jax_to_device
from parallel_gcn_tpu.optim import init_adam as jax_init_adam
from parallel_gcn_tpu_torch import train as ttrain
from parallel_gcn_tpu_torch.cli import main as cli_main
from parallel_gcn_tpu_torch.config import Config
from parallel_gcn_tpu_torch.convert import params_from_numpy
from parallel_gcn_tpu_torch.data.parser import TEST, to_device
from parallel_gcn_tpu_torch.data.synthetic import make_synthetic_dataset
from parallel_gcn_tpu_torch.models.gat import GATModel
from parallel_gcn_tpu_torch.models.sage import GINModel, SAGEModel
from parallel_gcn_tpu_torch.ops import tile_attention
from parallel_gcn_tpu_torch.optim import init_adam

torch.set_num_threads(1)

CPU = torch.device("cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def interpret_mode():
    from jax.experimental.pallas import tpu as pltpu

    old = pb._INTERPRET[0]
    pb._INTERPRET[0] = pltpu.InterpretParams()
    yield
    pb._INTERPRET[0] = old


def _configure(cfg, epochs):
    cfg.gcn.model, cfg.gcn.heads = "gat", 2
    cfg.gcn.hidden_dims, cfg.gcn.dropouts = (8,), (0.0, 0.0)
    cfg.gcn.epochs, cfg.gcn.early_stopping = epochs, 0
    cfg.adam.weight_decay = 5e-4
    cfg.tpu.backend, cfg.tpu.tile_dtype = "hybrid", "int8"
    cfg.tpu.tile_size, cfg.tpu.min_tile_nnz = 128, 520
    cfg.train.verbose, cfg.train.mode = False, "eager"
    return cfg


def _dataset():
    return make_synthetic_dataset(
        "traj", n_nodes=500, n_edges=8000, input_dim=24, n_classes=6,
        n_train=280, n_val=100, feature_nnz_per_row=8, n_communities=6,
    )


def test_epoch_trajectory_matches_jax():
    epochs = 10
    ds = _dataset()
    layout = dict(hybrid=True, tile_dtype="int8", tile_size=128, min_tile_nnz=520)
    jcfg, tcfg = _configure(JaxConfig(), epochs), _configure(Config(), epochs)

    jdds = jax_to_device(ds, **layout)
    jmodel = jtrain.build_model(jcfg, jdds)
    assert jmodel.backend == "tile"
    jw = jtrain.init_model_params(jcfg, jax.random.PRNGKey(3), ds.input_dim, ds.output_dim)
    w_np = jax.tree.map(np.asarray, jw)
    jopt = jax_init_adam(jw)
    jstep = jtrain.make_epoch_step(jmodel, jcfg, jdds)
    key = jax.random.PRNGKey(0)
    jhist = []
    for _ in range(epochs):
        jw, jopt, key, m = jstep(jw, jopt, key)
        jhist.append(np.asarray(m))

    tdds = to_device(ds, device=CPU, **layout)
    assert tdds.graph.is_hybrid
    tmodel = ttrain.build_model(tcfg, tdds, params_from_numpy(w_np))
    assert isinstance(tmodel, GATModel) and tmodel.backend == "tile"
    topt = init_adam(list(tmodel.weights))
    tstep = ttrain.make_epoch_step(tmodel, tcfg, tdds)
    gen = torch.Generator().manual_seed(0)
    thist = [tstep(topt, ttrain.epoch_seeds(gen, 2, attention=True)).numpy()
             for _ in range(epochs)]

    jhist, thist = np.stack(jhist), np.stack(thist)
    np.testing.assert_allclose(thist[:, [0, 2]], jhist[:, [0, 2]], atol=1e-4, rtol=0)
    assert (np.abs(thist[:, 1] - jhist[:, 1]) * ds.train_dim <= 1.01).all()
    assert (np.abs(thist[:, 3] - jhist[:, 3]) * ds.val_dim <= 1.01).all()
    assert thist[-1, 0] < thist[0, 0]

    jtest = jtrain.make_eval_fn(jmodel, jcfg, jdds, TEST)(jw)
    ttest = ttrain.make_eval_fn(tmodel, tcfg, tdds, TEST)()
    assert float(ttest[0]) == pytest.approx(float(jtest[0]), abs=1e-4)
    assert abs(float(ttest[1]) - float(jtest[1])) * ds.test_dim <= 1.01


def test_epoch_seeds_for_gat():
    gen = torch.Generator().manual_seed(9)
    seeds = ttrain.epoch_seeds(gen, 3, attention=True)
    assert len(seeds) == 6
    assert all(0 <= s < 2**31 - 1 for s in seeds[1::2])
    assert ttrain.epoch_seeds(torch.Generator().manual_seed(9), 3) == seeds[0::2]


def test_build_model_config_errors():
    ds = _dataset()
    hybrid = to_device(ds, device=CPU, hybrid=True, tile_dtype="int8", tile_size=128,
                       min_tile_nnz=520)
    coo = to_device(ds, device=CPU)
    cfg = _configure(Config(), 1)
    cfg.tpu.edge_chunk = 1024
    with pytest.raises(ValueError, match="edge_chunk"):
        ttrain.build_model(cfg, hybrid)
    cfg = _configure(Config(), 1)
    cfg.tpu.backend = "dense"  # not coerced to hybrid: the COO is incomplete
    with pytest.raises(ValueError, match="complete COO"):
        ttrain.build_model(cfg, hybrid)
    cfg.tpu.backend = "segment"
    assert ttrain.build_model(cfg, coo).backend == "segment"
    cfg.tpu.edge_chunk = 1024  # ported: the segment GAT streams its attention
    model = ttrain.build_model(cfg, coo)
    assert model.backend == "segment" and model.edge_chunk == 1024
    # remat and the SAGE/GIN families are ported: they build
    cfg = _configure(Config(), 1)
    cfg.gcn.remat = True
    assert ttrain.build_model(cfg, hybrid).remat
    for family, cls in (("sage", SAGEModel), ("gin", GINModel)):
        cfg = _configure(Config(), 1)
        cfg.gcn.model = family
        assert isinstance(ttrain.build_model(cfg, coo), cls)


def test_gat_fit_notes_preagg_and_never_imports_jax():
    code = (
        "import sys, torch\n"
        "from parallel_gcn_tpu_torch.config import Config\n"
        "from parallel_gcn_tpu_torch.data.parser import to_device\n"
        "from parallel_gcn_tpu_torch.data.synthetic import make_synthetic_dataset\n"
        "from parallel_gcn_tpu_torch.train import fit\n"
        "ds = make_synthetic_dataset('fit', n_nodes=400, n_edges=5000, input_dim=16,\n"
        "    n_classes=4, n_train=200, n_val=80, feature_nnz_per_row=6, n_communities=4)\n"
        "cfg = Config()\n"
        "cfg.gcn.model, cfg.gcn.heads, cfg.gcn.hidden_dims = 'gat', 2, (4,)\n"
        "cfg.gcn.dropouts, cfg.gcn.attn_dropout, cfg.gcn.epochs = (0.2, 0.2), 0.3, 2\n"
        "cfg.tpu.input_preagg, cfg.train.mode = True, 'eager'\n"
        "dds = to_device(ds, device=torch.device('cpu'), hybrid=True, tile_size=128,\n"
        "    tile_dtype='int8', min_tile_nnz=300)\n"
        "res = fit(cfg, dds, verbose=True)\n"
        "assert res.epochs_run == 2\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'parallel_gcn_tpu')]\n"
        "print('JAX_MODULES', bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "note: input_preagg has no GAT analog — ignored" in proc.stdout
    assert "epoch=2 " in proc.stdout and "JAX_MODULES []" in proc.stdout


def test_cli_trains_gat_on_cpu(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("PGCN_CACHE_DIR", str(tmp_path))
    launches = dict(tile_attention.launches)
    rc = cli_main(["synth-medium", "model=gat", "heads=2", "hidden_dims=4", "epochs=1",
                   "backend=hybrid", "tile_dtype=int8", "tile_size=128", "device=cpu",
                   "mode=eager"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "epoch=1 " in out and "test_acc=" in out and "epochs_run=1" in out
    assert tile_attention.launches == launches  # the CPU takes the plain versions
