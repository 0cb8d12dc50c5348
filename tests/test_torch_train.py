"""parallel_gcn_tpu_torch trainer and CLI.

A 20-epoch dropouts-0 trajectory of the port's epoch step against the JAX
package's ``make_epoch_step`` on a small hybrid int8 graph (128 tiles), from
identical weights: losses agree to atol 1e-4, accuracies to one node per
split. Plus the package's import hygiene and the CLI's exit codes.
"""

import os
import re
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
    cfg.gcn.hidden_dims, cfg.gcn.dropouts = (16,), (0.0, 0.0)
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
    epochs = 20
    ds = _dataset()
    layout = dict(hybrid=True, tile_dtype="int8", tile_size=128, min_tile_nnz=520)
    jcfg, tcfg = _configure(JaxConfig(), epochs), _configure(Config(), epochs)

    jdds = jax_to_device(ds, **layout)
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

    tdds = to_device(ds, device=CPU, **layout)
    assert tdds.graph.is_hybrid
    tmodel = ttrain.build_model(tcfg, tdds, params_from_numpy(w_np, CPU))
    tdds = ttrain.preaggregate_input(tmodel, tdds)
    assert tmodel.input_preagg
    topt = init_adam(list(tmodel.weights))
    tstep = ttrain.make_epoch_step(tmodel, tcfg, tdds)
    gen = torch.Generator().manual_seed(0)
    thist = [tstep(topt, ttrain.epoch_seeds(gen, 2)).numpy() for _ in range(epochs)]

    jhist, thist = np.stack(jhist), np.stack(thist)
    np.testing.assert_allclose(thist[:, [0, 2]], jhist[:, [0, 2]], atol=1e-4, rtol=0)
    n_train, n_val = ds.train_dim, ds.val_dim
    assert (np.abs(thist[:, 1] - jhist[:, 1]) * n_train <= 1.01).all()
    assert (np.abs(thist[:, 3] - jhist[:, 3]) * n_val <= 1.01).all()
    assert thist[-1, 0] < thist[0, 0]

    jtest = jtrain.make_eval_fn(jmodel, jcfg, jdds, TEST)(jw)
    ttest = ttrain.make_eval_fn(tmodel, tcfg, tdds, TEST)()
    assert float(ttest[0]) == pytest.approx(float(jtest[0]), abs=1e-4)
    assert abs(float(ttest[1]) - float(jtest[1])) * ds.test_dim <= 1.01


def test_fit_runs_and_reports(capsys, tmp_path):
    cfg = _configure(Config(), 4)
    cfg.gcn.dropouts = (0.2, 0.3)
    cfg.train.verbose, cfg.train.mode = True, "scan"
    dds = to_device(_dataset(), device=CPU, hybrid=True, tile_dtype="int8",
                    tile_size=128, min_tile_nnz=520)
    res = ttrain.fit(cfg, dds)
    out = capsys.readouterr().out
    # mode=scan is the whole-run path now, with the eager loop's trajectory
    assert "not yet ported" not in out
    assert "epoch=4 " in out and "test_acc=" in out
    assert res.epochs_run == 4 and res.history.shape == (4, 4)
    assert np.isfinite(res.history).all()
    cfg.train.verbose, cfg.train.mode = False, "eager"
    eager = ttrain.fit(cfg, dds)
    np.testing.assert_allclose(res.history, eager.history, rtol=0, atol=1e-5)
    assert res.test_acc == pytest.approx(eager.test_acc, abs=1e-7)
    cfg.train.checkpoint_dir = str(tmp_path / "ck")
    ttrain.fit(cfg, dds)
    assert os.listdir(tmp_path / "ck") == ["ckpt_final.npz"]


def test_early_stopping_mean_of_last_k():
    cfg = _configure(Config(), 200)
    cfg.gcn.early_stopping = 3
    cfg.tpu.backend = "segment"
    cfg.adam.learning_rate = 0.5  # oscillates: val loss soon exceeds its mean
    dds = to_device(_dataset(), device=CPU)
    res = ttrain.fit(cfg, dds)
    assert 3 <= res.epochs_run < 200
    vl = res.history[:, 2]
    assert vl[-1] > vl[-3:].mean()
    assert all(vl[e] <= vl[e - 2:e + 1].mean() for e in range(2, res.epochs_run - 1))


PORT_MODULES = ["parallel_gcn_tpu_torch", "parallel_gcn_tpu_torch.train",
                "parallel_gcn_tpu_torch.cli", "parallel_gcn_tpu_torch.seeds",
                "parallel_gcn_tpu_torch.golden", "parallel_gcn_tpu_torch.utils.timer",
                "parallel_gcn_tpu_torch.utils.profiling", "parallel_gcn_tpu_torch.data.native",
                *(f"parallel_gcn_tpu_torch.harness.{m}" for m in (
                    "common", "accuracy", "tuning", "seed_select", "performance",
                    "performance_golden", "profile", "tuning_layout", "scaling",
                    "mesh_onechip", "scale_demo", "pack_census", "residual_stats",
                    "feature_impl_bench", "plots", "evidence_check"))]


def test_package_never_imports_jax():
    code = (f"import sys, {', '.join(PORT_MODULES)}; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
            "or m == 'parallel_gcn_tpu' or m.startswith('parallel_gcn_tpu.')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_no_port_source_imports_jax():
    # the scripts that run on the card import lazily, inside functions
    bad = re.compile(r"^\s*(import jax\b|from jax\b|import parallel_gcn_tpu\b(?!_torch)|"
                     r"from parallel_gcn_tpu\b(?!_torch))")
    paths = [os.path.join(REPO, f) for f in ("chip_smoke.py", "mesh_halos.py", "mesh_tp.py",
                                             "kernel_variants.py")]
    for root, _, files in os.walk(os.path.join(REPO, "parallel_gcn_tpu_torch")):
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    found = []
    for path in paths:
        with open(path) as f:
            found += [f"{path}:{i}: {ln.strip()}" for i, ln in enumerate(f, 1) if bad.match(ln)]
    assert len(paths) > 50 and not found, found


def _run_cli(args, tmp_path):
    env = dict(os.environ, PGCN_CACHE_DIR=str(tmp_path), CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "-m", "parallel_gcn_tpu_torch", *args],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=300)


def test_cli_without_cuda_fails_before_loading_data(tmp_path):
    proc = _run_cli(["synth-medium", "epochs=2"], tmp_path)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stdout
    assert "PARSING" not in proc.stdout
    assert not list(tmp_path.iterdir())  # nothing generated


def test_cli_on_cpu_when_asked(tmp_path):
    proc = _run_cli(["synth-medium", "device=cpu", "epochs=2", "hidden_dims=8",
                     "mode=eager"], tmp_path)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "device cpu" in proc.stdout and "epoch=2 " in proc.stdout
    assert "epochs_run=2" in proc.stdout


def test_cli_bad_arguments_return_2(capsys):
    assert cli_main(["no-such-dataset"]) == 2
    assert "no parameters file" in capsys.readouterr().out
    assert cli_main(["synth-medium", "bogus"]) == 2
    assert cli_main(["synth-medium", "epocs=3"]) == 2
    assert cli_main(["synth-medium", "device=tpu"]) == 2
    assert cli_main([]) == 2
