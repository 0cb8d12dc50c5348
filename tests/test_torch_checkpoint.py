"""Checkpoint and resume of parallel_gcn_tpu_torch against the JAX package's.

The npz format round-trips for a GCN and a GAT, and moves between the two
packages both ways: a file JAX ``fit`` saved loads in the port, and JAX's
``load_checkpoint`` reads a port file. Resumed runs at dropout 0 from the
same checkpoint follow the other package's uninterrupted run within 1e-5
(eager and scan, GCN on an int8 tile pack and GAT on the COO triplets,
Pallas in interpret mode). With dropout on, the port's scan chunked at
``checkpoint_every`` (deferred eval on) and a run resumed from the port's own
file are bit-equal to the uninterrupted run. File names are JAX's for the
same configuration; scan with early stopping warns and writes only
``ckpt_final.npz``. A gloo world of 2 resumes in ``fit_parallel`` (held to
JAX's mesh at weight decay 0 and Adam eps 1e-12, ROADMAP F2, and to the
port's single-card ``fit`` at the defaults), and the CLI takes
``resume_from=``.
"""

import os
import warnings

import jax
import numpy as np
import pytest
import torch

import parallel_gcn_tpu.ops.pallas_bcsr as pb
from parallel_gcn_tpu import train as jtrain
from parallel_gcn_tpu.config import Config as JaxConfig
from parallel_gcn_tpu.data.parser import to_device as jax_to_device
from parallel_gcn_tpu.optim import init_adam as jax_init_adam
from parallel_gcn_tpu.parallel.train_parallel import fit_parallel as jax_fit_parallel
from parallel_gcn_tpu.utils.checkpoint import load_checkpoint as jax_load_checkpoint
from parallel_gcn_tpu.utils.checkpoint import save_checkpoint as jax_save_checkpoint
from parallel_gcn_tpu_torch import train as ttrain
from parallel_gcn_tpu_torch.cli import main as cli_main
from parallel_gcn_tpu_torch.config import Config
from parallel_gcn_tpu_torch.convert import params_from_numpy, params_to_numpy
from parallel_gcn_tpu_torch.data.parser import to_device
from parallel_gcn_tpu_torch.data.synthetic import make_synthetic_dataset
from parallel_gcn_tpu_torch.models.gat import LAYER_KEYS
from parallel_gcn_tpu_torch.optim import AdamState
from parallel_gcn_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from test_torch_parallel import mesh_config, mesh_dataset, resume_routes, run_world
from test_torch_parallel_train import (_jax_config, _jax_dataset, _jax_init,
                                       _single_card_fit, _to_port)

torch.set_num_threads(1)

CPU = torch.device("cpu")
TILES = dict(hybrid=True, tile_dtype="int8", tile_size=128, min_tile_nnz=520)
EPOCHS, AT = 8, 4  # the runs' epochs; the checkpoint resumed from


@pytest.fixture(autouse=True)
def interpret_mode():
    from jax.experimental.pallas import tpu as pltpu

    old = pb._INTERPRET[0]
    pb._INTERPRET[0] = pltpu.InterpretParams()
    yield
    pb._INTERPRET[0] = old


def _dataset():
    return make_synthetic_dataset(
        "ckpt", n_nodes=500, n_edges=8000, input_dim=24, n_classes=6,
        n_train=280, n_val=100, feature_nnz_per_row=8, n_communities=6,
    )


def _config(cfg, *, model="gcn", mode="scan", dropouts=(0.0, 0.0), epochs=EPOCHS, k=0,
            ckpt_dir="", every=0):
    """A two-layer run: the GCN on an int8 tile pack (deferred eval in scan
    mode), the GAT (2 heads of 8) on the COO triplets."""
    cfg.gcn.hidden_dims, cfg.gcn.dropouts = (16,), dropouts
    cfg.gcn.epochs, cfg.gcn.early_stopping = epochs, k
    cfg.adam.weight_decay = 5e-4
    cfg.tpu.backend, cfg.tpu.tile_dtype = "hybrid", "int8"
    cfg.tpu.tile_size, cfg.tpu.min_tile_nnz = 128, 520
    cfg.tpu.matmul_precision = "highest"
    cfg.train.verbose, cfg.train.mode = False, mode
    cfg.train.checkpoint_dir, cfg.train.checkpoint_every = ckpt_dir, every
    if model == "gat":
        cfg.gcn.model, cfg.gcn.heads, cfg.gcn.hidden_dims = "gat", 2, (8,)
        cfg.tpu.backend, cfg.tpu.dense_threshold = "segment", 0
        cfg.gcn.attn_dropout = dropouts[-1]
    return cfg


def _layouts(model):
    return TILES if model == "gcn" else {}


def _jax_weights(jcfg, ds):
    """JAX fit's initial weights (its key schedule) as the port's tensors."""
    _, init_key = jax.random.split(jax.random.PRNGKey(jcfg.tpu.seed))
    w = jax.tree.map(np.asarray, jtrain.init_model_params(jcfg, init_key, ds.input_dim,
                                                          ds.output_dim))
    return params_from_numpy(w, CPU)


def _keys(model):
    """The port's per-layer keys of a 2-layer ``model`` (its ``layer_keys``)."""
    return [LAYER_KEYS] * 2 if model == "gat" else [None] * 2


def _port_state(gat, seed=0):
    """Random weights and Adam moments in the port's leaf layout."""
    rng = np.random.default_rng(seed)
    shapes = ([(24, 16), (2, 8), (2, 8), (16, 12), (2, 6), (2, 6)] if gat
              else [(24, 16), (16, 6)])
    leaves = [[torch.from_numpy(rng.standard_normal(s).astype(np.float32)) for s in shapes]
              for _ in range(3)]
    return leaves[0], AdamState(step=torch.tensor(7, dtype=torch.int32), m=leaves[1],
                                v=leaves[2])


@pytest.mark.parametrize("model", ["gcn", "gat"])
def test_format_round_trips(tmp_path, model):
    gat = model == "gat"
    w, opt = _port_state(gat)
    path = str(tmp_path / "ck.npz")
    save_checkpoint(path, w, opt, 11, keys=_keys(model), seed=1234)
    ck = load_checkpoint(path)
    assert (ck.epoch, ck.step, ck.seed) == (11, 7, 1234)
    for got, want in zip((ck.weights, ck.m, ck.v), (w, opt.m, opt.v)):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b.numpy())
    with np.load(path) as data:
        assert int(data["n_weights"]) == 2  # layers, as JAX counts them
        assert "key" not in data
        if gat:
            assert [str(k) for k in data["w1__keys"]] == ["W", "a_dst", "a_src"]


@pytest.mark.parametrize("model", ["gcn", "gat"])
def test_files_move_between_the_packages(tmp_path, model):
    gat = model == "gat"
    w, opt = _port_state(gat)
    port_file = str(tmp_path / "port.npz")
    save_checkpoint(port_file, w, opt, 5, keys=_keys(model), seed=3)
    jw, jopt, epoch, key = jax_load_checkpoint(port_file)
    assert epoch == 5 and int(jopt.step) == 7 and key is None
    layers = params_to_numpy(w, _keys(model))
    for got, want in zip(jw, layers):
        if gat:
            assert set(got) == {"W", "a_src", "a_dst"}
            for k in want:
                np.testing.assert_array_equal(np.asarray(got[k]), want[k])
        else:
            np.testing.assert_array_equal(np.asarray(got), want)

    jax_file = str(tmp_path / "jax.npz")
    jax_save_checkpoint(jax_file, jw, jopt, 9, jax.random.PRNGKey(4))
    ck = load_checkpoint(jax_file)
    assert (ck.epoch, ck.step, ck.seed) == (9, 7, None)
    for a, b in zip(ck.weights + ck.m + ck.v, [*w, *opt.m, *opt.v]):
        np.testing.assert_array_equal(a, b.numpy())


@pytest.mark.parametrize("model,mode", [("gcn", "eager"), ("gcn", "scan"), ("gat", "eager"),
                                        ("gat", "scan")])
def test_port_resumes_a_jax_checkpoint(tmp_path, model, mode):
    """JAX ``fit`` writes ckpt_000004.npz on its way to 8 epochs; the port
    resumed from that file repeats JAX's epochs 5-8 within 1e-5."""
    ds = _dataset()
    ck = str(tmp_path / "ck")
    jcfg = _config(JaxConfig(), model=model, mode=mode, ckpt_dir=ck, every=AT)
    jres = jtrain.fit(jcfg, jax_to_device(ds, **_layouts(model)))
    assert os.path.isfile(os.path.join(ck, f"ckpt_{AT:06d}.npz"))
    tres = ttrain.fit(_config(Config(), model=model, mode=mode),
                      to_device(ds, device=CPU, **_layouts(model)),
                      resume_from=os.path.join(ck, f"ckpt_{AT:06d}.npz"))
    assert tres.epochs_run == EPOCHS - AT and tres.start_epoch == AT
    np.testing.assert_allclose(tres.history, np.asarray(jres.history)[AT:], rtol=0, atol=1e-5)
    assert tres.test_acc == pytest.approx(float(jres.test_acc), abs=1e-6)


@pytest.mark.parametrize("model", ["gcn", "gat"])
def test_jax_resumes_a_port_checkpoint(tmp_path, model):
    """The port (from JAX's initial weights) writes ckpt_000004.npz; JAX's
    ``fit`` resumed from it repeats the port's epochs 5-8 within 1e-5."""
    ds = _dataset()
    ck = str(tmp_path / "ck")
    jcfg = _config(JaxConfig(), model=model)
    tres = ttrain.fit(_config(Config(), model=model, ckpt_dir=ck, every=AT),
                      to_device(ds, device=CPU, **_layouts(model)),
                      weights=_jax_weights(jcfg, ds))
    jres = jtrain.fit(jcfg, jax_to_device(ds, **_layouts(model)),
                      resume_from=os.path.join(ck, f"ckpt_{AT:06d}.npz"))
    assert jres.epochs_run == EPOCHS - AT
    np.testing.assert_allclose(np.asarray(jres.history), tres.history[AT:], rtol=0, atol=1e-5)
    assert float(jres.test_acc) == pytest.approx(tres.test_acc, abs=1e-6)


def _assert_same_run(got, want, rows=slice(None)):
    np.testing.assert_array_equal(got.history, want.history[rows])
    for a, b in zip(got.weights, want.weights):
        assert torch.equal(a, b)
    assert (got.test_loss, got.test_acc) == (want.test_loss, want.test_acc)


@pytest.mark.parametrize("model", ["gcn", "gat"])
def test_chunked_scan_is_bit_equal(tmp_path, model):
    """With dropout on, a scan paused every 3 epochs to write a checkpoint
    (the GCN's deferred-eval schedule included) is the unchunked run."""
    dds = to_device(_dataset(), device=CPU, **_layouts(model))
    kw = dict(model=model, dropouts=(0.3, 0.3))
    cfg = _config(Config(), **kw)
    assert ttrain.scan_schedule(ttrain.build_model(cfg, dds), cfg)[1] == (model == "gcn")
    plain = ttrain.fit(cfg, dds)
    chunked = ttrain.fit(_config(Config(), ckpt_dir=str(tmp_path / "ck"), every=3, **kw), dds)
    _assert_same_run(chunked, plain)
    assert len(chunked.checkpoint_s) == 3  # epochs 3 and 6, and the final one


@pytest.mark.parametrize("model,mode", [("gcn", "scan"), ("gcn", "eager"), ("gat", "scan")])
def test_resume_of_a_port_file_is_bit_equal(tmp_path, model, mode):
    """With dropout on, the run resumed from ckpt_000004.npz draws epochs
    5-8's seeds and ends where the uninterrupted run ends, bit for bit."""
    dds = to_device(_dataset(), device=CPU, **_layouts(model))
    kw = dict(model=model, mode=mode, dropouts=(0.3, 0.3))
    ck = str(tmp_path / "ck")
    whole = ttrain.fit(_config(Config(), ckpt_dir=ck, every=AT, **kw), dds)
    resumed = ttrain.fit(_config(Config(), **kw), dds,
                         resume_from=os.path.join(ck, f"ckpt_{AT:06d}.npz"))
    _assert_same_run(resumed, whole, slice(AT, None))
    final = load_checkpoint(os.path.join(ck, "ckpt_final.npz"))
    assert final.epoch == EPOCHS and final.step == EPOCHS
    for a, b in zip(final.weights, whole.weights):
        np.testing.assert_array_equal(a, b.numpy())


@pytest.mark.parametrize("mode,start", [("scan", 0), ("eager", 0), ("scan", 3),
                                        ("eager", 3)])
def test_file_names_are_jax_names(tmp_path, mode, start):
    """12 epochs at checkpoint_every=5, fresh and resumed from epoch 3: scan
    counts its chunks from the start, eager writes at multiples of 5."""
    ds = _dataset()
    resume = None
    if start:
        resume = str(tmp_path / "start.npz")
        save_checkpoint(resume, [torch.zeros(24, 16), torch.zeros(16, 6)],
                        AdamState(step=torch.tensor(start, dtype=torch.int32),
                                  m=[torch.zeros(24, 16), torch.zeros(16, 6)],
                                  v=[torch.zeros(24, 16), torch.zeros(16, 6)]),
                        start, keys=_keys("gcn"))
    names = {}
    for pkg, cfg_cls, fit, to_dev in (
            ("jax", JaxConfig, jtrain.fit, lambda: jax_to_device(ds, **TILES)),
            ("port", Config, ttrain.fit, lambda: to_device(ds, device=CPU, **TILES))):
        ck = str(tmp_path / pkg)
        fit(_config(cfg_cls(), mode=mode, epochs=12, ckpt_dir=ck, every=5), to_dev(),
            resume_from=resume)
        names[pkg] = sorted(os.listdir(ck))
    assert names["port"] == names["jax"], names
    assert "ckpt_final.npz" in names["port"] and len(names["port"]) >= 2


def test_scan_with_early_stopping_writes_only_the_final_file(tmp_path):
    dds = to_device(_dataset(), device=CPU, **TILES)
    ck = str(tmp_path / "ck")
    with pytest.warns(UserWarning, match="periodic checkpoints require early_stopping=0"):
        res = ttrain.fit(_config(Config(), epochs=12, k=3, ckpt_dir=ck, every=2), dds)
    assert os.listdir(ck) == ["ckpt_final.npz"]
    assert load_checkpoint(os.path.join(ck, "ckpt_final.npz")).epoch == res.epochs_run


def test_fit_parallel_world_2_resumes(tmp_path):
    """A gloo world of 2 writes ckpt_000004.npz (rank 0) and resumes from it:
    the resumed epochs are the world's uninterrupted ones bit for bit, JAX's
    mesh run within 1e-4 at weight decay 0 and Adam eps 1e-12 (F2: the JAX
    mesh gradient carries a factor n_dev, which Adam sees through eps), and
    the port's single-card ``fit`` within 1e-4 at the defaults."""
    pb._INTERPRET[0] = True  # the mesh's Pallas kernels as tests/test_parallel.py runs them
    ds = mesh_dataset()
    jds = _jax_dataset(ds)
    runs, refs = {}, {}
    for route in ("gcn-hybrid-boundary", "gat-tiles-boundary"):
        jcfg = _jax_config(mesh_config(route, epochs=EPOCHS, weight_decay=0.0, eps=1e-12,
                                       mode="scan"))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            refs[route] = jax_fit_parallel(jcfg, jds, n_devices=2)
        w = _to_port(_jax_init(jcfg, ds))
        runs[route] = (route, dict(weight_decay=0.0, eps=1e-12), w)
        runs[f"{route} decayed"] = (route, {}, w)
        refs[f"{route} decayed"] = _single_card_fit(route, w, epochs=EPOCHS, mode="scan")
    results = run_world(resume_routes, 2, tmp_path, runs, EPOCHS, AT, str(tmp_path / "ck"))
    for name, ref in refs.items():
        for rank, got in enumerate(results):
            whole, resumed, files = got[name]
            assert files == ["ckpt_000004.npz", "ckpt_final.npz"], files
            np.testing.assert_array_equal(resumed, whole[AT:])
            np.testing.assert_allclose(resumed, np.asarray(ref.history)[AT:], rtol=0,
                                       atol=1e-4, err_msg=f"{name} rank {rank}")


def test_cli_resume_from(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("PGCN_CACHE_DIR", str(tmp_path))
    ck = str(tmp_path / "ck")
    args = ["synth-medium", "device=cpu", "epochs=4", "hidden_dims=8", "mode=scan"]
    assert cli_main([*args, f"checkpoint_dir={ck}", "checkpoint_every=2"]) == 0
    whole = capsys.readouterr().out
    assert sorted(os.listdir(ck)) == ["ckpt_000002.npz", "ckpt_final.npz"]
    path = os.path.join(ck, "ckpt_000002.npz")
    assert cli_main([*args, f"resume_from={path}"]) == 0
    out = capsys.readouterr().out
    assert f"resumed from {path} at epoch 2" in out
    assert "epoch=3 " in out and "epoch=4 " in out and "epoch=2 " not in out
    assert "epochs_run=2" in out
    tail = [line for line in whole.splitlines() if line.startswith(("epoch=3 ", "epoch=4 "))]
    assert tail == [line for line in out.splitlines()
                    if line.startswith(("epoch=3 ", "epoch=4 "))]
    assert cli_main([*args, f"resume_from={tmp_path / 'missing.npz'}"]) == 2
    assert "no checkpoint at" in capsys.readouterr().out
