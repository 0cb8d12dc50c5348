"""fit_parallel of parallel_gcn_tpu_torch against the JAX package's.

A 5-epoch run at world 2 (a gloo world of 2 CPU processes, spawned as in
``tests/test_torch_parallel.py``, whose ranks import no JAX), dropouts 0,
from the JAX package's initial weights carried across by ``convert.py``,
against JAX ``fit_parallel(mode=eager)`` on 2 devices of the virtual CPU
mesh (Pallas in interpret mode) at weight decay 0, and against the port's
single-card ``fit`` with the default decay, for three routes: the GCN over
flat COO slabs with the all_gather halo, the GCN over int8 tile slabs with
the boundary halo, and the GAT over ``gat_mesh_pack`` slabs with the
boundary halo. The histories agree within 1e-4 and test_acc is equal. The
same for ``mode=scan`` against JAX's whole-run program (deferred eval on
the GCN routes, and the early-stopping loop where it fires). Plus a world
of one against the port's own single-card ``fit``, with dropout on.

Weight decay 0 because of ROADMAP F2 and F5: the JAX mesh's gradient is
n_dev·tp times the loss's (n_dev here, at tp 1), so its decay acts as
wd/(n_dev·tp). ``tests/test_torch_tp.py`` holds the tensor-parallel runs.
"""

import warnings

import jax
import numpy as np
import pytest
import torch

import parallel_gcn_tpu.ops.pallas_bcsr as pb
from parallel_gcn_tpu.config import Config as JaxConfig
from parallel_gcn_tpu.data.graph import HostCSR as JaxHostCSR
from parallel_gcn_tpu.data.parser import Dataset as JaxDataset
from parallel_gcn_tpu.parallel.train_parallel import fit_parallel as jax_fit_parallel
from parallel_gcn_tpu.train import init_model_params
from parallel_gcn_tpu_torch.convert import params_from_numpy
from parallel_gcn_tpu_torch.data.parser import to_device
from parallel_gcn_tpu_torch.parallel.train_parallel import fit_parallel
from parallel_gcn_tpu_torch.train import fit
from test_torch_parallel import fit_routes, mesh_config, mesh_dataset, run_world

torch.set_num_threads(1)

ROUTES = ["gcn-flat-all_gather", "gcn-hybrid-boundary", "gat-tiles-boundary"]
EPOCHS = 5  # fit_routes (tests/test_torch_parallel.py) runs the same routes


@pytest.fixture(autouse=True)
def interpret_mode():
    # as tests/test_parallel.py runs the mesh's Pallas kernels on the CPU
    old = pb._INTERPRET[0]
    pb._INTERPRET[0] = True
    yield
    pb._INTERPRET[0] = old


def _jax_config(cfg):
    """The JAX package's Config with the port config's values."""
    jcfg = JaxConfig()
    for section in ("gcn", "adam", "tpu", "train"):
        for key, val in vars(getattr(cfg, section)).items():
            setattr(getattr(jcfg, section), key, val)
    return jcfg


def _jax_dataset(ds):
    g = ds.graph
    return JaxDataset(
        name=ds.name, feature_csr=None, features=ds.features, labels=ds.labels,
        split=ds.split, n_nodes=ds.n_nodes, input_dim=ds.input_dim,
        output_dim=ds.output_dim,
        graph=JaxHostCSR(indptr=g.indptr, indices=g.indices, values=g.values,
                         n_rows=g.n_rows, n_cols=g.n_cols, sym_scale=g.sym_scale))


def _jax_init(jcfg, ds):
    """The initial weights JAX fit_parallel draws (its key schedule)."""
    _, init_key = jax.random.split(jax.random.PRNGKey(jcfg.tpu.seed))
    return init_model_params(jcfg, init_key, ds.input_dim, ds.output_dim)


def _to_port(weights):
    return [w.numpy() for w in params_from_numpy(jax.tree.map(np.asarray, weights))]


def _single_card_fit(route, weights, **kw):
    """The port's single-card ``fit`` of ``route``'s configuration (with its
    default weight decay, ``mesh_config`` keywords ``kw``) from ``weights``."""
    ds = mesh_dataset()
    cfg = mesh_config(route, **{"epochs": EPOCHS, **kw})
    dds = to_device(ds, device=torch.device("cpu"), hybrid=cfg.tpu.backend == "hybrid",
                    tile_dtype="int8", tile_size=128, min_tile_nnz=40)
    return fit(cfg, dds, weights=[torch.from_numpy(a.copy()) for a in weights])


def test_fit_parallel_world_2_matches_jax(tmp_path):
    """At weight decay 0 against JAX on 2 devices. The JAX mesh step
    differentiates a loss it has already summed over the devices and then
    sums the gradients again, so its gradient is n_dev·tp times the loss's
    (F2, F5; tp is 1 here): Adam's update does not see the scale, but its
    weight decay then acts as wd/(n_dev·tp). So with the default decay the port's world-2 runs are held to
    the port's single-card ``fit`` (itself held to JAX's single-chip
    trainer by tests/test_torch_train.py and test_torch_gat_train.py)."""
    ds = mesh_dataset()
    jds = _jax_dataset(ds)
    refs, runs = {}, {}
    for route in ROUTES:
        jcfg = _jax_config(mesh_config(route, epochs=EPOCHS, weight_decay=0.0))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            refs[route] = jax_fit_parallel(jcfg, jds, n_devices=2)
        w = _to_port(_jax_init(jcfg, ds))
        runs[route] = (route, 0.0, w)
        runs[f"{route} decayed"] = (route, None, w)
        refs[f"{route} decayed"] = _single_card_fit(route, w)
    results = run_world(fit_routes, 2, tmp_path, runs, EPOCHS)
    for name, ref in refs.items():
        for rank, got in enumerate(results):
            hist, test_acc = got[name]
            np.testing.assert_allclose(hist, np.asarray(ref.history), rtol=0, atol=1e-4,
                                       err_msg=f"{name} rank {rank}")
            assert test_acc == pytest.approx(ref.test_acc, abs=1e-7), name
        assert hist[-1, 0] < hist[0, 0], name


# name -> (route, mesh_config keywords): the whole-run path's schedules on
# the mesh (deferred eval for the GCN routes, the plain scan for the GAT, the
# early-stopping loop where it fires). The early-stopping run takes Adam's
# eps at 1e-12: F2's factor n_dev reaches Adam's update through eps,
# m/(sqrt(v) + eps), and at learning rate 0.1 JAX's own 1- and 2-device
# histories then part by 4e-3 within 14 epochs at weight decay 0 (1e-7 at
# eps 1e-12).
SCAN_RUNS = {
    "gcn-flat-all_gather scan": ("gcn-flat-all_gather", dict(mode="scan")),
    "gcn-hybrid-boundary scan": ("gcn-hybrid-boundary", dict(mode="scan")),
    "gat-tiles-boundary scan": ("gat-tiles-boundary", dict(mode="scan")),
    "gcn-hybrid-boundary early stopping": (
        "gcn-hybrid-boundary",
        dict(mode="scan", epochs=30, early_stopping=3, learning_rate=0.1, eps=1e-12)),
}


def test_fit_parallel_scan_world_2_matches_jax_scan(tmp_path):
    """``mode=scan`` at world 2 against JAX's whole-run program on 2 devices
    at weight decay 0 (F2, as above), and against the port's single-card
    scan at the default decay, for k = 0 and k > 0."""
    ds = mesh_dataset()
    jds = _jax_dataset(ds)
    refs, runs = {}, {}
    for name, (route, opts) in SCAN_RUNS.items():
        kw = {"epochs": EPOCHS, **opts}
        jcfg = _jax_config(mesh_config(route, weight_decay=0.0, **kw))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            refs[name] = jax_fit_parallel(jcfg, jds, n_devices=2)
        w = _to_port(_jax_init(jcfg, ds))
        runs[name] = (route, 0.0, w, opts)
        runs[f"{name} decayed"] = (route, None, w, opts)
        refs[f"{name} decayed"] = _single_card_fit(route, w, **kw)
    results = run_world(fit_routes, 2, tmp_path, runs, EPOCHS)
    for name, ref in refs.items():
        for rank, got in enumerate(results):
            hist, test_acc = got[name]
            assert hist.shape == np.asarray(ref.history).shape, f"{name} rank {rank}"
            np.testing.assert_allclose(hist, np.asarray(ref.history), rtol=0, atol=1e-4,
                                       err_msg=f"{name} rank {rank}")
            assert test_acc == pytest.approx(ref.test_acc, abs=1e-7), name
    early = refs["gcn-hybrid-boundary early stopping"]
    assert len(early.history) < 30


@pytest.mark.parametrize("route", ["gcn-hybrid-boundary", "gat-tiles-boundary"])
def test_world_of_one_matches_single_card_fit(route):
    """A world of one replays the single-card run, dropout masks included
    (rank 0 keeps the epoch's seeds)."""
    ds = mesh_dataset()
    cfg = mesh_config(route, epochs=4, dropouts=(0.3, 0.3))
    cfg.gcn.attn_dropout = 0.3 if cfg.gcn.model == "gat" else 0.0
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        mesh = fit_parallel(cfg, ds, n_devices=1, device="cpu")
    dds = to_device(ds, device=torch.device("cpu"), hybrid=True, tile_dtype="int8",
                    tile_size=128, min_tile_nnz=40)
    single = fit(cfg, dds)
    np.testing.assert_allclose(mesh.history, single.history, rtol=0, atol=2e-5)
    assert mesh.test_acc == pytest.approx(single.test_acc, abs=1e-6)
