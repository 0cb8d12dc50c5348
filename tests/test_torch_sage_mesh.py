"""Mesh SAGE and GIN (``fit_parallel``) of parallel_gcn_tpu_torch against the
JAX package's.

A gloo world of 2 CPU processes (spawned as in
``tests/test_torch_parallel.py``; its ranks import no JAX) trains each route
for 5 epochs at dropout 0 and weight decay 0, from the JAX package's initial
weights carried across by ``convert.params_from_numpy``, against JAX
``fit_parallel`` on 2 devices of the virtual CPU mesh (Pallas in interpret
mode). Weight decay 0 because of F2: the JAX mesh's gradient is n_dev times
the loss's, so its decay acts as wd/n_dev. Routes: SAGE and GIN over flat
COO slabs and over hybrid int8 slabs, with the all_gather and the boundary
halo, in ``mode=eager`` and ``mode=scan``. Histories within 1e-4 and
test_acc within 1e-7, the tolerance of ``tests/test_torch_parallel_train.py``.
Plus a world of one against the single-card ``fit`` with dropout on, and
the CLI under ``torchrun`` in a world of 2 with ``model=gin gin_eps=``.
"""

import os
import subprocess
import sys
import warnings

import jax
import numpy as np
import pytest
import torch

import parallel_gcn_tpu.ops.pallas_bcsr as pb
from parallel_gcn_tpu.parallel.train_parallel import fit_parallel as jax_fit_parallel
from parallel_gcn_tpu_torch.convert import params_from_numpy
from parallel_gcn_tpu_torch.data.parser import to_device
from parallel_gcn_tpu_torch.parallel.train_parallel import fit_parallel
from parallel_gcn_tpu_torch.train import fit
from test_torch_parallel import fit_routes, mesh_config, mesh_dataset, run_world
from test_torch_parallel_train import _jax_config, _jax_dataset, _jax_init

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EPOCHS = 5
# name -> (route, mesh_config keywords)
RUNS = {
    "sage-flat-all_gather": ("sage-flat-all_gather", dict(mode="eager")),
    "sage-hybrid-boundary": ("sage-hybrid-boundary", dict(mode="eager")),
    "gin-flat-boundary": ("gin-flat-boundary", dict(mode="eager")),
    "gin-hybrid-all_gather": ("gin-hybrid-all_gather", dict(mode="eager")),
    "sage-hybrid-boundary scan": ("sage-hybrid-boundary", dict(mode="scan")),
    "gin-flat-all_gather scan": ("gin-flat-all_gather", dict(mode="scan")),
}


@pytest.fixture(autouse=True)
def interpret_mode():
    # as tests/test_parallel.py runs the mesh's Pallas kernels on the CPU
    old = pb._INTERPRET[0]
    pb._INTERPRET[0] = True
    yield
    pb._INTERPRET[0] = old


def test_fit_parallel_world_2_matches_jax(tmp_path):
    ds = mesh_dataset()
    jds = _jax_dataset(ds)
    refs, runs = {}, {}
    for name, (route, opts) in RUNS.items():
        jcfg = _jax_config(mesh_config(route, epochs=EPOCHS, weight_decay=0.0, **opts))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            refs[name] = jax_fit_parallel(jcfg, jds, n_devices=2)
        w = [t.numpy() for t in params_from_numpy(jax.tree.map(np.asarray,
                                                                _jax_init(jcfg, ds)))]
        runs[name] = (route, 0.0, w, opts)
    results = run_world(fit_routes, 2, tmp_path, runs, EPOCHS)
    for name, ref in refs.items():
        for rank, got in enumerate(results):
            hist, test_acc = got[name]
            assert hist.shape == np.asarray(ref.history).shape, f"{name} rank {rank}"
            np.testing.assert_allclose(hist, np.asarray(ref.history), rtol=0, atol=1e-4,
                                       err_msg=f"{name} rank {rank}")
            assert test_acc == pytest.approx(ref.test_acc, abs=1e-7), name
        assert hist[-1, 0] < hist[0, 0], name


@pytest.mark.parametrize("route", ["sage-hybrid-boundary", "gin-flat-all_gather"])
def test_world_of_one_matches_single_card_fit(route):
    """A world of one replays the single-card run, dropout masks included,
    through the rank's sqrt(deg) slice."""
    ds = mesh_dataset()
    cfg = mesh_config(route, epochs=4, dropouts=(0.3, 0.3), mode="scan")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        mesh = fit_parallel(cfg, ds, n_devices=1, device="cpu")
    dds = to_device(ds, device=torch.device("cpu"), hybrid=cfg.tpu.backend == "hybrid",
                    tile_dtype="int8", tile_size=128, min_tile_nnz=40)
    single = fit(cfg, dds)
    np.testing.assert_allclose(mesh.history, single.history, rtol=0, atol=2e-5)
    assert mesh.test_acc == pytest.approx(single.test_acc, abs=1e-6)


def test_cli_trains_gin_in_a_torchrun_world_on_cpu(tmp_path):
    env = dict(os.environ, PGCN_CACHE_DIR=str(tmp_path), CUDA_VISIBLE_DEVICES="",
               OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node=2",
         "-m", "parallel_gcn_tpu_torch", "synth-medium", "device=cpu", "n_devices=2",
         "model=gin", "gin_eps=0.1", "remat=true", "epochs=2", "hidden_dims=8", "mode=eager",
         "halo=boundary", "halo_fallback=false"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "mesh: 2 rank(s), halo=boundary" in proc.stdout
    assert "epoch=2 " in proc.stdout and "epochs_run=2" in proc.stdout
    assert proc.stdout.count("epochs_run=") == 1  # only rank 0 prints
