"""parallel_gcn_tpu_torch.parallel: node-partitioned aggregation and epoch
steps in gloo worlds of 2 and 4 CPU processes.

Each world is started by ``torch.multiprocessing`` with a ``FileStore``
under ``tmp_path``; every rank runs a group of checks and reports that
``jax`` never entered its ``sys.modules`` (this module imports no JAX, so a
rank imports only torch, numpy and the port). Checks:
- ``graphsum_dist`` (flat COO, all_gather and boundary halo),
  ``graphsum_dist_hybrid`` (f32 slabs, both halos) and
  ``graphsum_dist_hybrid_scaled`` (int8 pattern slabs) forward and
  backward on each rank's rows against the single-card Â·x and Âᵀ·c
  (rtol 1e-5, atol 1e-5);
- the collectives of one epoch step, pinned to the structure of
  ``tests/test_parallel.py``'s ``test_epoch_step_collective_structure``:
  the all_gather halo 4 gathers and 2 reduce-scatters, the boundary halo
  6 all_to_alls, for the GCN and the GAT tile path, the ring 6 rotations
  (``tests/test_torch_halo.py`` checks the ring and adaptive halos'
  numbers); plus 2 all_reduces
  (gradients with the train sums, the val sums);
- the collectives of the mesh GCN's deferred-eval epoch (``mode=scan``):
  one exchange for the stacked last layer, one all_reduce;
- per-rank dropout seeds, the config and CLI error paths, and the CLI in a
  torchrun world of 2.
"""

import importlib
import os
import pickle
import subprocess
import sys
import time
import traceback
import warnings

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from parallel_gcn_tpu_torch.cli import main as cli_main
from parallel_gcn_tpu_torch.config import Config
from parallel_gcn_tpu_torch.data.graph import random_graph
from parallel_gcn_tpu_torch.data.parser import Dataset
from parallel_gcn_tpu_torch.optim import init_adam
from parallel_gcn_tpu_torch.parallel import collectives
from parallel_gcn_tpu_torch.parallel import partition as tp
from parallel_gcn_tpu_torch.parallel import train_parallel as tpl

torch.set_num_threads(1)
CPU = torch.device("cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---------------------------------------------------------------------------
# worlds of CPU processes
# ---------------------------------------------------------------------------


def _entry(rank, world, store, module, fn_name, args, out_dir):
    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                                world_size=world)
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", UserWarning)
                fn = getattr(importlib.import_module(module), fn_name)
                result = fn(rank, world, *args)
            # no rank tears its connections down before every rank has made
            # them: a rank whose checks run no collective (``_seeded_masks``)
            # would otherwise close its end while a slower rank is still in
            # gloo's connectFullMesh, which then fails with "Connection
            # closed by peer"
            dist.barrier()
        finally:
            dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump({"result": result, "jax_loaded": "jax" in sys.modules}, f)


def _rank_errors(tmp_path, world: int) -> str:
    """Each rank's own traceback, where it wrote one."""
    errs = []
    for r in range(world):
        path = tmp_path / f"rank{r}.err"
        errs.append(f"--- rank {r}:\n" + (path.read_text() if path.exists() else
                                         "(no error written: it ran on, or was stopped)\n"))
    return "".join(errs)


def run_world(fn, world: int, tmp_path, *args, timeout_s: float = 240.0) -> list:
    """``fn(rank, world, *args)`` on every rank of a gloo world of ``world``
    processes; returns the ranks' results. ``fn`` must live at the top of a
    test module that imports no JAX (a rank imports that module). A rank
    that fails writes its traceback, which the test's failure shows for
    every rank; a world still running after ``timeout_s`` (a hung
    collective) is killed and the test fails."""
    ctx = mp.spawn(_entry, args=(world, str(tmp_path / "store"), fn.__module__, fn.__name__,
                                 args, str(tmp_path)), nprocs=world, join=False)
    deadline = time.monotonic() + timeout_s
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                for proc in ctx.processes:
                    proc.kill()
                raise TimeoutError(f"{fn.__name__}: world of {world} still running "
                                   f"after {timeout_s} s")
        missing = [r for r in range(world) if not (tmp_path / f"rank{r}.pkl").exists()]
        if missing:
            raise RuntimeError(f"{fn.__name__}: ranks {missing} ended without a result")
    except Exception as e:
        raise AssertionError(f"{fn.__name__}: the world of {world} failed: {e}\n"
                             f"{_rank_errors(tmp_path, world)}") from e
    out = []
    for r in range(world):
        with open(tmp_path / f"rank{r}.pkl", "rb") as f:
            res = pickle.load(f)
        assert not res["jax_loaded"], f"rank {r} imported jax"
        out.append(res["result"])
    return out


def mesh_dataset(n=2048, f=16, c=4, seed=0):
    """``random_graph`` at 2,048 nodes with 16 noisy features that carry the
    label (so logits separate, and an accuracy does not hang on a near tie)
    and a random 50/25/25 split."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, c, n).astype(np.int32)
    feats = rng.standard_normal((n, f)).astype(np.float32)
    feats[np.arange(n), labels] += 2.0
    split = rng.choice([1, 2, 3], size=n, p=[0.5, 0.25, 0.25]).astype(np.int32)
    return Dataset(name="mesh-test", graph=random_graph(n, 8, seed=seed)[0],
                   feature_csr=None, features=feats, labels=labels, split=split,
                   n_nodes=n, input_dim=f, output_dim=c)


def mesh_config(route: str, epochs: int = 1, dropouts=(0.0, 0.0),
                weight_decay: float | None = None, mode: str = "eager",
                early_stopping: int = 0, learning_rate: float | None = None,
                eps: float | None = None, remat: bool = False) -> Config:
    """A 2-layer, 8-wide configuration of one of the ported routes:
    ``gcn-flat``, ``gcn-hybrid`` (int8 slabs), ``gat-tiles`` (int8 packs),
    ``sage-`` or ``gin-`` with ``flat`` or ``hybrid``, with ``-boundary`` or
    ``-all_gather`` appended."""
    model, layout, halo = route.split("-")
    cfg = Config()
    cfg.gcn.hidden_dims, cfg.gcn.dropouts, cfg.gcn.epochs = (8,), dropouts, epochs
    cfg.gcn.early_stopping, cfg.gcn.remat = early_stopping, remat
    if weight_decay is not None:
        cfg.adam.weight_decay = weight_decay
    if learning_rate is not None:
        cfg.adam.learning_rate = learning_rate
    if eps is not None:
        cfg.adam.eps = eps
    cfg.train.verbose, cfg.train.mode = False, mode
    cfg.tpu.halo, cfg.tpu.halo_fallback = halo, False
    cfg.tpu.backend = "segment" if layout == "flat" else "hybrid"
    cfg.tpu.tile_size, cfg.tpu.tile_dtype, cfg.tpu.min_tile_nnz = 128, "int8", 40
    cfg.gcn.model = model
    if model == "gat":
        cfg.gcn.heads = 2
    return cfg


# ---------------------------------------------------------------------------
# checks run on every rank
# ---------------------------------------------------------------------------


def _aggregation_checks(rank, world):
    """Each layout's distributed Â·x and its gradient on this rank's rows
    against the dense single-card product."""
    csr = random_graph(2048, 8, seed=3)[0]
    adj = csr.to_dense()
    layouts = {
        "flat all_gather": lambda: tp.partition_graph(csr, world),
        "flat boundary": lambda: tp.partition_graph(csr, world, boundary=True),
        "hybrid all_gather": lambda: tp.partition_graph_hybrid(csr, world, min_tile_nnz=60),
        "hybrid boundary": lambda: tp.partition_graph_hybrid(
            csr, world, min_tile_nnz=60, boundary=True),
        "hybrid int8 boundary": lambda: tp.partition_graph_hybrid(
            csr, world, tile_c=256, tile_dtype="int8", min_tile_nnz=60, boundary=True),
    }
    for name, make in layouts.items():
        sg = make()
        graph = tpl.rank_graph(sg, rank, CPU)
        n_pad = sg.n_nodes_pad
        rng = np.random.default_rng(0)  # the same global arrays on every rank
        x = rng.standard_normal((n_pad, 16)).astype(np.float32)
        c = rng.standard_normal((n_pad, 16)).astype(np.float32)
        a = np.zeros((n_pad, n_pad), np.float32)
        a[: csr.n_rows, : csr.n_rows] = adj
        perm = getattr(sg, "node_perm", None)
        if perm is not None:
            a = a[perm][:, perm]
        rows = slice(rank * sg.n_local, (rank + 1) * sg.n_local)
        xl = torch.from_numpy(x[rows]).requires_grad_()
        out = graph.aggregate(xl)
        (out * torch.from_numpy(c[rows])).sum().backward()
        np.testing.assert_allclose(out.detach().numpy(), (a @ x)[rows], rtol=1e-5,
                                   atol=1e-5, err_msg=f"{name} forward")
        np.testing.assert_allclose(xl.grad.numpy(), (a.T @ c)[rows], rtol=1e-5,
                                   atol=1e-5, err_msg=f"{name} backward")
        assert (sg.send_idx is not None) == name.endswith("boundary"), name
    return sorted(layouts)


STRUCTURE = {
    "gcn-flat-all_gather": dict(all_gather=4, reduce_scatter=2, all_to_all=0),
    "gcn-flat-boundary": dict(all_gather=0, reduce_scatter=0, all_to_all=6),
    "gcn-hybrid-boundary": dict(all_gather=0, reduce_scatter=0, all_to_all=6),
    "gat-tiles-all_gather": dict(all_gather=4, reduce_scatter=2, all_to_all=0),
    "gat-tiles-boundary": dict(all_gather=0, reduce_scatter=0, all_to_all=6),
    # one rotation a forward and a backward aggregation at world 2
    "gcn-flat-ring": dict(all_gather=0, reduce_scatter=0, all_to_all=0, ppermute=6),
}


def _collective_structure(rank, world):
    """The collectives one epoch step calls, per route."""
    ds = mesh_dataset()
    got = {}
    for route in STRUCTURE:
        cfg = mesh_config(route)
        run = tpl.build_rank(cfg, ds, rank, world, cfg.tpu.halo, CPU)
        step = tpl.make_parallel_epoch_step(cfg, run.model, run.graph, run.data,
                                            run.split_counts)
        opt = init_adam(list(run.model.weights))
        for k in collectives.counts:
            collectives.counts[k] = 0
        metrics = step(opt, [0] * (2 * run.model.n_layers))
        assert torch.isfinite(metrics).all(), route
        got[route] = dict(collectives.counts)
    return got


# the collectives of the mesh GCN's deferred-eval epoch: the shared layer 0
# and the stacked last layer once each forward, each layer's backward once;
# at tp 1 no feat collective
NO_FEAT = dict(feat_psum=0, feat_psum_scatter=0, feat_all_gather=0, feat_f=0)
DEFERRED_STRUCTURE = {
    "gcn-flat-all_gather": dict(all_gather=3, reduce_scatter=1, all_to_all=0, all_reduce=1,
                                ppermute=0, **NO_FEAT),
    "gcn-flat-boundary": dict(all_gather=0, reduce_scatter=0, all_to_all=4, all_reduce=1,
                              ppermute=0, **NO_FEAT),
    "gcn-hybrid-boundary": dict(all_gather=0, reduce_scatter=0, all_to_all=4, all_reduce=1,
                                ppermute=0, **NO_FEAT),
}


def _deferred_structure(rank, world):
    """The collectives one deferred-eval epoch calls, per route."""
    ds = mesh_dataset()
    got = {}
    for route in DEFERRED_STRUCTURE:
        cfg = mesh_config(route)
        run = tpl.build_rank(cfg, ds, rank, world, cfg.tpu.halo, CPU)
        step = tpl.make_parallel_deferred_step(cfg, run.model, run.graph, run.data,
                                               run.split_counts)
        opt = init_adam(list(run.model.weights))
        for k in collectives.counts:
            collectives.counts[k] = 0
        assert torch.isfinite(step(opt, [0] * run.model.n_layers)).all(), route
        got[route] = dict(collectives.counts)
    return got


def fit_routes(rank, world, runs, epochs):
    """``fit_parallel`` of each run in ``runs`` (name -> (route, weight decay,
    initial weights as numpy arrays[, ``mesh_config`` keywords])) on this
    rank: (history, test_acc) per run."""
    ds = mesh_dataset()
    out = {}
    for name, (route, wd, w, *opts) in runs.items():
        kw = {"epochs": epochs, **(opts[0] if opts else {})}
        res = tpl.fit_parallel(mesh_config(route, weight_decay=wd, **kw), ds,
                               n_devices=world, device="cpu",
                               weights=[torch.from_numpy(a) for a in w])
        out[name] = (res.history, res.test_acc)
    return out


def resume_routes(rank, world, runs, epochs, at, ck_root):
    """``fit_parallel`` of each run in ``runs`` (name -> (route, ``mesh_config``
    keywords, initial weights as numpy arrays)) in ``mode=scan`` on this
    rank, writing a checkpoint every ``at`` epochs under ``ck_root``, then
    resumed from the one at epoch ``at``: (the whole run's history, the
    resumed run's, the files written) per run."""
    ds = mesh_dataset()
    out = {}
    for name, (route, kw, w) in runs.items():
        ck = os.path.join(ck_root, name.replace(" ", "_"))
        cfg = mesh_config(route, epochs=epochs, mode="scan", **kw)
        cfg.train.checkpoint_dir, cfg.train.checkpoint_every = ck, at
        whole = tpl.fit_parallel(cfg, ds, n_devices=world, device="cpu",
                                 weights=[torch.from_numpy(a) for a in w])
        files = sorted(os.listdir(ck))
        cfg.train.checkpoint_dir = ""
        resumed = tpl.fit_parallel(cfg, ds, n_devices=world, device="cpu",
                                   resume_from=os.path.join(ck, f"ckpt_{at:06d}.npz"))
        out[name] = (whole.history, resumed.history, files)
    return out


def _seeded_masks(rank, world):
    """The K1 mask a GCN layer draws on this rank's rows for one epoch's
    seeds (dropout 0.5)."""
    from parallel_gcn_tpu_torch.ops.cuda_dropout import dropout
    from parallel_gcn_tpu_torch.train import epoch_seeds

    seeds = tpl.rank_seeds(epoch_seeds(torch.Generator().manual_seed(7), 2), rank)
    return (dropout(torch.ones(256, 8), seeds[0], 0.5) != 0).numpy()


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("world", [2, 4])
def test_distributed_aggregation_matches_single_card(tmp_path, world):
    results = run_world(_aggregation_checks, world, tmp_path)
    assert all(r == results[0] for r in results)


def test_epoch_step_collective_structure(tmp_path):
    results = run_world(_collective_structure, 2, tmp_path)
    for route, expect in STRUCTURE.items():
        for rank, got in enumerate(results):
            for op, n in expect.items():
                assert got[route][op] == n, f"{route} rank {rank}: {op} {got[route]}"
            # the gradients with the train sums, then the val sums
            assert got[route]["all_reduce"] == 2, got[route]


def test_deferred_epoch_collective_structure(tmp_path):
    """The deferred-eval epoch stacks the train and val halves into one
    last-layer exchange and one all_reduce (the eager step: 4 forward
    exchanges and 2 all_reduces, ``STRUCTURE``)."""
    for got in run_world(_deferred_structure, 2, tmp_path):
        for route, expect in DEFERRED_STRUCTURE.items():
            assert got[route] == expect, f"{route}: {got[route]}"


def test_dropout_masks_differ_across_ranks(tmp_path):
    masks = run_world(_seeded_masks, 2, tmp_path)
    assert (masks[0] != masks[1]).mean() > 0.3
    seeds = list(range(10, 14))
    assert tpl.rank_seeds(seeds, 0, attention=True) == seeds
    r1 = tpl.rank_seeds(seeds, 1, attention=True)
    assert all(a != b for a, b in zip(r1, seeds))
    assert all(0 <= s < 2**31 - 1 for s in r1[1::2])


# options that the mesh has ported since they were listed here: all of them
PORTED_MESH_OPTIONS = {("model", "sage"), ("model", "gin"), ("remat", True),
                       ("halo", "ring"), ("halo", "adaptive"), ("tp", 2)}


@pytest.mark.parametrize("key,value", [
    ("halo", "ring"), ("halo", "adaptive"), ("tp", 2), ("model", "sage"),
    ("model", "gin"), ("remat", True),
])
def test_unported_mesh_options_raise(key, value):
    """No listed option is refused any more: each passes the config check,
    and ``fit_parallel`` outside a world of its size raises the torchrun
    command of that size (n_devices × tp processes) instead of a
    NotImplementedError."""
    cfg = mesh_config("gcn-flat-all_gather")
    section = cfg.tpu if hasattr(cfg.tpu, key) else cfg.gcn
    setattr(section, key, value)
    assert (key, value) in PORTED_MESH_OPTIONS
    tpl._check_config(cfg, cfg.tpu.halo)
    with pytest.raises(RuntimeError,
                       match=f"torchrun --standalone --nproc_per_node={2 * cfg.tpu.tp} "):
        tpl.fit_parallel(cfg, None, n_devices=2, device="cpu")


def test_n_devices_needs_a_world():
    with pytest.raises(RuntimeError, match="torchrun --standalone --nproc_per_node=2"):
        with collectives.world(2, CPU):
            pass


def test_cli_n_devices_outside_a_world_exits_2(capsys):
    assert "WORLD_SIZE" not in os.environ
    assert cli_main(["synth-medium", "device=cpu", "n_devices=2"]) == 2
    out = capsys.readouterr().out
    assert "torchrun --standalone --nproc_per_node=2 -m parallel_gcn_tpu_torch" in out
    assert cli_main(["synth-medium", "device=cpu", "n_devices=2", "tp=2"]) == 2


def test_cli_trains_in_a_torchrun_world_on_cpu(tmp_path):
    env = dict(os.environ, PGCN_CACHE_DIR=str(tmp_path), CUDA_VISIBLE_DEVICES="",
               OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node=2",
         "-m", "parallel_gcn_tpu_torch", "synth-medium", "device=cpu", "n_devices=2",
         "epochs=2", "hidden_dims=8", "mode=eager", "halo=boundary", "halo_fallback=false"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "2 ranks, rank 0 on cpu" in proc.stdout
    assert "mesh: 2 rank(s), halo=boundary" in proc.stdout
    assert "epoch=2 " in proc.stdout and "epochs_run=2" in proc.stdout
    assert proc.stdout.count("epochs_run=") == 1  # only rank 0 prints
