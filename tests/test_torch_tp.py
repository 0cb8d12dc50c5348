"""Tensor parallelism (``tp`` > 1) of parallel_gcn_tpu_torch against the JAX
package's.

Gloo worlds of CPU processes (``tests/test_torch_parallel.py``'s
``run_world``, each killed after 240 s; this module imports no JAX at its
top, so a rank imports none) in the (n_devices, tp) layouts (2, 2), a world
of 4, and (1, 2), a world of 2. Each world starts once (a module fixture)
and runs every check of its layout:

- JAX's own TP routes (``tests/test_parallel.py``'s
  ``test_fit_parallel_tp_matches_single_chip`` and ``tests/test_sage.py``'s):
  the GCN at L = 2 over flat COO with the all_gather halo, over int8 tiles
  with the boundary halo and over the hub fixture with the adaptive halo,
  at L = 3 with residual connections and early stopping; SAGE and GIN at
  L = 2 and 3. Each in ``mode=eager`` and ``mode=scan``, from JAX's initial
  weights carried across by ``convert.py``: against JAX ``fit_parallel``
  with the same ``tp`` at weight decay 0, and against the port's
  single-card ``fit`` at the default decay, histories within 1e-4, test_acc
  equal. (At a nonzero decay JAX's TP gradient is n_dev·tp times the
  loss's, ROADMAP F5: ``test_f5_jax_gap_depends_on_n_dev_times_tp``.)
- the collectives of one epoch step: the node group's halos as at tp 1,
  the feat kinds as the schedule says;
- ``remat=true`` bit-equal to the plain run, its step calling the same
  feat collectives;
- dropout: a replicated input's mask the same on every feat rank, a
  feat-sharded input's different; a TP run with dropout learns;
- checkpoints: full arrays that JAX's ``load_checkpoint`` reads, a resumed
  TP run bit-equal to the uninterrupted one, the TP file resumed at tp 1
  within 1e-4.

Plus the weight shards against JAX ``shard_weights``' addressable shards,
the dims checks, the GAT's refusal, and the CLI under ``torchrun`` in a
world of 4 = (2, 2).
"""

import os
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch
import torch.distributed as dist

from parallel_gcn_tpu_torch.cli import main as cli_main
from parallel_gcn_tpu_torch.data.parser import to_device
from parallel_gcn_tpu_torch.ops.cuda_dropout import dropout
from parallel_gcn_tpu_torch.optim import init_adam
from parallel_gcn_tpu_torch.parallel import collectives
from parallel_gcn_tpu_torch.parallel import train_parallel as tpl
from parallel_gcn_tpu_torch.train import build_model, epoch_seeds, fit
from test_torch_halo import datasets
from test_torch_parallel import CPU, REPO, mesh_config, run_world

torch.set_num_threads(1)
EPOCHS = 5
LAYOUTS = {"2x2": (2, 2), "1x2": (1, 2)}
FEAT_KEYS = ("feat_psum", "feat_psum_scatter", "feat_all_gather", "feat_f")


def tp_config(route: str, tp: int, n_layers: int = 2, dropout_rate: float = 0.0,
              residual: bool = False, **kw):
    """``mesh_config(route, **kw)`` at ``n_layers`` layers 8 wide, ``tp``
    feat ranks, every dropout ``dropout_rate``."""
    cfg = mesh_config(route, **kw)
    cfg.gcn.n_layers = n_layers
    cfg.gcn.hidden_dims = (8,) * (n_layers - 1)
    cfg.gcn.dropouts = (dropout_rate,) * n_layers
    cfg.gcn.residual = residual
    cfg.tpu.tp = tp
    return cfg


# layout -> name -> (dataset, route, layers, tp_config keywords): JAX's TP
# routes, spread over the two layouts. The early-stopping run takes Adam's
# eps at 1e-12 (at weight decay 0 JAX's factor n_dev·tp, F5, still reaches
# Adam's update through eps, m/(sqrt(v) + eps); tests/test_torch_parallel_train.py)
# and learning rate 0.3, where the rule fires at epoch 4 with a margin of
# 2.3e-3 (at 0.1 it fires after epoch 30, where JAX's own single-chip and
# mesh runs part by 1.5e-2 at 3 layers with residual connections)
ROUTES = {
    "2x2": {
        "gcn flat all_gather": ("random", "gcn-flat-all_gather", 2, {}),
        "gcn int8 tiles boundary": ("random", "gcn-hybrid-boundary", 2, {}),
        "gcn flat adaptive hub": ("hub", "gcn-flat-adaptive", 2, {}),
        "sage flat all_gather": ("random", "sage-flat-all_gather", 2, {}),
        "gin flat boundary L3": ("random", "gin-flat-boundary", 3, {}),
    },
    "1x2": {
        "gcn L3 residual early stopping": (
            "random", "gcn-flat-all_gather", 3,
            dict(residual=True, early_stopping=3, epochs=10, learning_rate=0.3, eps=1e-12)),
        "sage int8 tiles boundary L3": ("random", "sage-hybrid-boundary", 3, {}),
        "gin int8 tiles all_gather": ("random", "gin-hybrid-all_gather", 2, {}),
    },
}
# the F5 run: JAX's TP gradient carries n_dev·tp, so its decay acts as wd/(n_dev·tp)
F5_ROUTE, F5_WD, F5_EPOCHS = "gcn-flat-all_gather", 0.05, 10


def _runs(layout: str, jax_init) -> dict:
    """name -> (dataset, route, layers, keywords, initial weights): each
    route in both modes, at weight decay 0 (against JAX) and at the
    default (against the single card)."""
    runs = {}
    for name, (data, route, n_layers, kw) in ROUTES[layout].items():
        for mode in ("eager", "scan"):
            w = jax_init(tp_config(route, 1, n_layers, mode=mode, **kw), datasets(data))
            runs[f"{name} {mode}"] = (data, route, n_layers, {**kw, "mode": mode,
                                                              "weight_decay": 0.0}, w)
            runs[f"{name} {mode} decayed"] = (data, route, n_layers, {**kw, "mode": mode}, w)
    return runs


# ---------------------------------------------------------------------------
# what every rank of a world runs
# ---------------------------------------------------------------------------


def _fit(cfg, data, w=None, **kw):
    return tpl.fit_parallel(cfg, datasets(data), device="cpu",
                            weights=None if w is None else [torch.from_numpy(a) for a in w],
                            **kw)


def _step_counts(cfg, world: int, deferred: bool = False) -> dict:
    """The collectives one epoch step of ``cfg`` calls on this rank (layer 0
    aggregated, as JAX's eager step does)."""
    tp = cfg.tpu.tp
    grid = collectives.grid(world // tp, tp)
    run = tpl.build_rank(cfg, datasets("random"), grid.node_rank, world // tp, cfg.tpu.halo,
                         CPU, grid=grid)
    make = tpl.make_parallel_deferred_step if deferred else tpl.make_parallel_epoch_step
    step = make(cfg, run.model, run.graph, run.data, run.split_counts)
    opt = init_adam(list(run.model.weights))
    seeds = run.seeds(epoch_seeds(torch.Generator().manual_seed(3), run.model.n_layers))
    for k in collectives.counts:
        collectives.counts[k] = 0
    assert torch.isfinite(step(opt, seeds)).all()
    return dict(collectives.counts)


# route, layers -> feat collectives of one eager step: the train and the val
# forward (psum of the last layer, psum_scatter of an inner row layer), the
# backward (the column all_gather of psum_scatter's transpose, GIN's f from
# layer 1 on), one psum of the pre- and post-update Σw²
STRUCTURE = {
    ("gcn-flat-all_gather", 2): dict(feat_psum=3, feat_psum_scatter=0, feat_all_gather=0,
                                     feat_f=0),
    ("gcn-flat-boundary", 3): dict(feat_psum=3, feat_psum_scatter=2, feat_all_gather=1,
                                   feat_f=0),
    ("sage-flat-all_gather", 2): dict(feat_psum=5, feat_psum_scatter=0, feat_all_gather=0,
                                      feat_f=0),
    ("gin-flat-all_gather", 2): dict(feat_psum=5, feat_psum_scatter=0, feat_all_gather=0,
                                     feat_f=1),
    # GIN gathers no columns at any depth: each layer's psum leaves its
    # output replicated
    ("gin-flat-all_gather", 4): dict(feat_psum=9, feat_psum_scatter=0, feat_all_gather=0,
                                     feat_f=3),
}
# the node group's collectives at tp 1 in a world of the same node ranks
# (tests/test_torch_parallel.py STRUCTURE): the GCN at 2 layers, the
# all_gather halo: 2 aggregations a forward, 2 backward; GIN's layer 0
# input takes no gradient
NODE_STRUCTURE = {
    ("gcn-flat-all_gather", 2): dict(all_gather=4, reduce_scatter=2, all_to_all=0,
                                     all_reduce=2),
    ("gcn-flat-boundary", 3): dict(all_gather=0, reduce_scatter=0, all_to_all=9,
                                   all_reduce=2),
    ("sage-flat-all_gather", 2): dict(all_gather=4, reduce_scatter=2, all_to_all=0,
                                      all_reduce=2),
    ("gin-flat-all_gather", 2): dict(all_gather=4, reduce_scatter=1, all_to_all=0,
                                     all_reduce=2),
    ("gin-flat-all_gather", 4): dict(all_gather=8, reduce_scatter=3, all_to_all=0,
                                     all_reduce=2),
}


def _masks(cfg, world: int) -> dict:
    """Each layer's K1 mask over an [n_local, 8] input on this rank for one
    epoch's seeds (rate 0.5), and whether the layer's input is
    feat-sharded."""
    tp = cfg.tpu.tp
    grid = collectives.grid(world // tp, tp)
    run = tpl.build_rank(cfg, datasets("random"), grid.node_rank, world // tp, cfg.tpu.halo,
                         CPU, grid=grid)
    seeds = run.seeds(epoch_seeds(torch.Generator().manual_seed(7), run.model.n_layers))
    ones = torch.ones(run.sgraph.n_local, 8)
    return dict(node=grid.node_rank, feat=grid.feat_rank,
                sharded=run.model.feat_sharded_inputs(),
                masks=[(dropout(ones, s, 0.5) != 0).numpy() for s in seeds])


def world_checks(rank, world, tp, runs, ck_dir):
    """Every check of one layout on this rank: the routes' (history,
    test_acc); at (2, 2) also the step structures, remat, dropout and
    checkpoints; at (1, 2) the F5 run."""
    out = {"fits": {}}
    for name, (data, route, n_layers, kw, w) in runs.items():
        res = _fit(tp_config(route, tp, n_layers, epochs=kw.pop("epochs", EPOCHS), **kw),
                   data, w)
        out["fits"][name] = (res.history, res.test_acc)
    if world == 2:
        res = _fit(tp_config(F5_ROUTE, tp, epochs=F5_EPOCHS, weight_decay=F5_WD), "random")
        out["f5"] = res.history
        return out
    out["structure"] = {key: _step_counts(tp_config(key[0], tp, key[1]), world)
                        for key in STRUCTURE}
    out["deferred"] = _step_counts(tp_config("gcn-flat-all_gather", tp), world, deferred=True)
    out["remat"] = {}
    for route, n_layers in (("gcn-flat-boundary", 3), ("sage-flat-all_gather", 2),
                            ("gin-flat-all_gather", 3)):
        hist, steps = [], []
        for remat in (False, True):
            cfg = tp_config(route, tp, n_layers, dropout_rate=0.3, remat=remat, epochs=4)
            hist.append(_fit(cfg, "random").history)
            steps.append(_step_counts(cfg, world))
        out["remat"][route] = (hist, steps)
    out["masks"] = {route: _masks(tp_config(route, tp, n_layers), world)
                    for route, n_layers in (("gcn-flat-all_gather", 3),
                                            ("gin-flat-all_gather", 2))}
    res = _fit(tp_config("gcn-flat-all_gather", tp, dropout_rate=0.3, epochs=30,
                         learning_rate=0.05), "random")
    out["learns"] = (res.history, res.test_acc)
    # checkpoints: every 3 epochs of a 6-epoch scan, then resumed from epoch 3
    # at tp 2 and at tp 1 (a world of 4 node ranks)
    cfg = tp_config("sage-flat-boundary", tp, epochs=6, mode="scan")
    cfg.train.checkpoint_dir, cfg.train.checkpoint_every = ck_dir, 3
    whole = _fit(cfg, "random")
    cfg.train.checkpoint_dir = ""
    at3 = os.path.join(ck_dir, "ckpt_000003.npz")
    resumed = _fit(cfg, "random", resume_from=at3)
    cfg.tpu.tp = 1
    resumed_tp1 = _fit(cfg, "random", resume_from=at3)
    out["checkpoint"] = (whole.history, resumed.history, resumed_tp1.history,
                         [w.numpy() for w in whole.weights], sorted(os.listdir(ck_dir)))
    return out


# ---------------------------------------------------------------------------
# the JAX side
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_side():
    """The JAX package's pieces, imported here (never at the module's top):
    (jax_fit_parallel, config converter, dataset converter, init)."""
    import jax

    import parallel_gcn_tpu.ops.pallas_bcsr as pb
    from parallel_gcn_tpu.parallel.train_parallel import fit_parallel as jax_fit_parallel
    from parallel_gcn_tpu_torch.convert import params_from_numpy
    from test_torch_parallel_train import _jax_config, _jax_dataset, _jax_init

    def init(cfg, ds):
        w = _jax_init(_jax_config(cfg), ds)
        return [t.numpy() for t in params_from_numpy(jax.tree.map(np.asarray, w))]

    old = pb._INTERPRET[0]
    pb._INTERPRET[0] = True  # as tests/test_parallel.py runs the mesh's Pallas kernels
    yield jax_fit_parallel, _jax_config, _jax_dataset, init
    pb._INTERPRET[0] = old


@pytest.fixture(scope="module")
def worlds(jax_side, tmp_path_factory):
    """Each layout's world, run once: layout -> (every rank's results, the
    runs it trained, its checkpoint directory)."""
    init = jax_side[3]
    out = {}
    for layout, (n_dev, tp) in LAYOUTS.items():
        runs = _runs(layout, init)
        tmp = tmp_path_factory.mktemp(f"world_{layout}")
        ck_dir = str(tmp / "ck")
        results = run_world(world_checks, n_dev * tp, tmp, tp, runs, ck_dir)
        out[layout] = (results, runs, ck_dir)
    return out


def _single_card(data: str, cfg, w=None):
    """The port's single-card ``fit`` of ``cfg`` at tp 1."""
    cfg.tpu.tp = 1
    dds = to_device(datasets(data), device=CPU, hybrid=cfg.tpu.backend == "hybrid",
                    tile_dtype="int8", tile_size=128, min_tile_nnz=40)
    return fit(cfg, dds, weights=None if w is None else [torch.from_numpy(a.copy()) for a in w])


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_tp_routes_match_jax_and_the_single_card(worlds, jax_side, layout):
    """Every route of the layout, eager and scan: against JAX
    ``fit_parallel`` with the same (n_devices, tp) at weight decay 0, and
    against the port's single-card ``fit`` at the default decay."""
    jax_fit_parallel, jax_config, jax_dataset, _ = jax_side
    n_dev, tp = LAYOUTS[layout]
    results, runs, _ = worlds[layout]
    for name, (data, route, n_layers, kw, w) in runs.items():
        kw = dict(kw)
        cfg = tp_config(route, tp, n_layers, epochs=kw.pop("epochs", EPOCHS), **kw)
        if name.endswith("decayed"):
            ref = _single_card(data, cfg, w)
        else:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", UserWarning)
                ref = jax_fit_parallel(jax_config(cfg), jax_dataset(datasets(data)),
                                       n_devices=n_dev)
        want = np.asarray(ref.history)
        for rank, got in enumerate(results):
            hist, test_acc = got["fits"][name]
            assert hist.shape == want.shape, f"{name} rank {rank}"
            np.testing.assert_allclose(hist, want, rtol=0, atol=1e-4,
                                       err_msg=f"{name} rank {rank}")
            assert test_acc == pytest.approx(ref.test_acc, abs=1e-7), f"{name} rank {rank}"
        if "early stopping" in name:
            assert len(want) < 10, f"{name}: the stopping rule did not fire"


def test_tp_shards_equal_jax_shard_weights(jax_side):
    """``shard_weights`` gives each feat rank the values of JAX
    ``shard_weights``' addressable shard on mesh device (0, feat rank), for
    the GCN at 4 layers (col, row, col, row), SAGE and GIN at 3, tp 2 and 4."""
    import jax

    from parallel_gcn_tpu.parallel.train_parallel import make_mesh
    from parallel_gcn_tpu.parallel.train_parallel import shard_weights as jax_shard_weights
    from parallel_gcn_tpu.train import init_model_params
    from parallel_gcn_tpu_torch.convert import params_from_numpy
    from test_torch_parallel_train import _jax_config

    for model, n_layers in (("gcn", 4), ("sage", 3), ("gin", 3)):
        for tp in (2, 4):
            cfg = tp_config(f"{model}-flat-all_gather", tp, n_layers)
            cfg.gcn.hidden_dims = (16,) * (n_layers - 1)
            jw = init_model_params(_jax_config(cfg), jax.random.PRNGKey(0), 12, 4)
            mesh = make_mesh(2, tp=tp)
            leaves = jax.tree.leaves(jax_shard_weights(jw, mesh, tp, model))
            full = params_from_numpy(jax.tree.map(np.asarray, jw))
            for f in range(tp):
                mine = tpl.shard_weights(full, tp, f, model)
                dev = mesh.devices[0, f]
                for i, (leaf, got) in enumerate(zip(leaves, mine, strict=True)):
                    shard = next(s for s in leaf.addressable_shards if s.device == dev)
                    np.testing.assert_array_equal(got.numpy(), np.asarray(shard.data),
                                                  err_msg=f"{model} tp={tp} leaf {i}")
            assert [w.shape for w in tpl.shard_weights(full, 1, 0, model)] == \
                [w.shape for w in full]


@pytest.mark.parametrize("dims,tp,model", [
    ((12, (17,), 4), 4, "gcn"),  # JAX's test_tp_validates_indivisible_dims
    ((12, (16,), 4), 4, "gcn"),
    ((12, (16, 18), 4), 4, "gcn"),
    ((12, (16, 18, 16), 4), 2, "sage"),
    ((12, (6,), 4), 4, "gin"),
    ((12, (8, 6), 4), 4, "gin"),
    ((6, (), 4), 4, "gcn"),
])
def test_validate_tp_dims_matches_jax(dims, tp, model):
    from parallel_gcn_tpu.parallel.train_parallel import validate_tp_dims as jax_validate

    def outcome(fn):
        try:
            fn(*dims, tp=tp, model=model)
            return None
        except ValueError as e:
            return str(e)

    want = outcome(jax_validate)
    assert outcome(tpl.validate_tp_dims) == want
    if want is not None:
        assert "divisible by tp" in want
    with pytest.raises(ValueError, match="divisible by tp"):
        tpl.validate_tp_dims(12, (17,), 4, tp=4)


def test_gat_takes_no_tp_and_single_card_fit_names_the_mesh():
    cfg = mesh_config("gat-tiles-boundary")
    cfg.tpu.tp = 2
    with pytest.raises(ValueError, match="tp=1"):
        tpl.fit_parallel(cfg, datasets("random"), n_devices=1, device="cpu")
    cfg = tp_config("gcn-flat-all_gather", 2)
    dds = to_device(datasets("random"), device=CPU)
    with pytest.raises(ValueError, match="torchrun --standalone --nproc_per_node=2 .* tp=2"):
        build_model(cfg, dds)
    with pytest.raises(RuntimeError, match="torchrun --standalone --nproc_per_node=4"):
        tpl.fit_parallel(cfg, datasets("random"), n_devices=2, device="cpu")


def test_tp_step_collective_structure(worlds):
    """One eager step calls the node group's collectives as at tp 1 and the
    feat collectives the schedule says; the deferred epoch one feat psum of
    the stacked logits and one of Σw²."""
    for rank, got in enumerate(worlds["2x2"][0]):
        for key, feat in STRUCTURE.items():
            counts = got["structure"][key]
            assert {k: counts[k] for k in FEAT_KEYS} == feat, (rank, key, counts)
            node = {k: counts[k] for k in NODE_STRUCTURE[key]}
            assert node == NODE_STRUCTURE[key], (rank, key, counts)
        deferred = got["deferred"]
        assert (deferred["feat_psum"], deferred["all_gather"], deferred["all_reduce"]) == \
            (2, 3, 1), deferred


def test_tp_remat_is_bit_equal_and_recomputes_no_feat_collective(worlds):
    for rank, got in enumerate(worlds["2x2"][0]):
        for route, ((plain, remat), (s_plain, s_remat)) in got["remat"].items():
            assert np.array_equal(plain, remat), (rank, route)
            assert {k: s_remat[k] for k in FEAT_KEYS} == {k: s_plain[k] for k in FEAT_KEYS}, \
                (rank, route, s_plain, s_remat)
            assert s_remat["feat_psum"] > 0


def test_tp_dropout_masks_and_learning(worlds):
    """Replicated inputs (GCN layer 0, every GIN layer) draw one mask on
    every feat rank; feat-sharded inputs (the GCN's row layers) one per feat
    rank; node ranks differ. With dropout a TP run still learns (JAX
    ``test_fit_parallel_tp_learns_with_dropout``)."""
    results = worlds["2x2"][0]
    for route in ("gcn-flat-all_gather", "gin-flat-all_gather"):
        ranks = [got["masks"][route] for got in results]
        for a in ranks:
            for b in ranks:
                if a is b:
                    continue
                for i, sharded in enumerate(a["sharded"]):
                    same = np.array_equal(a["masks"][i], b["masks"][i])
                    if a["node"] != b["node"]:
                        assert not same, (route, i)
                    else:
                        assert same == (not sharded), (route, i, sharded)
    assert results[0]["masks"]["gcn-flat-all_gather"]["sharded"] == [False, True, True]
    assert results[0]["masks"]["gin-flat-all_gather"]["sharded"] == [False, False]
    hist, test_acc = results[0]["learns"]
    assert np.isfinite(hist).all() and hist[-1, 0] < hist[0, 0]
    assert test_acc > 0.5, test_acc


def test_tp_checkpoints_hold_full_arrays_and_resume(worlds):
    from parallel_gcn_tpu.utils.checkpoint import load_checkpoint as jax_load

    results = worlds["2x2"][0]
    whole, resumed, resumed_tp1, weights, files = results[0]["checkpoint"]
    assert files == ["ckpt_000003.npz", "ckpt_final.npz"]
    for got in results:
        assert np.array_equal(got["checkpoint"][1], whole[3:])
    np.testing.assert_allclose(resumed_tp1, whole[3:], rtol=0, atol=1e-4)
    # the result's weights are full arrays too, the same on every rank
    for got in results[1:]:
        for a, b in zip(got["checkpoint"][3], weights):
            assert np.array_equal(a, b)
    jw, _, epoch, _ = jax_load(os.path.join(worlds["2x2"][2], "ckpt_final.npz"))
    assert epoch == 6
    got = [(np.asarray(layer["neigh"]), np.asarray(layer["self"])) for layer in jw]
    assert [a.shape for pair in got for a in pair] == [w.shape for w in weights]
    for (neigh, self_), (wn, ws) in zip(got, zip(weights[::2], weights[1::2])):
        assert np.array_equal(neigh, wn) and np.array_equal(self_, ws)


def test_f5_jax_gap_depends_on_n_dev_times_tp(worlds, jax_side):
    """ROADMAP F5: at weight decay 0.05 JAX's train-loss gap to its single
    chip is the same at (n_dev, tp) = (2, 1) and (1, 2) (its TP gradient,
    like its node-axis one, is n_dev·tp times the loss's), while the port's
    (1, 2) run meets its single-card ``fit`` within 1e-4."""
    from parallel_gcn_tpu.data.parser import to_device as jax_to_device
    from parallel_gcn_tpu.train import fit as jax_fit

    jax_fit_parallel, jax_config, jax_dataset, _ = jax_side
    ds = datasets("random")
    jds = jax_dataset(ds)
    cfg = tp_config(F5_ROUTE, 1, epochs=F5_EPOCHS, weight_decay=F5_WD)
    one = np.asarray(jax_fit(jax_config(cfg), jax_to_device(jds)).history)
    gaps = {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        for n_dev, tp in ((2, 1), (1, 2)):
            cfg.tpu.tp = tp
            hist = np.asarray(jax_fit_parallel(jax_config(cfg), jds, n_devices=n_dev).history)
            gaps[n_dev, tp] = float(np.abs(hist[:, 0] - one[:, 0]).max())
    assert gaps[2, 1] > 1e-3, gaps
    assert gaps[1, 2] == pytest.approx(gaps[2, 1], rel=0.02), gaps
    mine = _single_card("random", tp_config(F5_ROUTE, 1, epochs=F5_EPOCHS,
                                            weight_decay=F5_WD)).history
    for got in worlds["1x2"][0]:
        np.testing.assert_allclose(got["f5"], mine, rtol=0, atol=1e-4)


def test_cli_tp_outside_its_world_exits_2(capsys):
    assert "WORLD_SIZE" not in os.environ
    assert cli_main(["synth-medium", "device=cpu", "n_devices=2", "tp=2"]) == 2
    assert "torchrun --standalone --nproc_per_node=4" in capsys.readouterr().out
    assert cli_main(["synth-medium", "device=cpu", "tp=2"]) == 2
    assert "--nproc_per_node=2" in capsys.readouterr().out


def test_cli_trains_tp_in_a_torchrun_world_on_cpu(tmp_path):
    env = dict(os.environ, PGCN_CACHE_DIR=str(tmp_path), CUDA_VISIBLE_DEVICES="",
               OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node=4",
         "-m", "parallel_gcn_tpu_torch", "synth-medium", "device=cpu", "n_devices=2", "tp=2",
         "epochs=2", "hidden_dims=8", "mode=eager"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "4 ranks, rank 0 on cpu" in proc.stdout
    assert "mesh: 2 rank(s)" in proc.stdout
    assert "tp: 2 feat ranks a node rank (4 processes)" in proc.stdout
    assert "epoch=2 " in proc.stdout and "epochs_run=2" in proc.stdout
    assert proc.stdout.count("epochs_run=") == 1  # only rank 0 prints
    assert not dist.is_initialized()
