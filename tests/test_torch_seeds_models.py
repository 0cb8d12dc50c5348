"""Seed lanes of GraphSAGE, GIN, the GAT and the fused GCN (K10 over seed
lanes), on the CPU: ``fit_seeds``' lanes against solo ``fit`` runs and
against the JAX package's ``vmap``ped whole-run program, the laned K10's
plain versions against the unlaned ones lane by lane, numpy models of the
laned kernels' index arithmetic, and the accuracy harness over the new
families."""

import copy
import os
import re

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
from parallel_gcn_tpu_torch.config import Config, parse_override
from parallel_gcn_tpu_torch.convert import params_from_numpy
from parallel_gcn_tpu_torch.data.parser import TEST, to_device
from parallel_gcn_tpu_torch.data.synthetic import make_synthetic_dataset
from parallel_gcn_tpu_torch.harness import accuracy
from parallel_gcn_tpu_torch.ops import cuda_dropout as cd
from parallel_gcn_tpu_torch.ops import cuda_fused as cf
from tests.test_torch_harness import write_reference_dataset

torch.set_num_threads(1)
CPU = torch.device("cpu")
SEEDS = [3, 11, 40]
LAYOUTS = {"hybrid": dict(hybrid=True, tile_dtype="int8", tile_size=128, min_tile_nnz=300),
           "segment": {}, "dense": dict(dense=True)}


def _dataset():
    return make_synthetic_dataset(
        "lanes", n_nodes=400, n_edges=6000, input_dim=20, n_classes=5,
        n_train=200, n_val=80, feature_nnz_per_row=6, n_communities=5)


def _cfg(model, backend, dtype, k, epochs, dropouts, **knobs):
    cfg = Config()
    cfg.gcn.model, cfg.gcn.hidden_dims, cfg.gcn.dropouts = model, (8,), dropouts
    cfg.gcn.epochs, cfg.gcn.early_stopping = epochs, k
    cfg.adam.learning_rate = 0.5 if k else 0.01
    cfg.tpu.backend, cfg.tpu.compute_dtype = backend, dtype
    cfg.tpu.matmul_precision = "highest"
    cfg.train.verbose = False
    for key, val in knobs.items():
        setattr(cfg.gcn if hasattr(cfg.gcn, key) else cfg.tpu, key, val)
    return cfg


def _close(got, want, dtype):
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    else:
        np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3 * np.abs(want).max())


def _lanes_are_solo_runs(cfg, dds, seeds, dtype):
    """``fit_seeds`` of ``cfg`` over ``seeds``, each lane held against
    ``fit`` with its seed (history, epochs, test metrics, weights)."""
    res = sd.fit_seeds(cfg, dds, seeds)
    assert res.seeds == seeds
    for s, seed in enumerate(seeds):
        solo_cfg = copy.deepcopy(cfg)
        solo_cfg.tpu.seed = seed
        solo = train.fit(solo_cfg, dds)
        assert res.epochs_run[s] == solo.epochs_run
        _close(res.history[s], solo.history, dtype)
        _close(np.array([res.test_loss[s], res.test_acc[s]]),
               np.array([solo.test_loss, solo.test_acc]), dtype)
        for got, want in zip(res.weights[s], solo.weights):
            _close(got.numpy(), want.numpy(), dtype)
    return res


# ---------------------------------------------------------------------------
# (a) lanes against their solo fit runs


@pytest.mark.parametrize("model", ["sage", "gin"])
@pytest.mark.parametrize("backend", list(LAYOUTS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k", [0, 3])
def test_sage_and_gin_lanes_are_solo_fit_runs(model, backend, dtype, k):
    dds = to_device(_dataset(), device=CPU, **LAYOUTS[backend])
    # an input dropout (each lane's own copy of the features) with early
    # stopping; without it, the shared features (GIN aggregates them once)
    cfg = _cfg(model, backend, dtype, k, 20 if k else 8, (0.2, 0.3) if k else (0.0, 0.3))
    res = _lanes_are_solo_runs(cfg, dds, SEEDS[1:], dtype)
    if k:  # the lanes stop at different epochs, each where its solo run stops
        assert len(set(res.epochs_run)) > 1 and max(res.epochs_run) < 20


GAT_LAYOUTS = {"tile": ("hybrid", {}), "segment": ("segment", {}),
               "chunked": ("segment", dict(edge_chunk=4000)), "dense": ("dense", {})}


@pytest.mark.parametrize("layout", list(GAT_LAYOUTS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k", [0, 3])
def test_gat_lanes_are_solo_fit_runs(layout, dtype, k):
    backend, knobs = GAT_LAYOUTS[layout]
    dds = to_device(_dataset(), device=CPU, **LAYOUTS[backend])
    # attention dropout on one case (the lanes' attention seeds, through
    # K1 on the chunked attention's edge slices)
    attn = 0.3 if (layout, dtype, k) == ("chunked", "float32", 0) else 0.0
    cfg = _cfg("gat", backend, dtype, k, 8 if k else 4, (0.2, 0.3), heads=2,
               attn_dropout=attn, **knobs)
    res = _lanes_are_solo_runs(cfg, dds, SEEDS[:2], dtype)
    if k:  # the stopping rule fired
        assert min(res.epochs_run) < 8


def test_gat_tile_lanes_draw_each_lanes_attention_mask():
    dds = to_device(_dataset(), device=CPU, **LAYOUTS["hybrid"])
    cfg = _cfg("gat", "hybrid", "float32", 0, 3, (0.0, 0.3), heads=2, attn_dropout=0.4)
    _lanes_are_solo_runs(cfg, dds, SEEDS[:2], "float32")


# ---------------------------------------------------------------------------
# (c) the fused GCN's lanes (the laned K10's plain versions on the CPU)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k", [0, 3])
def test_fused_gcn_lanes_are_solo_fused_runs(dtype, k):
    dds = to_device(_dataset(), device=CPU, **LAYOUTS["hybrid"])
    cfg = _cfg("gcn", "hybrid", dtype, k, 20 if k else 12, (0.2, 0.3),
               fuse_dropout_matmul=True)
    run = sd.seed_run(cfg, dds, SEEDS)
    # k = 0 is the deferred schedule
    assert (run.loop.final_val is not None) == (k == 0)
    # layer 0's laned K10 reads the shared features (no copy a lane), layer
    # 1's the joined hidden activations
    widths = []
    real = sd.dropout_matmul_lanes

    def spy(x, w, *args, **kwargs):
        widths.append((x.shape[1], w.shape[1]))
        return real(x, w, *args, **kwargs)

    sd.dropout_matmul_lanes = spy
    try:
        run.loop.step(run.loop.seeds.slots)
    finally:
        sd.dropout_matmul_lanes = real
    assert widths == [(dds.input_dim, dds.input_dim), (len(SEEDS) * 8, 8)]
    _lanes_are_solo_runs(cfg, dds, SEEDS, dtype)


# ---------------------------------------------------------------------------
# (b) lanes against the JAX package's jax.vmap over _make_scan_run


# the learning rate of the early-stopping runs (the lanes stop at different
# epochs): at 0.5 GIN's unnormalised sum drives its losses past 100, where an
# f32 ulp exceeds the histories' 1e-5, and the GAT's losses climb, which
# amplifies the two packages' rounding past the GAT's 1e-4
STOP_RATE = {"sage": 0.5, "gin": 0.1, "gat": 0.1}


def _jax_cfg(model, k, epochs):
    cfg = JaxConfig()
    cfg.gcn.model, cfg.gcn.hidden_dims, cfg.gcn.dropouts = model, (8,), (0.0, 0.0)
    cfg.gcn.heads, cfg.gcn.attn_dropout = 2, 0.0
    cfg.gcn.epochs, cfg.gcn.early_stopping = epochs, k
    cfg.adam.learning_rate = STOP_RATE[model] if k else 0.01
    cfg.tpu.backend, cfg.tpu.matmul_precision = "segment", "highest"
    cfg.train.verbose = False
    return cfg


@pytest.mark.parametrize("model", ["sage", "gin", "gat"])
@pytest.mark.parametrize("k, epochs", [(0, 15), (3, 40)])
def test_lanes_match_the_jax_vmapped_whole_run(model, k, epochs):
    ds = _dataset()
    jcfg = _jax_cfg(model, k, epochs)
    jdds = jax_to_device(ds)
    jmodel = jtrain.build_model(jcfg, jdds)
    run = jtrain._make_scan_run(jmodel, jcfg, jdds)
    test_fn = jtrain.make_eval_fn(jmodel, jcfg, jdds, TEST)

    def one(init_key, run_key):  # harness/accuracy.py:62-70
        w = jtrain.init_model_params(jcfg, init_key, jdds.input_dim, jdds.output_dim)
        weights, _, metrics, epochs_run = run(w, jax_init_adam(w), run_key)
        test_loss, test_acc = test_fn(weights)
        return metrics[jnp.maximum(epochs_run - 1, 0)][3], test_loss, test_acc, epochs_run, metrics

    seeds = jnp.asarray(SEEDS)
    init_keys = jax.vmap(jax.random.PRNGKey)(seeds)
    j_val, j_tl, j_test, j_epochs, j_hist = (np.asarray(a) for a in jax.vmap(one)(
        init_keys, jax.vmap(jax.random.PRNGKey)(seeds + 10_000)))

    cfg = _cfg(model, "segment", "float32", k, epochs, (0.0, 0.0), heads=2)
    cfg.adam.learning_rate = jcfg.adam.learning_rate
    dds = to_device(ds, device=CPU)
    weights = [params_from_numpy(jax.tree.map(np.asarray, jtrain.init_model_params(
        jcfg, key, ds.input_dim, ds.output_dim)), CPU) for key in init_keys]
    res = sd.fit_seeds(cfg, dds, SEEDS, weights=weights)
    assert list(j_epochs) == res.epochs_run
    if k:  # the lanes stop at different epochs in both packages
        assert len(set(res.epochs_run)) > 1
    for s in range(len(SEEDS)):
        got, want = res.history[s], j_hist[s, :res.epochs_run[s]]
        if model == "gat":  # as tests/test_torch_gat_train.py holds the GAT
            np.testing.assert_allclose(got[:, [0, 2]], want[:, [0, 2]], rtol=0, atol=1e-4)
            assert (np.abs(got[:, 1] - want[:, 1]) * ds.train_dim <= 1.01).all()
            assert (np.abs(got[:, 3] - want[:, 3]) * ds.val_dim <= 1.01).all()
        else:
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    # an accuracy is a count over the split divided by its size
    one_node = {"val": 1.01 / ds.val_dim, "test": 1.01 / ds.test_dim} if model == "gat" else \
        {"val": 1e-5, "test": 1e-5}
    np.testing.assert_allclose(res.val_acc, j_val, rtol=0, atol=one_node["val"])
    np.testing.assert_allclose(res.test_acc, j_test, rtol=0, atol=one_node["test"])
    np.testing.assert_allclose(res.test_loss, j_tl, rtol=0, atol=1e-4)


# ---------------------------------------------------------------------------
# (f) remat and residual lanes


@pytest.mark.parametrize("model", ["sage", "gin", "gat"])
@pytest.mark.parametrize("knob", ["remat", "residual"])
def test_remat_and_residual_lanes(model, knob):
    dds = to_device(_dataset(), device=CPU)
    cfg = _cfg(model, "segment", "float32", 0, 6, (0.2, 0.3), heads=2)
    if knob == "remat":
        cfg.gcn.remat = True
    else:
        cfg.gcn.n_layers, cfg.gcn.hidden_dims = 3, (8, 8)
        cfg.gcn.dropouts, cfg.gcn.residual = (0.0, 0.2, 0.3), True
    _lanes_are_solo_runs(cfg, dds, SEEDS[:2], "float32")


# ---------------------------------------------------------------------------
# (d) the laned K10's plain versions: the unlaned ones lane by lane


def _k10_operands(shared, lanes=3, n=37, k=21, m=6, dtype=torch.float32):
    gen = torch.Generator().manual_seed(k + lanes)
    x = torch.randn(n, k if shared else lanes * k, generator=gen).to(dtype)
    w = torch.randn(lanes, k, m, generator=gen).to(dtype)
    g = torch.randn(n, lanes * m, generator=gen)
    return x, w, g


@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_laned_k10_plain_is_the_unlaned_plain_lane_by_lane(shared, dtype):
    x, w, g = _k10_operands(shared, dtype=dtype)
    lanes, k, m = w.shape
    slot = torch.tensor(SEEDS, dtype=torch.int64)
    for seed in (SEEDS, slot):
        fwd = cf.dropout_matmul_lanes_plain(x, w, seed, 0.3)
        dw = cf.dropout_matmul_lanes_dw_plain(x, g, seed, 0.3, dtype, shared)
        dx = cf.dropout_matmul_lanes_dx_plain(g, w, seed, 0.3, dtype)
        assert fwd.shape == (x.shape[0], lanes * m) and dw.shape == (lanes, k, m)
        for s, one in enumerate(SEEDS):
            xs = x if shared else x[:, s * k:(s + 1) * k].contiguous()
            gs = g[:, s * m:(s + 1) * m].contiguous()
            assert torch.equal(fwd[:, s * m:(s + 1) * m],
                               cf.dropout_matmul_plain(xs, w[s], one, 0.3))
            assert torch.equal(dw[s], cf.dropout_matmul_dw_plain(xs, gs, one, 0.3, dtype))
            assert torch.equal(dx[:, s * k:(s + 1) * k],
                               cf.dropout_matmul_dx_plain(gs, w[s], one, 0.3, dtype))
    # the wrapper's CPU branch and its backward, through autograd
    xr, wr = x.clone().requires_grad_(not shared), w.clone().requires_grad_(True)
    out = cf.dropout_matmul_lanes(xr, wr, slot, 0.3, need_dx=not shared)
    assert torch.equal(out, cf.dropout_matmul_lanes_plain(x, w, SEEDS, 0.3))
    out.backward(g)
    for s, one in enumerate(SEEDS):
        xs = (x if shared else x[:, s * k:(s + 1) * k].contiguous()).requires_grad_(not shared)
        ws = w[s].clone().requires_grad_(True)
        cf.dropout_matmul(xs, ws, one, 0.3, need_dx=not shared).backward(
            g[:, s * m:(s + 1) * m].contiguous())
        assert torch.equal(wr.grad[s], ws.grad)
        if not shared:
            assert torch.equal(xr.grad[:, s * k:(s + 1) * k], xs.grad)


def test_laned_k10_refuses_ragged_batches_and_wrong_weights():
    x, w, _ = _k10_operands(False)
    with pytest.raises(ValueError, match="x must be"):
        cf.dropout_matmul_lanes_plain(x[:, :-1], w, SEEDS, 0.3)
    with pytest.raises(ValueError, match=r"w must be \[S, K, M\]"):
        cf.dropout_matmul_lanes_plain(x, w[0], SEEDS, 0.3)
    with pytest.raises(ValueError, match="x must be"):
        cf.dropout_matmul_lanes_plain(x, w[:, :-1], SEEDS, 0.3)
    with pytest.raises(ValueError, match="3 lanes need 3 seeds"):
        cf.dropout_matmul_lanes(x, w, SEEDS[:2], 0.3)
    with pytest.raises(ValueError, match="has no dX"):
        cf.dropout_matmul_lanes(_k10_operands(True)[0], w, SEEDS, 0.3)
    with pytest.raises(ValueError, match="rate"):
        cf.dropout_matmul_lanes(x, w, SEEDS, 0.0)


# ---------------------------------------------------------------------------
# (e) numpy models of the laned kernels' index arithmetic
# (csrc/dropout_matmul.cu: the *_lanes_kernel wrappers around the unlaned
# bodies, fwd_fma_shared_kernel, LaneArgs): lane s reads x at s·x_lane +
# r·ldx + c with its mask at its solo index r·k + c, writes its output at
# s·m + r·ldo + j and its dX at s·k + r·ldx + c, reads the joined g in place
# at s·m + r·(S·m) + j, and its dW partials at (s·splits + split)·k·m + c·m
# + j, which the lanes' reduction sums in split order. Values are small
# integers, so float64 sums are exact.


def _small(rng, *shape):
    return rng.integers(-3, 4, shape).astype(np.float64)


def _keep(seed, rate, n, k):
    return cd.keep_mask(seed, rate, (n, k), "cpu").numpy()


# the f32 forward's column tiles (fwd_col_tile picks one of these, at most
# 9 lanes' planes) and the unlaned f32 block's output columns
FWD_TILES = (32, 64, 128, 256)
FMA_COLS = 48


@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("lanes, k", [(1, 24), (3, 21), (4, 14), (8, 16)])
def test_laned_forward_and_dx_index_model(shared, lanes, k):
    """The f32 forward's blocks over a shared x (a 64-row tile × a tile of
    ``vt`` virtual columns across lanes, each lane's M padded to a multiple
    of 4; x's piece read once a block, for every lane the tile spans), at
    every column tile the kernel may take; over a joined x one lane a block
    (row tile, 48 output columns, lane); dX's (row tile, lane), the joined g
    read in place; at ``csrc/dropout_matmul.cu``'s strides."""
    rng = np.random.default_rng(lanes * 100 + k)
    n, m, rate, inv, rows_t = 150, 5, 0.3, 2.0, 64
    mp = 8
    x_lane, ldx, ldo = cf.lane_strides(k, m, lanes, shared)
    assert (x_lane, ldx, ldo) == ((0, k, lanes * m) if shared else (k, lanes * k, lanes * m))
    tiles = -(-n // rows_t)
    x_mem = _small(rng, n * ldx)  # the x buffer the kernels read
    w = _small(rng, lanes, k, m)
    g_mem = _small(rng, n * lanes * m)  # the joined g, read in place
    seeds = [7 + 1000 * s for s in range(lanes)]
    c = np.arange(k)
    g = g_mem.reshape(n, lanes * m)

    def check_out(out_mem):
        assert not np.isnan(out_mem).any()
        out = out_mem.reshape(n, lanes * m)
        for s in range(lanes):
            xs = x_mem.reshape(n, ldx)[:, s * x_lane:s * x_lane + k]
            keep = _keep(seeds[s], rate, n, k)
            np.testing.assert_array_equal(out[:, s * m:(s + 1) * m],
                                          np.where(keep, xs * inv, 0.0) @ w[s])

    if shared:
        for vt in FWD_TILES:
            planes = min(lanes, -(-vt // mp) + 1)
            col_tiles = -(-lanes * mp // vt)
            out_mem = np.full(n * ldo, np.nan)
            reads = np.zeros(n * ldx, np.int64)
            for t in range(tiles):
                r = np.arange(t * rows_t, min(n, (t + 1) * rows_t))[:, None]
                for ct in range(col_tiles):  # blockIdx.y: the column tile
                    v0 = ct * vt
                    vcols = min(vt, lanes * mp - v0)
                    lo, hi = v0 // mp, (v0 + vcols - 1) // mp
                    assert hi - lo + 1 <= planes
                    np.add.at(reads, (r * ldx + c).reshape(-1), 1)  # x's piece once a block
                    for s in range(lo, hi + 1):
                        keep = _keep(seeds[s], rate, n, k)[r, c]  # the solo index r·k + c
                        xm = np.where(keep, x_mem[r * ldx + c] * inv, 0.0)
                        # the lane's columns inside the tile (padding columns dropped)
                        j = np.arange(max(v0, s * mp) - s * mp,
                                      min(v0 + vcols, (s + 1) * mp) - s * mp)
                        j = j[j < m]
                        assert np.isnan(out_mem[s * m + r * ldo + j]).all()
                        out_mem[s * m + r * ldo + j] = xm @ w[s][:, j]
            assert (reads == col_tiles).all()
            check_out(out_mem)
        return
    out_mem = np.full(n * ldo, np.nan)
    reads = np.zeros(n * ldx, np.int64)
    dx_mem = np.full(n * lanes * k, np.nan)
    for t in range(tiles):
        r = np.arange(t * rows_t, min(n, (t + 1) * rows_t))[:, None]
        for s in range(lanes):  # blockIdx.z (forward), blockIdx.y (dX): the lane
            addr = s * x_lane + r * ldx + c
            keep = _keep(seeds[s], rate, n, k)[r, c]
            for j0 in range(0, m, FMA_COLS):  # blockIdx.y (forward): output columns
                np.add.at(reads, addr.reshape(-1), 1)
                j = np.arange(j0, min(m, j0 + FMA_COLS))
                assert np.isnan(out_mem[s * m + r * ldo + j]).all()
                out_mem[s * m + r * ldo + j] = np.where(keep, x_mem[addr] * inv, 0.0) @ w[s][:, j]
            j = np.arange(m)
            gs = g_mem[s * m + r * (lanes * m) + j]
            at = s * k + r * (lanes * k) + c
            assert np.isnan(dx_mem[at]).all()
            dx_mem[at] = np.where(keep, (gs @ w[s].T) * inv, 0.0)
    assert (reads == -(-m // FMA_COLS)).all()
    check_out(out_mem)
    for s in range(lanes):
        keep = _keep(seeds[s], rate, n, k)
        np.testing.assert_array_equal(
            dx_mem.reshape(n, lanes * k)[:, s * k:(s + 1) * k],
            np.where(keep, (g[:, s * m:(s + 1) * m] @ w[s].T) * inv, 0.0))


@pytest.mark.parametrize("lanes", [1, 2, 4, 8])
def test_laned_dw_index_model_and_split_plan(lanes):
    """dW's blocks, bf16 and f32 alike: (x columns, g columns, lane·splits
    + split), the joined g read in place; the lanes' split plan is the solo
    one, the reduction in split order."""
    rng = np.random.default_rng(lanes)
    n, k, m, rate, inv = 200, 20, 6, 0.3, 2.0
    blocks = 9
    splits, rows, z = cf.dw_lane_plan(n, k, m, lanes, blocks, torch.float32)
    # every lane takes the solo launch's plan, for every S
    assert (splits, rows) == cf.dw_splits(n, k, m, blocks, torch.float32) and z == splits * lanes
    for nn, kk, mm, bb in ((233472, 600, 41, 264), (2708, 1433, 72, 132), (2708, 72, 7, 132)):
        for dt in (torch.bfloat16, torch.float32):
            assert (cf.dw_lane_plan(nn, kk, mm, lanes, bb, dt)[:2]
                    == cf.dw_splits(nn, kk, mm, bb, dt))
    c = np.arange(k)
    seeds = [5 + s for s in range(lanes)]
    km = k * m
    for shared in (False, True):
        x = _small(rng, n, k if shared else lanes * k)
        g_mem = _small(rng, n * lanes * m)  # the joined g, read in place
        x_lane, ldx, _ = cf.lane_strides(k, m, lanes, shared and lanes > 1)
        ws = np.full(lanes * splits * km, np.nan)
        for bz in range(z):  # (lane, split) of each block
            lane, split = bz // splits, bz % splits
            r = np.arange(split * rows, min((split + 1) * rows, n))
            keep = _keep(seeds[lane], rate, n, k)[r[:, None], c]
            xm = np.where(keep, x.reshape(-1)[lane * x_lane + r[:, None] * ldx + c] * inv, 0.0)
            gs = g_mem[r[:, None] * (lanes * m) + lane * m + np.arange(m)]
            at = (lane * splits + split) * km + (c[:, None] * m + np.arange(m))
            assert np.isnan(ws[at]).all()
            ws[at] = xm.T @ gs
        assert not np.isnan(ws).any()
        # the lanes' reduction: e over lanes·k·m, lane e // km, in split order
        e = np.arange(lanes * km)
        lane = e // km
        dw = sum(ws[lane * splits * km + (e - lane * km) + i * km] for i in range(splits))
        g = g_mem.reshape(n, lanes * m)
        for s in range(lanes):
            keep = _keep(seeds[s], rate, n, k)
            xs = np.where(keep, (x if shared else x[:, s * k:(s + 1) * k]) * inv, 0.0)
            np.testing.assert_array_equal(dw.reshape(lanes, k, m)[s],
                                          xs.T @ g[:, s * m:(s + 1) * m])


# ---------------------------------------------------------------------------
# (g) the accuracy harness over the new families


@pytest.fixture
def data(tmp_path, monkeypatch):
    d = tmp_path / "data"
    d.mkdir()
    write_reference_dataset(str(d))
    monkeypatch.setenv("PGCN_DATA_DIR", str(d))
    monkeypatch.setenv("PGCN_CACHE_DIR", str(tmp_path / "cache"))
    return tmp_path / "out"


@pytest.mark.parametrize("sets", [["model=gat", "heads=2", "hidden_dims=4", "attn_dropout=0.3"],
                                  ["model=sage", "hidden_dims=8"]])
def test_accuracy_harness_runs_the_new_families(data, sets):
    out = str(data)
    tag = sets[0].split("=")[1]
    assert accuracy.main(["cora", "--seeds", "2", "--epochs", "6", "--set", *sets,
                          "--tag", tag, "--device", "cpu", "--out-dir", out]) == 0
    with open(os.path.join(out, f"accuracy_h100_{tag}.txt")) as f:
        (line,) = [ln for ln in f.read().splitlines() if ln]
    assert re.match(r"cora +val \S+±\S+ \(max \S+\) test \S+ \(max \S+\) epochs~\d+ \[2 seeds, ",
                    line), line
    row = accuracy.run_seeds("cora", 2, 6, device="cpu", overrides={
        key: parse_override(val) for key, val in (s.split("=") for s in sets)})
    assert row["lane0_equal_alone"] and row["n_seeds"] == 2
