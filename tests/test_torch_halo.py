"""The ring and the adaptive push/pull halos of parallel_gcn_tpu_torch
against the JAX package.

- Partitions: every array of ``partition_graph(adaptive=True)``,
  ``partition_graph_ring`` and ``partition_graph_hybrid(adaptive=True)``
  (f32 square and 128×256 tiles, int8 pattern slabs) equals JAX's exactly,
  at 2 and 4 ranks, on the hub-heavy fixture of ``tests/test_parallel.py``
  (push pairs) and on ``random_graph`` (no push pair; with
  ``boundary_fallback`` the plain partition rebuilt from the CSR).
- Aggregations in gloo worlds of 2 and 4: ``graphsum_ring``,
  ``graphsum_dist_adaptive`` and ``graphsum_dist_hybrid_adaptive(_scaled)``
  forward and gradient on each rank's rows against the dense single-card
  Â·x and Âᵀ·c and against JAX's functions on its CPU mesh (Pallas in
  interpret mode), within 2e-5 (f32); one bf16 distance pinned.
- Training: ``fit_parallel`` at world 2 against JAX's at weight decay 0 (F2)
  for 5 epochs, eager and scan, within 1e-5 + 2e-5 relative (the GCN, SAGE and GIN over
  the ring, flat adaptive and int8 tile adaptive halos); the CLI under
  torchrun with each halo.

The hub graph builders (this module's and ``chip_smoke.py``'s) equal the
JAX fixture. JAX is imported inside the tests only: the gloo ranks import
this module and must not import JAX (``run_world`` checks).
"""

import warnings

import numpy as np
import pytest
import torch

from parallel_gcn_tpu_torch.data.graph import add_self_loops_csr, random_graph
from parallel_gcn_tpu_torch.data.parser import Dataset
from parallel_gcn_tpu_torch.parallel import partition as tp
from parallel_gcn_tpu_torch.parallel import train_parallel as tpl
from test_torch_parallel import CPU, mesh_config, run_world

torch.set_num_threads(1)
EPOCHS = 5


def hub_csr(n=1040, w=2, n_hubs=3):
    """``tests/test_parallel.py``'s power-law fixture: a band of width ``w``
    plus ``n_hubs`` nodes adjacent to every node. The hub owner pulls every
    remote neighbourhood but pushes only the hub rows."""
    lists = []
    for i in range(n):
        nb = {j for j in range(max(0, i - w), min(n, i + w + 1)) if j != i}
        nb |= set(range(n_hubs)) if i >= n_hubs else set(range(n)) - {i}
        lists.append(np.array(sorted(nb), dtype=np.int32))
    return add_self_loops_csr(lists)


def graph_of(name: str):
    return hub_csr() if name == "hub" else random_graph(2048, 8, seed=3)[0]


def hub_dataset(f=16, c=4, seed=0):
    """The hub fixture with 16 noisy features that carry the label and a
    random 50/25/25 split (``test_torch_parallel.mesh_dataset``'s)."""
    csr = hub_csr()
    n = csr.n_rows
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, c, n).astype(np.int32)
    feats = rng.standard_normal((n, f)).astype(np.float32)
    feats[np.arange(n), labels] += 2.0
    split = rng.choice([1, 2, 3], size=n, p=[0.5, 0.25, 0.25]).astype(np.int32)
    return Dataset(name="hub-test", graph=csr, feature_csr=None, features=feats,
                   labels=labels, split=split, n_nodes=n, input_dim=f, output_dim=c)


def datasets(name: str):
    from test_torch_parallel import mesh_dataset

    return hub_dataset() if name == "hub" else mesh_dataset()


# layout name -> partition of a CSR at ``world`` ranks
LAYOUTS = {
    "ring": lambda csr, w: tp.partition_graph_ring(csr, w),
    "flat adaptive": lambda csr, w: tp.partition_graph(csr, w, adaptive=True),
    "hybrid adaptive": lambda csr, w: tp.partition_graph_hybrid(
        csr, w, tile_r=128, tile_c=128, min_tile_nnz=8, adaptive=True),
    "hybrid int8 adaptive": lambda csr, w: tp.partition_graph_hybrid(
        csr, w, tile_r=128, tile_c=256, tile_dtype="int8", min_tile_nnz=8, adaptive=True),
}


def _dense(csr, sg):
    """Â padded to the partition's rows, in its node order."""
    n_pad = sg.n_nodes_pad
    a = np.zeros((n_pad, n_pad), np.float64)
    a[: csr.n_rows, : csr.n_rows] = csr.to_dense()
    perm = getattr(sg, "node_perm", None)
    return a if perm is None else a[perm][:, perm]


def _inputs(n_pad: int, f: int = 16):
    rng = np.random.default_rng(0)  # the same global arrays on every rank
    return (rng.standard_normal((n_pad, f)).astype(np.float32),
            rng.standard_normal((n_pad, f)).astype(np.float32))


def _halo_aggregations(rank, world, dtype: str):
    """Each layout's Â·x on this rank's rows and the gradient of Σ c ⊙ Â·x,
    on the hub fixture, in ``dtype``."""
    csr = hub_csr()
    out = {}
    for name, make in LAYOUTS.items():
        sg = make(csr, world)
        graph = tpl.rank_graph(sg, rank, CPU)
        x, c = _inputs(sg.n_nodes_pad)
        rows = slice(rank * sg.n_local, (rank + 1) * sg.n_local)
        xl = torch.from_numpy(x[rows]).to(getattr(torch, dtype)).requires_grad_()
        y = graph.aggregate(xl)
        (y.float() * torch.from_numpy(c[rows])).sum().backward()
        out[name] = (y.detach().float().numpy(), xl.grad.float().numpy(),
                     tpl.halo_of(sg), graph.push is not None)
    return out


def _jax_aggregate(sg_jax, world: int, x, c, dtype=np.float32):
    """JAX's mesh Â·x (``make_preagg_fn``, its ``_aggregate``) and the
    gradient of Σ c ⊙ Â·x on a CPU mesh of ``world`` devices."""
    import jax
    import jax.numpy as jnp

    from parallel_gcn_tpu.config import Config as JaxConfig
    from parallel_gcn_tpu.parallel.train_parallel import _graph_specs, make_mesh, make_preagg_fn

    fn = make_preagg_fn(JaxConfig(), make_mesh(world), sg_jax)
    _, arrays = _graph_specs(sg_jax)
    xj = jnp.asarray(x).astype(dtype)
    y = fn(xj, *arrays)
    grad = jax.grad(lambda v: jnp.sum(fn(v, *arrays).astype(jnp.float32) * c))(xj)
    return np.asarray(y.astype(jnp.float32)), np.asarray(grad.astype(jnp.float32))


def _jax_partition(name: str, csr, world: int):
    from parallel_gcn_tpu.parallel import partition as jp
    from test_torch_partition import _jax_csr

    jc = _jax_csr(csr)
    return {
        "ring": lambda: jp.partition_graph_ring(jc, world),
        "flat adaptive": lambda: jp.partition_graph(jc, world, adaptive=True),
        "hybrid adaptive": lambda: jp.partition_graph_hybrid(
            jc, world, tile_r=128, tile_c=128, min_tile_nnz=8, adaptive=True),
        "hybrid int8 adaptive": lambda: jp.partition_graph_hybrid(
            jc, world, tile_r=128, tile_c=256, tile_dtype=np.dtype(np.int8), min_tile_nnz=8,
            adaptive=True),
    }[name]()


@pytest.fixture
def interpret_mode():
    import parallel_gcn_tpu.ops.pallas_bcsr as pb

    old = pb._INTERPRET[0]
    pb._INTERPRET[0] = True
    yield
    pb._INTERPRET[0] = old


# ---------------------------------------------------------------------------
# partitions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["hub", "random"])
@pytest.mark.parametrize("n_dev", [2, 4])
@pytest.mark.parametrize("fallback", [False, True])
def test_adaptive_and_ring_partitions_equal_jax(name, n_dev, fallback):
    from parallel_gcn_tpu.parallel import partition as jp
    from test_torch_partition import _assert_same, _jax_csr

    csr = graph_of(name)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        got = tp.partition_graph(csr, n_dev, adaptive=True, boundary_fallback=fallback)
        ref = jp.partition_graph(_jax_csr(csr), n_dev, adaptive=True,
                                 boundary_fallback=fallback)
    _assert_same(got, ref)
    # the hub graph pushes; the random graph has no push pair, and with the
    # fallback its buffer does not pay off: the plain partition, rebuilt
    assert (got.push_slab > 0) == (name == "hub")
    if name == "random":
        assert (got.send_idx is None) == fallback
    if not fallback:
        ring = tp.partition_graph_ring(csr, n_dev)
        _assert_same(ring, jp.partition_graph_ring(_jax_csr(csr), n_dev))
        assert ring.ring and ring.row_local.shape[:2] == (n_dev, n_dev)
        assert (ring.val != 0).sum() == csr.nnz


@pytest.mark.parametrize("name", ["hub", "random"])
@pytest.mark.parametrize("n_dev", [2, 4])
@pytest.mark.parametrize("tile_c,dtype", [(128, "float32"), (256, "float32"),
                                          (256, "int8")])
def test_hybrid_adaptive_partition_equals_jax(name, n_dev, tile_c, dtype):
    from parallel_gcn_tpu.parallel import partition as jp
    from test_torch_partition import _assert_same, _jax_csr

    csr = graph_of(name)
    kw = dict(tile_r=128, tile_c=tile_c, min_tile_nnz=8, adaptive=True,
              boundary_fallback=True)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        got = tp.partition_graph_hybrid(csr, n_dev, tile_dtype=dtype, **kw)
        ref = jp.partition_graph_hybrid(_jax_csr(csr), n_dev,
                                        tile_dtype=np.dtype(getattr(np, dtype)), **kw)
    _assert_same(got, ref)
    assert (got.push_slab > 0) == (name == "hub")
    if got.push_slab:
        # every live entry lands once: pulled slab + residual + push tiles + push residual
        live = ((got.tiles != 0).sum() + (got.res_val != 0).sum() + (got.ptiles != 0).sum()
                + (got.pval != 0).sum())
        assert live == csr.nnz
        with pytest.raises(ValueError, match="pull-only"):
            tp.gat_mesh_pack(got)


# ---------------------------------------------------------------------------
# aggregations in gloo worlds
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("world", [2, 4])
def test_halo_aggregations_match_single_card_and_jax(tmp_path, world, interpret_mode):
    """Forward and gradient within 2e-5 of the dense Â·x, Âᵀ·c and of JAX's
    mesh functions (f32); the adaptive layouts push on the hub fixture."""
    csr = hub_csr()
    results = run_world(_halo_aggregations, world, tmp_path, "float32")
    for name, make in LAYOUTS.items():
        sg = make(csr, world)
        a = _dense(csr, sg)
        x, c = _inputs(sg.n_nodes_pad)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            jy, jg = _jax_aggregate(_jax_partition(name, csr, world), world, x, c)
        for rank, res in enumerate(results):
            y, g, halo, pushes = res[name]
            rows = slice(rank * sg.n_local, (rank + 1) * sg.n_local)
            assert halo == ("ring" if name == "ring" else "adaptive"), (name, halo)
            assert pushes == (name != "ring"), name
            for got, ref, what in ((y, (a @ x)[rows], "forward"), (g, (a.T @ c)[rows], "grad"),
                                   (y, jy[rows], "forward vs JAX"),
                                   (g, jg[rows], "grad vs JAX")):
                np.testing.assert_allclose(got, ref, rtol=2e-5, atol=2e-5,
                                           err_msg=f"{name} rank {rank} {what}")


def test_bf16_adaptive_distance_from_jax_is_pinned(tmp_path, interpret_mode):
    """bf16 at world 2: the port and JAX round the push partials (and each
    ring step's sum) to bf16 before the exchange; the port's ordered sums
    then round each output once where JAX rounds every product and partial
    sum. Measured on the hub fixture (hub rows of 1040 terms), as a share
    of each row's Σ|Â_ij x_j| from the f64 product: the port at most
    0.006457 (ring: a step's sum and the accumulator's add each round) /
    0.003525 (adaptive), JAX 0.010523 / 0.009201, the two apart by 0.013865
    / 0.010291; the test holds the port within 0.008 and the two within
    0.016."""
    import ml_dtypes

    csr = hub_csr()
    results = run_world(_halo_aggregations, 2, tmp_path, "bfloat16")
    for name in ("ring", "flat adaptive"):
        sg = LAYOUTS[name](csr, 2)
        x, c = _inputs(sg.n_nodes_pad)
        xb = x.astype(ml_dtypes.bfloat16).astype(np.float64)
        a = _dense(csr, sg)
        exact = a @ xb
        scale = np.abs(a) @ np.abs(xb) + 1e-30
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            jy, _ = _jax_aggregate(_jax_partition(name, csr, 2), 2, x, c,
                                   dtype=ml_dtypes.bfloat16)
        port = np.concatenate([r[name][0] for r in results])
        port_err = float((np.abs(port - exact) / scale).max())
        jax_err = float((np.abs(jy - exact) / scale).max())
        assert port_err <= 0.008, (name, port_err, jax_err)
        assert float((np.abs(port - jy) / scale).max()) <= 0.016, (name, port_err, jax_err)


# ---------------------------------------------------------------------------
# training against JAX fit_parallel
# ---------------------------------------------------------------------------

# name -> (dataset, route, mesh_config keywords)
FIT_RUNS = {
    "gcn ring": ("random", "gcn-flat-ring", {}),
    "gcn flat adaptive": ("hub", "gcn-flat-adaptive", {}),
    "sage ring": ("random", "sage-flat-ring", {}),
    "gcn hybrid int8 adaptive": ("hub", "gcn-hybrid-adaptive", {}),
    "gin flat adaptive": ("hub", "gin-flat-adaptive", {}),
    "sage hybrid int8 adaptive": ("hub", "sage-hybrid-adaptive", {}),
}


def fit_halo_routes(rank, world, runs, epochs):
    """``fit_parallel`` of each run (name -> (dataset, route, weight decay,
    initial weights, ``mesh_config`` keywords)) on this rank: (history,
    test_acc, halo, push_slab)."""
    out = {}
    for name, (data, route, wd, w, kw) in runs.items():
        cfg = mesh_config(route, weight_decay=wd, **{"epochs": epochs, **kw})
        ds = datasets(data)
        res = tpl.fit_parallel(cfg, ds, n_devices=world, device="cpu",
                               weights=[torch.from_numpy(a) for a in w])
        sg = tpl.partition_for(cfg, ds, world, cfg.tpu.halo)
        out[name] = (res.history, res.test_acc, tpl.halo_of(sg), sg.push_slab)
    return out


@pytest.mark.parametrize("mode", ["eager", "scan"])
def test_fit_parallel_world_2_ring_and_adaptive_match_jax(tmp_path, mode, interpret_mode):
    """5 epochs at world 2 against JAX ``fit_parallel`` on 2 devices at
    weight decay 0 (F2): histories within 1e-5 + 2e-5 relative, test_acc
    equal. The hub runs push (flat and int8 tile slabs)."""
    import jax

    from parallel_gcn_tpu.parallel.train_parallel import fit_parallel as jax_fit_parallel
    from parallel_gcn_tpu_torch.convert import params_from_numpy
    from test_torch_parallel_train import _jax_config, _jax_dataset, _jax_init

    refs, runs = {}, {}
    for name, (data, route, kw) in FIT_RUNS.items():
        ds = datasets(data)
        jcfg = _jax_config(mesh_config(route, epochs=EPOCHS, weight_decay=0.0, mode=mode,
                                       **kw))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            refs[name] = jax_fit_parallel(jcfg, _jax_dataset(ds), n_devices=2)
        w = [t.numpy() for t in params_from_numpy(jax.tree.map(np.asarray,
                                                                _jax_init(jcfg, ds)))]
        runs[name] = (data, route, 0.0, w, {"mode": mode, **kw})
    results = run_world(fit_halo_routes, 2, tmp_path, runs, EPOCHS)
    for name, ref in refs.items():
        for rank, got in enumerate(results):
            hist, test_acc, halo, push_slab = got[name]
            assert halo == ("ring" if "ring" in name else "adaptive"), (name, halo)
            assert (push_slab > 0) == ("adaptive" in name), name
            assert hist.shape == np.asarray(ref.history).shape, f"{name} rank {rank}"
            # rtol: GIN-0's losses on the hub graph are 30-280, where one
            # float32 ulp is up to 3e-5 and 5 Adam steps amplify a few
            np.testing.assert_allclose(hist, np.asarray(ref.history), rtol=2e-5, atol=1e-5,
                                       err_msg=f"{name} rank {rank}")
            assert test_acc == pytest.approx(ref.test_acc, abs=1e-7), name
        assert hist[-1, 0] < hist[0, 0], name


@pytest.mark.parametrize("halo", ["ring", "adaptive"])
def test_world_of_one_equals_boundary_layout(halo):
    """At one rank the ring is one slab and the adaptive halo has no push
    pair: the same run, the same collectives, as halo=boundary."""
    from parallel_gcn_tpu_torch.parallel import collectives
    from test_torch_parallel import mesh_dataset

    ds = mesh_dataset()
    runs = {}
    for h in (halo, "boundary"):
        cfg = mesh_config(f"gcn-flat-{h}", epochs=3, dropouts=(0.3, 0.3))
        for k in collectives.counts:
            collectives.counts[k] = 0
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            res = tpl.fit_parallel(cfg, ds, n_devices=1, device="cpu")
        runs[h] = (res.history, dict(collectives.counts))
    np.testing.assert_allclose(runs[halo][0], runs["boundary"][0], rtol=0, atol=1e-6)
    assert runs[halo][1]["ppermute"] == 0
    assert runs[halo][1]["all_reduce"] == runs["boundary"][1]["all_reduce"]


@pytest.mark.parametrize("args", [
    ["model=gin", "gin_eps=0", "backend=segment", "halo=ring"],
    ["model=sage", "halo=adaptive", "tile_size=128", "tile_cols=256", "min_tile_nnz=40"],
])
def test_cli_trains_each_halo_in_a_torchrun_world_on_cpu(tmp_path, args):
    import os
    import subprocess
    import sys

    from test_torch_parallel import REPO

    env = dict(os.environ, PGCN_CACHE_DIR=str(tmp_path), CUDA_VISIBLE_DEVICES="",
               OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node=2",
         "-m", "parallel_gcn_tpu_torch", "synth-medium", "device=cpu", "n_devices=2",
         "epochs=2", "hidden_dims=8", *args],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    halo = args[-1].split("=")[1] if "ring" in args[-1] else None
    assert f"mesh: 2 rank(s), halo={halo or ''}" in proc.stdout, proc.stdout
    assert "epoch=2 " in proc.stdout and "epochs_run=2" in proc.stdout


def test_hub_graphs_equal_the_jax_fixture():
    """``chip_smoke.hub_csr`` (vectorized, built at 233,472 nodes there) and
    this module's ``hub_csr`` equal ``tests/test_parallel.py``'s
    ``_hub_csr`` array for array."""
    import chip_smoke
    from test_parallel import _hub_csr as jax_hub_csr

    for n in (240, 1040):
        want = jax_hub_csr(n=n)
        for got in (hub_csr(n), chip_smoke.hub_csr(n)):
            for name in ("indptr", "indices", "values"):
                np.testing.assert_array_equal(getattr(got, name), getattr(want, name))
