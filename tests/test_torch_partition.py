"""parallel_gcn_tpu_torch.parallel.partition against the JAX package.

Every partition function on the same host CSR, for 1, 2 and 4 ranks, with
the boundary halo on and off, slab balancing, int8 pattern slabs and the
mesh GAT's packs: every array equals the JAX package's exactly (bf16 tiles
compared as their float32 values). The ring and adaptive layouts are in
``tests/test_torch_halo.py``.
"""

import warnings

import numpy as np
import pytest
import torch

from parallel_gcn_tpu.data.graph import HostCSR as JaxHostCSR
from parallel_gcn_tpu.parallel import partition as jp
from parallel_gcn_tpu_torch.data.graph import add_self_loops_csr, random_graph
from parallel_gcn_tpu_torch.parallel import partition as tp

torch.set_num_threads(1)


def _jax_csr(csr):
    return JaxHostCSR(indptr=csr.indptr, indices=csr.indices, values=csr.values,
                      n_rows=csr.n_rows, n_cols=csr.n_cols, sym_scale=csr.sym_scale)


def _hub_csr(n=2048, seed=5):
    """A random graph plus a dense community on the first 384 nodes, so the
    first rank's slab holds most tiles and balancing fires."""
    rng = np.random.default_rng(seed)
    _, nbrs = random_graph(n, 6, seed=seed)
    half = [set(map(int, nb)) for nb in nbrs]
    for i in range(384):
        for j in rng.choice(384, 40, replace=False):
            if int(j) != i:
                half[i].add(int(j))
                half[int(j)].add(i)
    return add_self_loops_csr([np.array(sorted(h), np.int32) for h in half])


@pytest.fixture(scope="module")
def graphs():
    return {"random": random_graph(2048, 8, seed=3)[0], "hub": _hub_csr()}


def _assert_same(got, ref):
    """Every field of the port's dataclass equals the JAX one's (the JAX
    dataclasses also carry the unported ring/adaptive fields)."""
    for name in got.__dataclass_fields__:
        if name == "tile_dtype":  # the port's own: the tiles' device dtype
            continue
        a, b = getattr(got, name), getattr(ref, name)
        if b is None or isinstance(b, (bool, int, float)):
            assert a == b, (name, a, b)
            continue
        b = np.asarray(b)
        if b.dtype.name == "bfloat16":
            b = b.astype(np.float32)
        assert a is not None, name
        assert a.shape == b.shape, (name, a.shape, b.shape)
        np.testing.assert_array_equal(a, b, err_msg=name)
    for name in ("n_nodes_pad", "n_buf"):
        assert getattr(got, name) == getattr(ref, name), name


@pytest.mark.parametrize("n_dev", [1, 2, 4])
@pytest.mark.parametrize("boundary", [False, True])
def test_partition_graph_equals_jax(graphs, n_dev, boundary):
    csr = graphs["random"]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        got = tp.partition_graph(csr, n_dev, boundary=boundary)
        ref = jp.partition_graph(_jax_csr(csr), n_dev, boundary=boundary)
        fb = tp.partition_graph(csr, n_dev, boundary=boundary, boundary_fallback=True)
        fb_ref = jp.partition_graph(_jax_csr(csr), n_dev, boundary=boundary,
                                    boundary_fallback=True)
    _assert_same(got, ref)
    _assert_same(fb, fb_ref)
    assert (got.val != 0).sum() == csr.nnz


HYBRID_CASES = [
    # (graph, n_dev, tile_c, dtype, boundary, balance)
    ("random", 1, 128, "float32", True, True),
    ("random", 2, 256, "float32", False, False),
    ("random", 4, 128, "int8", True, False),
    ("hub", 4, 128, "float32", True, True),
    ("hub", 2, 256, "int8", True, True),
    ("hub", 4, 256, "bfloat16", False, True),
]


@pytest.mark.parametrize("name,n_dev,tile_c,dtype,boundary,balance", HYBRID_CASES)
def test_partition_graph_hybrid_and_gat_pack_equal_jax(graphs, name, n_dev, tile_c,
                                                       dtype, boundary, balance):
    csr = graphs[name]
    # the hub graph packs only its dense community's tiles
    kw = dict(tile_r=128, tile_c=tile_c, min_tile_nnz=8 if name == "random" else 200,
              boundary=boundary,
              balance=balance, boundary_fallback=n_dev == 1)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        got = tp.partition_graph_hybrid(csr, n_dev, tile_dtype=dtype, **kw)
        jdt = {"float32": np.float32, "int8": np.int8}.get(dtype)
        if jdt is None:
            import jax.numpy as jnp

            jdt = jnp.bfloat16
        ref = jp.partition_graph_hybrid(_jax_csr(csr), n_dev, tile_dtype=np.dtype(jdt), **kw)
    _assert_same(got, ref)
    assert got.tile_dtype == dtype
    if (name, n_dev, tile_c) == ("hub", 4, 128):
        assert got.node_perm is not None  # the balancing path ran
    # the mesh GAT's packs, with wide tiles view-split to 256 columns
    _assert_same(tp.gat_mesh_pack(got, max_tile_c=128), jp.gat_mesh_pack(ref, max_tile_c=128))
    _assert_same(tp.gat_mesh_pack(got), jp.gat_mesh_pack(ref))


def test_unported_layouts_raise(graphs):
    """The adaptive layouts, refused until they were ported, now build and
    equal JAX's (every case: ``tests/test_torch_halo.py``); the hub graph's
    tile slabs then push, and the mesh GAT's packs refuse them."""
    from test_torch_halo import hub_csr

    csr = graphs["random"]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        _assert_same(tp.partition_graph(csr, 2, adaptive=True),
                     jp.partition_graph(_jax_csr(csr), 2, adaptive=True))
        hub = hub_csr()
        got = tp.partition_graph_hybrid(hub, 2, min_tile_nnz=8, adaptive=True)
        _assert_same(got, jp.partition_graph_hybrid(_jax_csr(hub), 2, min_tile_nnz=8,
                                                    adaptive=True))
    assert got.push_slab > 0
    with pytest.raises(ValueError, match="pull-only"):
        tp.gat_mesh_pack(got)
