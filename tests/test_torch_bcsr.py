"""parallel_gcn_tpu_torch BCSR tile SpMM (K3, K4) against the JAX package.

On the CPU the port's wrapper runs its plain PyTorch version; the JAX side
runs the Pallas kernels in TPU-interpret mode, as tests/test_bcsr.py does.
f32 tolerance: rtol 1e-5, atol 1e-6 (the same f32 products summed in
another order).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import parallel_gcn_tpu.ops.pallas_bcsr as pb
from parallel_gcn_tpu.data.graph import build_graph as jax_build_graph
from parallel_gcn_tpu.golden import csr_matvec_dense
from parallel_gcn_tpu_torch.data.graph import HostCSR, build_graph
from parallel_gcn_tpu_torch.data.synthetic import synthetic_csr
from parallel_gcn_tpu_torch.ops import cuda_bcsr as cb

torch.set_num_threads(1)

CPU = torch.device("cpu")
RTOL, ATOL = 1e-5, 1e-6
_JAX_DTYPE = {"float32": np.float32, "bfloat16": jnp.bfloat16, "int8": np.int8}


@pytest.fixture(autouse=True)
def interpret_mode():
    from jax.experimental.pallas import tpu as pltpu

    old = pb._INTERPRET[0]
    pb._INTERPRET[0] = pltpu.InterpretParams()
    yield
    pb._INTERPRET[0] = old


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel; no CPU mode)")
    return torch.device("cuda")


def _graphs(tile_dtype, tile_cols=0, n=380):
    csr = synthetic_csr(n, 6000, seed=1, n_communities=6, shuffle=False)
    kw = dict(bcsr=True, tile_size=128, tile_cols=tile_cols)
    tg = build_graph(csr, device=CPU, tile_dtype=tile_dtype, **kw)
    jg = jax_build_graph(csr, tile_dtype=_JAX_DTYPE[tile_dtype], **kw)
    return csr, tg, jg


def _x(n, f, seed=0):
    return np.random.default_rng(seed).standard_normal((n, f)).astype(np.float32)


@pytest.mark.parametrize("tile_dtype,tile_cols", [
    ("float32", 0), ("bfloat16", 0), ("int8", 0), ("int8", 256), ("float32", 256),
])
@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
def test_forward_matches_jax_interpret(tile_dtype, tile_cols, x_dtype):
    csr, tg, jg = _graphs(tile_dtype, tile_cols)
    xn = _x(tg.n_nodes, 41)
    xj = jnp.asarray(xn, _JAX_DTYPE[x_dtype])
    xt = torch.from_numpy(xn).to(getattr(torch, x_dtype))
    got = cb.bcsr_matmul(tg.bcsr, xt)
    want = np.asarray(pb.bcsr_matmul(jg.bcsr, xj))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    if tile_dtype != "bfloat16" and x_dtype == "float32":
        # an f32 or exact int8 pack with f32 x is Â·x
        np.testing.assert_allclose(got.numpy()[: csr.n_rows],
                                   csr_matvec_dense(csr, xn[: csr.n_rows]),
                                   rtol=1e-5, atol=2e-6)


def test_unscaled_int8_pack_matches_jax_pattern_product():
    """K3 on int8 tiles (no d): the plain multiplicity-pattern product."""
    _, tg, jg = _graphs("int8")
    xn = _x(tg.n_nodes, 33, seed=2)
    got = cb.bcsr_matmul(dataclasses.replace(tg.bcsr, sym_scale=None),
                         torch.from_numpy(xn))
    want = pb._bcsr_matmul(jg.bcsr.tiles, jg.bcsr.tile_rows, jg.bcsr.tile_cols,
                           jnp.asarray(xn), jg.bcsr.n_nodes)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("tile_dtype,tile_cols", [("float32", 0), ("int8", 0), ("int8", 256)])
def test_backward_matches_jax_grad(tile_dtype, tile_cols):
    _, tg, jg = _graphs(tile_dtype, tile_cols)
    xn, gn = _x(tg.n_nodes, 20, 3), _x(tg.n_nodes, 20, 4)
    _, vjp = jax.vjp(lambda x: pb.bcsr_matmul(jg.bcsr, x), jnp.asarray(xn))
    (want,) = vjp(jnp.asarray(gn))
    x = torch.from_numpy(xn).requires_grad_()
    cb.bcsr_matmul(tg.bcsr, x).backward(torch.from_numpy(gn))
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_uncovered_tile_rows_are_zero_and_every_row_scheduled():
    # nodes 0..127 only: tile-rows 1..3 of the 512-node padding get no edges
    csr = synthetic_csr(128, 800, seed=3, n_communities=2, shuffle=False)
    csr = HostCSR(csr.indptr, csr.indices, csr.values, 128, 128)
    tg = build_graph(csr, device=CPU, bcsr=True, tile_dtype="int8",
                     n_nodes_pad=512)
    sched = tg.bcsr.schedule
    assert sched.n_tile_rows == 4 and sorted(set(sched.seg_row.tolist())) == [0, 1, 2, 3]
    out = cb.bcsr_matmul(tg.bcsr, torch.ones(512, 7))
    assert (out[128:] == 0).all() and (out[:128] != 0).all()


def test_tile_schedule_splits_long_rows():
    counts = [20, 0, 3, 8, 9, 1]  # tiles per tile-row
    tile_rows = np.repeat(np.arange(len(counts)), counts).astype(np.int32)
    s = cb.tile_schedule(tile_rows, len(counts), segment_tiles=8)
    ptr, row, slot = (t.numpy() for t in (s.seg_tile_ptr, s.seg_row, s.seg_slot))
    # segments cover the tiles in order, each within one row, at most 8 tiles
    assert ptr[0] == 0 and ptr[-1] == len(tile_rows) and (np.diff(ptr) >= 0).all()
    assert (np.diff(ptr) <= 8).all()
    for i, r in enumerate(row):
        assert (tile_rows[ptr[i]:ptr[i + 1]] == r).all()
    assert row.tolist() == [0, 0, 0, 1, 2, 3, 4, 4, 5]  # every row, split rows 0 and 4
    assert slot.tolist() == [0, 1, 2, -1, -1, -1, 3, 4, -1]
    assert s.multi_row.tolist() == [0, 4] and s.multi_slot_ptr.tolist() == [0, 3, 5]
    assert s.n_slots == 5 and s.n_seg == 9


@pytest.mark.parametrize("f,dtype", [(41, torch.float32), (41, torch.bfloat16),
                                     (600, torch.bfloat16), (48, torch.float32)])
def test_pad_features_aligns_rows_with_zero_columns(f, dtype):
    x = torch.from_numpy(_x(10, f)).to(dtype)
    xp = cb.pad_features(x)
    f_pad = -(-f // cb.F_ALIGN) * cb.F_ALIGN
    assert xp.shape == (10, f_pad) and xp.dtype == torch.bfloat16 and xp.is_contiguous()
    assert (xp.shape[1] * xp.element_size()) % 16 == 0
    assert torch.equal(xp[:, :f], x.to(torch.bfloat16))  # x's rounding to bf16, once
    assert (xp[:, f:] == 0).all()


def test_pad_features_keeps_an_aligned_bf16_buffer():
    x = torch.from_numpy(_x(10, 48)).to(torch.bfloat16)
    assert cb.pad_features(x) is x
    assert cb.pad_features(x[:, :32]) is not x  # a strided view is copied


@pytest.mark.parametrize("tile_cols", [0, 256])
def test_packs_carry_an_spmm_schedule_of_short_segments(tile_cols):
    _, tg, _ = _graphs("int8", tile_cols)
    for pack in (tg.bcsr, cb.slab_pack(tg.bcsr.tiles.numpy(), tg.bcsr.tile_rows.numpy(),
                                       tg.bcsr.tile_cols.numpy(), tg.bcsr.n_rows,
                                       tg.bcsr.n_nodes, "int8", CPU)):
        s = pack.spmm_schedule
        ptr = s.seg_tile_ptr.numpy()
        assert (np.diff(ptr) <= cb.SPMM_SEGMENT_TILES).all() and ptr[-1] == pack.n_tiles
        rows = pack.tile_rows.numpy()
        for i, r in enumerate(s.seg_row.tolist()):
            assert (rows[ptr[i]:ptr[i + 1]] == r).all()
        assert s.n_tile_rows == pack.schedule.n_tile_rows
        assert sorted(set(s.seg_row.tolist())) == list(range(s.n_tile_rows))
        # the attention kernels keep their own, longer segments
        assert (np.diff(pack.schedule.seg_tile_ptr.numpy()) <= cb.SEGMENT_TILES).all()


def test_nonneg_tiles_flags_multiplicity_packs_only():
    _, tg, _ = _graphs("int8")
    assert tg.bcsr.nonneg_tiles
    assert not dataclasses.replace(tg.bcsr, tiles=tg.bcsr.tiles.neg()).nonneg_tiles
    assert not _graphs("float32")[1].bcsr.nonneg_tiles


def test_wrapper_rejects_bad_shapes():
    _, tg, _ = _graphs("int8")
    with pytest.raises(ValueError):
        cb.bcsr_matmul_impl(tg.bcsr, torch.ones(tg.n_nodes - 1, 4))
    with pytest.raises(ValueError, match="unsupported device"):
        cb.bcsr_matmul_impl(tg.bcsr, torch.empty(tg.n_nodes, 4, device="meta"))


@pytest.mark.parametrize("tile_dtype,scaled,f,body", [
    # the GCN's widths, solo and over 4 seed lanes: the pipe body
    *[(torch.int8, True, f, "pipe") for f in (41, 82, 164, 328)],
    # SAGE's and GIN's, solo and over 4 seed lanes: the wide body
    *[(torch.int8, True, f, "wide") for f in (600, 602, 2400, 2408)],
    # K3's value tiles and unscaled int8 packs (the mesh's slabs): the pipe body at every F
    *[(dt, False, f, "pipe") for dt in (torch.int8, torch.bfloat16, torch.float32)
      for f in (41, 328, 600, 2408)],
])
def test_spmm_body_dispatch(tile_dtype, scaled, f, body):
    assert cb.spmm_body(tile_dtype, scaled, f) == body


@pytest.mark.parametrize("f,dtype,in_place", [(600, torch.bfloat16, True),
                                              (602, torch.bfloat16, False),
                                              (600, torch.float32, False)])
def test_wide_features_reads_aligned_bf16_rows_in_place(f, dtype, in_place):
    x = torch.randn(10, f).to(dtype)
    got = cb.wide_features(x)
    assert (got is x) == in_place
    assert got.dtype == torch.bfloat16 and got.shape[1] % 8 == 0 and got.shape[1] >= f
    assert torch.equal(got[:, :f], x.to(torch.bfloat16))
    assert not got[:, f:].any()


def _wide_pack():
    """A 512×1024 int8 pack whose tile-rows have up to 6 tiles: split into
    segments (the workspace), 4 row blocks a tile (the wide body's clusters)."""
    csr = synthetic_csr(6000, 150000, seed=1, n_communities=6, shuffle=False)
    return build_graph(csr, device=CPU, tile_dtype="int8", bcsr=True, tile_size=512,
                       tile_cols=1024).bcsr


def test_build_bcsr_refuses_int8_without_scale():
    with pytest.raises(ValueError):
        cb.build_bcsr(np.array([0]), np.array([0]), np.array([1.0], np.float32),
                      128, dtype="int8")


@pytest.mark.cuda
def test_kernel_matches_plain_on_card(cuda_device):
    _, tg, _ = _graphs("int8", 256)
    pack = tg.bcsr.to(cuda_device)
    negated = dataclasses.replace(pack, tiles=pack.tiles.neg())  # the signed conversion
    for pk in (pack, dataclasses.replace(pack, sym_scale=None), negated,
               dataclasses.replace(negated, sym_scale=None)):
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn(pack.n_nodes, 41, device=cuda_device).to(dtype)
            torch.testing.assert_close(cb.bcsr_matmul_impl(pk, x),
                                       cb.bcsr_matmul_plain(pk, x),
                                       rtol=1e-4 if dtype == torch.float32 else 2e-3,
                                       atol=1e-5)
    # the f32 body over the live-entry index at the per-epoch and the set-up
    # widths (both warp shapes), and the dense f32 body: two runs bit-identical
    f32_values = _graphs("float32", 256)[1].bcsr.to(cuda_device)
    for pk in (pack, dataclasses.replace(pack, sym_scale=None), f32_values):
        for f in (41, 602):
            x = torch.randn(pack.n_nodes, f, device=cuda_device)
            ref = cb.bcsr_matmul_plain(pk, x)
            for dense in ((False, True) if pk is f32_values else (False,)):
                got = cb.bcsr_matmul_impl(pk, x, dense_tiles=dense)
                assert torch.equal(got, cb.bcsr_matmul_impl(pk, x, dense_tiles=dense))
                torch.testing.assert_close(got, ref, rtol=1e-4,
                                           atol=1e-5 * float(ref.abs().max()))
    with pytest.raises(ValueError, match="f32 value tiles"):  # int8 tiles walk their entries
        cb.bcsr_matmul_impl(pack, torch.randn(pack.n_nodes, 41, device=cuda_device),
                            dense_tiles=True)


@pytest.mark.cuda
def test_wide_body_matches_plain_on_card(cuda_device):
    """K4's wide body (SAGE's and GIN's widths and their 4 lanes') on the
    test pack (a CTA a cluster) and on a 512×1024 pack with split tile-rows,
    both the multiplicity pack and its negation: within the bf16 tolerance
    of the plain version, two runs bit-identical, each launch counted, and
    each lane of a 4·600-column call bit-equal to a 600-column call."""
    for pack in (_graphs("int8", 256)[1].bcsr.to(cuda_device), _wide_pack().to(cuda_device)):
        for pk in (pack, dataclasses.replace(pack, tiles=pack.tiles.neg())):
            for f in (600, 602, 2400):
                x = torch.randn(pk.n_nodes, f, device=cuda_device).to(torch.bfloat16)
                before = cb.launches["bcsr_scaled_wide"]
                got = cb.bcsr_matmul_impl(pk, x)
                assert cb.launches["bcsr_scaled_wide"] == before + 1
                torch.testing.assert_close(got, cb.bcsr_matmul_plain(pk, x), rtol=2e-3,
                                           atol=1e-5)
                assert torch.equal(got, cb.bcsr_matmul_impl(pk, x))
        x = torch.randn(pack.n_nodes, 4 * 600, device=cuda_device).to(torch.bfloat16)
        got = cb.bcsr_matmul_impl(pack, x)
        for s in range(4):
            lane = x[:, s * 600:(s + 1) * 600].contiguous()
            assert torch.equal(got[:, s * 600:(s + 1) * 600], cb.bcsr_matmul_impl(pack, lane))
    assert _wide_pack().spmm_schedule.n_slots > 0  # the workspace path was taken
