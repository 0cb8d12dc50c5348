"""The f32 tile SpMM body's live-entry index (``cuda_bcsr.spmm_index``) and
a walk over it in the kernel's order, against the pack, the plain version
and the JAX package.

``csrc/bcsr_spmm.cu``'s ``spmm_walk_kernel`` reads the index: each CTA walks
the chunks of its segment's tiles, each warp the contiguous run of entries
of its 16·GPW rows in a chunk, and sums every row in the order it meets the
row's entries; a split tile-row's segments are summed in segment order
(``reduce_segments_kernel``). ``_walk`` below is a model of that order in
numpy (one fused multiply-add an entry, f32), so a change to the index's
order or to the kernel's walk must be mirrored here. The JAX side runs the
Pallas kernels in TPU-interpret mode, as tests/test_bcsr.py does. f32
tolerance: rtol 1e-5, atol 1e-6 (the same f32 products summed in another
order), as tests/test_torch_bcsr.py.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import parallel_gcn_tpu.ops.pallas_bcsr as pb
from parallel_gcn_tpu.data.graph import build_graph as jax_build_graph
from parallel_gcn_tpu_torch.data.graph import HostCSR, build_graph
from parallel_gcn_tpu_torch.data.synthetic import synthetic_csr
from parallel_gcn_tpu_torch.ops import cuda_bcsr as cb

torch.set_num_threads(1)

CPU = torch.device("cpu")
RTOL, ATOL = 1e-5, 1e-6
_JAX_DTYPE = {"float32": np.float32, "int8": np.int8}


@pytest.fixture(autouse=True)
def interpret_mode():
    from jax.experimental.pallas import tpu as pltpu

    old = pb._INTERPRET[0]
    pb._INTERPRET[0] = pltpu.InterpretParams()
    yield
    pb._INTERPRET[0] = old


def _graphs(tile_dtype, tile_cols=0, n=380, uncovered=False):
    csr = synthetic_csr(n, 6000, seed=1, n_communities=6, shuffle=False)
    kw = dict(bcsr=True, tile_size=128, tile_cols=tile_cols)
    if uncovered:  # the nodes past n get no edges: whole tile-rows without entries
        csr = HostCSR(csr.indptr, csr.indices, csr.values, n, n)
        kw["n_nodes_pad"] = 4 * 128
    tg = build_graph(csr, device=CPU, tile_dtype=tile_dtype, **kw)
    jg = jax_build_graph(csr, tile_dtype=_JAX_DTYPE[tile_dtype], **kw)
    return tg, jg


def _x(n, f, seed=0):
    return np.random.default_rng(seed).standard_normal((n, f)).astype(np.float32)


def _decode(pack, idx):
    """Every entry as numpy (tile, chunk, row, column in the tile, value);
    also checks each entry's row against the position its offsets give."""
    nch, tr = pack.tile_c // cb.SPMM_CHUNK, pack.tile_r
    rptr = idx.rptr.numpy().astype(np.int64)
    e = np.arange(idx.ent.shape[0])
    key = np.searchsorted(rptr, e, side="right") - 1
    packed = idx.ent[:, 1].numpy()
    ch = (key // tr) % nch
    assert ((packed >> 16) == cb.spmm_row(key % tr, tr)).all()
    return (key // (nch * tr), ch, packed >> 16,
            ch * cb.SPMM_CHUNK + (packed & 0xFFFF), idx.ent[:, 0].numpy().view(np.float32))


def _want_value(pack, t, r, c):
    """The kernel's f32 operand: the tile's value, or fl(fl(k·d_c)·d_r)."""
    k = pack.tiles[t, r, c].float()
    if pack.sym_scale is None:
        return k.numpy()
    d = pack.sym_scale
    dc = d[pack.tile_cols[t].long() * pack.tile_c + c]
    dr = d[pack.tile_rows[t].long() * pack.tile_r + r]
    return ((k * dc) * dr).numpy()


def _walk(pack, idx, x, gpw):
    """out = A·x summed as the kernel sums it: segments of ``spmm_schedule``
    (tiles in order, chunks in order, each warp's 16·gpw row positions,
    each row over its run of entries), f32 fused multiply-adds; split
    tile-rows' segments summed in segment order from 0. Also returns each
    row's (tile, column) order."""
    tr, F = pack.tile_r, x.shape[1]
    nch = pack.tile_c // cb.SPMM_CHUNK
    rptr = idx.rptr.numpy()
    ent = idx.ent.numpy()
    vals = ent[:, 0].view(np.float32)
    sched = pack.spmm_schedule
    seg_ptr, seg_row = sched.seg_tile_ptr.numpy(), sched.seg_row.numpy()
    tile_cols = pack.tile_cols.numpy().astype(np.int64)
    partial = {}  # tile-row -> its segments' sums, in segment order
    order = {}
    for s in range(sched.n_seg):
        acc = np.zeros((tr, F), np.float32)
        for t in range(seg_ptr[s], seg_ptr[s + 1]):
            for ch in range(nch):
                for w0 in range(0, tr, 16 * gpw):  # one warp's row positions
                    i = (t * nch + ch) * tr + w0
                    for e in range(rptr[i], rptr[i + 16 * gpw]):
                        r, c = ent[e, 1] >> 16, ent[e, 1] & 0xFFFF
                        col = tile_cols[t] * pack.tile_c + ch * cb.SPMM_CHUNK + c
                        # fl(v·x + acc): the product is exact in f64
                        acc[r] = (np.float64(vals[e]) * x[col] + acc[r]).astype(np.float32)
                        order.setdefault(int(seg_row[s]) * tr + int(r), []).append(
                            (t, ch * cb.SPMM_CHUNK + int(c)))
        partial.setdefault(int(seg_row[s]), []).append(acc)
    out = np.zeros((pack.n_rows, F), np.float32)
    for row, parts in partial.items():
        total = parts[0]
        if len(parts) > 1:
            total = np.zeros((tr, F), np.float32)
            for p in parts:
                total = total + p
        out[row * tr:(row + 1) * tr] = total
    return out, order


CASES = {
    # (tile dtype, tile_cols, scaled, tiles a segment, uncovered tile-rows);
    # "slab": the pack as a mesh slab (all-zero tiles dropped, no d), where
    # an uncovered tile-row has no tiles at all
    "int8 scaled": ("int8", 0, True, None, False),
    "int8 scaled 128x256": ("int8", 256, True, None, False),
    "int8 pattern": ("int8", 0, False, None, False),
    "int8 scaled split rows": ("int8", 0, True, 1, False),
    "int8 pattern 128x256 split rows": ("int8", 256, False, 1, False),
    "int8 scaled uncovered rows": ("int8", 0, True, None, True),
    "int8 slab uncovered rows": ("int8", 0, "slab", None, True),
    "f32 values": ("float32", 0, False, None, False),
    "f32 values 128x256 split rows": ("float32", 256, False, 1, False),
}


def _pack(case):
    tile_dtype, tile_cols, scaled, seg_tiles, uncovered = CASES[case]
    tg, jg = _graphs(tile_dtype, tile_cols, uncovered=uncovered)
    pack = tg.bcsr
    if scaled == "slab":
        pack = cb.slab_pack(pack.tiles.numpy(), pack.tile_rows.numpy(), pack.tile_cols.numpy(),
                            pack.n_rows, pack.n_nodes, "int8", CPU)
        seg_ptr = pack.spmm_schedule.seg_tile_ptr
        assert (seg_ptr[1:] == seg_ptr[:-1]).any()  # a tile-row without tiles
    elif not scaled:
        pack = dataclasses.replace(pack, sym_scale=None)
    if seg_tiles:
        pack = dataclasses.replace(pack, spmm_schedule=cb.tile_schedule(
            pack.tile_rows.numpy(), pack.n_tile_rows, seg_tiles))
        assert pack.spmm_schedule.n_slots > 0  # some tile-rows are split
    return pack, jg


@pytest.mark.parametrize("case", list(CASES))
def test_index_lists_exactly_the_live_entries_in_walk_order(case):
    pack, _ = _pack(case)
    idx = pack.spmm_index
    assert idx is pack.spmm_index  # built once a pack
    assert idx.ent.dtype == torch.int32 and idx.ent.shape[1] == 2 and idx.ent.is_contiguous()
    nch = pack.tile_c // cb.SPMM_CHUNK
    assert idx.rptr.shape == (pack.n_tiles * nch * pack.tile_r + 1,) and idx.rptr[0] == 0
    t, ch, r, c, v = _decode(pack, idx)
    # (tile, chunk, row position, column) strictly ascending: the order the
    # warps walk
    q = cb.spmm_position(r, pack.tile_r)
    key = ((t * nch + ch) * pack.tile_r + q) * pack.tile_c + c
    assert (np.diff(key) > 0).all()
    assert (c // cb.SPMM_CHUNK == ch).all()
    # each position's run holds its row's entries only
    assert (np.searchsorted(idx.rptr.numpy(), np.arange(len(t)), side="right") - 1
            == (t * nch + ch) * pack.tile_r + q).all()
    # exactly the nonzero entries, with the kernel's f32 operands bit for bit
    lt, lr, lc = (pack.tiles != 0).nonzero(as_tuple=True)
    want = (lt.numpy() * pack.tile_r + lr.numpy()) * pack.tile_c + lc.numpy()
    np.testing.assert_array_equal(np.sort((t * pack.tile_r + r) * pack.tile_c + c), want)
    np.testing.assert_array_equal(v.view(np.int32),
                                  _want_value(pack, torch.from_numpy(t), torch.from_numpy(r),
                                              torch.from_numpy(c)).view(np.int32))


@pytest.mark.parametrize("case", list(CASES))
def test_walk_sums_each_row_in_tile_then_column_order(case):
    pack, _ = _pack(case)
    _, order = _walk(pack, pack.spmm_index, _x(pack.n_nodes, 3), gpw=2)
    rows = pack.tile_rows.numpy()
    for row, seq in order.items():
        # the row's tiles in pack order, each tile's live columns ascending
        tiles = np.flatnonzero(rows == row // pack.tile_r)
        want = [(int(t), int(c)) for t in tiles
                for c in np.flatnonzero(pack.tiles[t, row % pack.tile_r].numpy() != 0)]
        assert seq == want
    assert sum(map(len, order.values())) == pack.spmm_index.ent.shape[0]


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("gpw", [1, 2])
def test_walk_matches_plain_and_jax_interpret(case, gpw):
    pack, jg = _pack(case)
    xn = _x(pack.n_nodes, 41, seed=4)
    got, _ = _walk(pack, pack.spmm_index, xn, gpw)
    plain = cb.bcsr_matmul_plain(pack, torch.from_numpy(xn)).numpy()
    np.testing.assert_allclose(got, plain, rtol=RTOL, atol=ATOL)
    if pack.sym_scale is not None:
        want = pb.bcsr_matmul(jg.bcsr, jnp.asarray(xn))
    else:
        want = pb._bcsr_matmul(jg.bcsr.tiles, jg.bcsr.tile_rows, jg.bcsr.tile_cols,
                               jnp.asarray(xn), jg.bcsr.n_nodes)
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("case", ["int8 scaled uncovered rows", "int8 slab uncovered rows"])
def test_uncovered_tile_rows_walk_to_zero(case):
    pack, _ = _pack(case)
    out, order = _walk(pack, pack.spmm_index, _x(pack.n_nodes, 5), gpw=2)
    assert order and not any(row >= 380 for row in order)
    assert out.shape == (512, 5) and (out[380:] == 0).all()


def test_index_build_in_small_batches_is_the_same():
    pack, _ = _pack("int8 scaled 128x256")
    one, small = pack.spmm_index, cb.spmm_index(pack, batch_bytes=1)
    assert torch.equal(one.ent, small.ent) and torch.equal(one.rptr, small.rptr)


@pytest.mark.parametrize("tile_r", [128, 512, 1024])
def test_positions_deal_rows_16_apart_to_a_warp(tile_r):
    q = np.arange(tile_r)
    r = cb.spmm_row(q, tile_r)
    assert sorted(r) == list(q) and (cb.spmm_position(r, tile_r) == q).all()
    for rows in (16, 32):  # a warp's run of positions
        block = r[:rows]
        assert (np.diff(block[:tile_r // 16]) == 16).all()
        assert len(set(block % 16)) == max(1, rows // (tile_r // 16))


def test_index_refuses_tiles_it_cannot_walk():
    pack, _ = _pack("int8 scaled")
    with pytest.raises(ValueError, match="multiple of 128"):
        cb.spmm_index(dataclasses.replace(pack, tiles=pack.tiles[:, :, :64]))


def test_cpu_calls_take_the_plain_version_and_count_no_launch():
    pack, _ = _pack("int8 scaled")
    x = torch.from_numpy(_x(pack.n_nodes, 9))
    before = dict(cb.launches)
    for dense in (False, True):
        assert torch.equal(cb.bcsr_matmul_impl(pack, x, dense_tiles=dense),
                           cb.bcsr_matmul_plain(pack, x))
    assert cb.launches == before
    assert {"bcsr_f32", "bcsr_scaled_f32", "bcsr_rect_f32"} <= set(cb.launches)
