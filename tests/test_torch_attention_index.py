"""The live-column index that the GAT kernels K5/K6 walk (``BCSR.attn_index``).

The index lists each (segment, row) unit's live columns in the order the
kernels read them: segment by segment of ``BCSR.schedule``, within a segment
tile by tile, within a tile by column. The tests hold it to a loop over the
tiles for square packs, a hub tile-row split over several segments, mesh
slabs (rows and transposed columns) and every tile dtype, with -0.0 not
live. A plain walk of the index in K5's order (online softmax over 32-entry
batches, then the segments merged in order) and a walk of its entries
through K6's per-edge terms must equal ``gat_fwd_tiles_plain`` /
``gat_bwd_tiles_plain`` and the JAX package's ``gat_attend_tiles`` in
interpret mode: f32, forward rtol 2e-5, atol 2e-6; gradients rtol 2e-5,
atol 2e-5 (the same per-edge terms in another order, as
tests/test_torch_tile_attention.py).
"""

import dataclasses
import warnings

import numpy as np
import pytest
import torch

from parallel_gcn_tpu_torch.data.graph import add_self_loops_csr, build_graph, random_graph
from parallel_gcn_tpu_torch.ops import cuda_bcsr as cb
from parallel_gcn_tpu_torch.ops import tile_attention as ta
from parallel_gcn_tpu_torch.parallel import partition as tp

torch.set_num_threads(1)

CPU = torch.device("cpu")
SLOPE = 0.2
SEED = 77


def hub_graph(n=1200, deg=4, seed=0):
    """A symmetric random graph whose node 5 links to every 7th node: with
    128-row tiles every tile-row holds 10 tiles, more than a segment's 8."""
    rng = np.random.default_rng(seed)
    nb = [set() for _ in range(n)]
    for a, b in zip(rng.integers(0, n, n * deg), rng.integers(0, n, n * deg)):
        if a != b:
            nb[a].add(int(b))
            nb[b].add(int(a))
    for b in range(0, n, 7):
        if b != 5:
            nb[5].add(b)
            nb[b].add(5)
    return add_self_loops_csr([np.array(sorted(x), dtype=np.int64) for x in nb])


def expected_index(pack):
    """(ptr, col) by a loop over units and their segment's tiles."""
    sched = pack.schedule
    tiles = pack.tiles.float().numpy()
    tcols = pack.tile_cols.numpy()
    seg_ptr = sched.seg_tile_ptr.numpy()
    ptr, cols = [0], []
    for seg in range(sched.n_seg):
        for r in range(pack.tile_r):
            for t in range(seg_ptr[seg], seg_ptr[seg + 1]):
                cols.extend(int(tcols[t]) * pack.tile_c + np.flatnonzero(tiles[t, r] != 0))
            ptr.append(len(cols))
    return np.array(ptr), np.array(cols, dtype=np.int64)


def unit_rows(pack) -> torch.Tensor:
    """The global row of every index entry."""
    idx, sched = pack.attn_index, pack.schedule
    units = torch.arange(sched.n_seg * pack.tile_r)
    grow = sched.seg_row.long()[units // pack.tile_r] * pack.tile_r + units % pack.tile_r
    return torch.repeat_interleave(grow, (idx.ptr[1:] - idx.ptr[:-1]).long())


def check_index(pack):
    idx = pack.attn_index
    assert idx.ptr.dtype == idx.col.dtype == torch.int32
    assert idx.ptr.shape == (pack.schedule.n_seg * pack.tile_r + 1,)
    ptr, col = expected_index(pack)
    np.testing.assert_array_equal(idx.ptr.numpy(), ptr)
    np.testing.assert_array_equal(idx.col.numpy(), col)
    # the same entries as live_entries, regrouped by unit
    rows, cols = pack.live_entries
    got = sorted(zip(unit_rows(pack).tolist(), idx.col.long().tolist()))
    assert got == sorted(zip(rows.tolist(), cols.tolist()))


@pytest.fixture(scope="module")
def csr():
    return random_graph(300, 8, seed=5)[0]


@pytest.mark.parametrize("kw", [
    dict(hybrid=True, tile_size=128, tile_cols=256, tile_dtype="int8", min_tile_nnz=40),
    dict(hybrid=True, tile_size=128, min_tile_nnz=120),
    dict(bcsr=True, tile_size=128),
    dict(bcsr=True, tile_size=128, tile_cols=512, tile_dtype="bfloat16"),
], ids=["int8 128x256 hybrid", "f32 square hybrid", "f32 pure", "bf16 128x512 pure"])
def test_index_matches_the_tiles(csr, kw):
    check_index(build_graph(csr, device=CPU, **kw).bcsr)


def test_index_of_a_hub_row_split_over_segments():
    pack = build_graph(hub_graph(), device=CPU, bcsr=True, tile_size=128,
                       tile_dtype="int8").bcsr
    sched = pack.schedule
    assert sched.multi_row.numel() > 0  # tile-rows of more than one segment
    check_index(pack)
    idx = pack.attn_index
    counts = (idx.ptr[1:] - idx.ptr[:-1]).view(sched.n_seg, pack.tile_r)
    # node 5's row: its entries spread over both segments of tile-row 0
    segs = torch.nonzero(sched.seg_row == 0).flatten()
    assert len(segs) == 2 and all(int(counts[s, 5]) > 0 for s in segs)
    assert int(counts[segs, 5].sum()) == int((pack.live_entries[0] == 5).sum())
    # padding rows (1200..1279 of the last tile-row) are empty units
    last = torch.nonzero(sched.seg_row == pack.n_tile_rows - 1).flatten()
    assert int(counts[last, 1200 % pack.tile_r:].sum()) == 0


def test_index_of_mesh_slabs():
    """Rank 0's rows slab and its transposed column copy, 4-way boundary
    partition (rectangular: local rows × a larger buffer)."""
    csr = random_graph(2048, 8, seed=9)[0]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        mp = tp.gat_mesh_pack(tp.partition_graph_hybrid(
            csr, 4, tile_r=128, tile_c=128, min_tile_nnz=50, boundary=True, balance=False))
    attn = ta.rect_attention(mp.tiles_r[0], mp.trow_r[0], mp.tcol_r[0], mp.tiles_c[0],
                             mp.trow_c[0], mp.tcol_c[0], mp.res_row[0], mp.res_col[0],
                             mp.res_val[0], False, mp.n_local, mp.n_buf, "float32", CPU)
    assert attn.n_buf > attn.n_rows
    for pack in (attn.rows, attn.cols):
        check_index(pack)


@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16, torch.float32])
def test_index_liveness_by_dtype(csr, dtype):
    """Negative int8 bytes are live; -0.0 in a bf16 or f32 tile is not."""
    pack = build_graph(csr, device=CPU, bcsr=True, tile_size=128, tile_dtype="int8").bcsr
    tiles = pack.tiles.clone()
    rows, cols = pack.live_entries
    t, r, c = (tiles != 0).nonzero(as_tuple=True)
    flip = torch.arange(len(t)) % 3 == 0
    if dtype == torch.int8:
        tiles[t[flip], r[flip], c[flip]] = -tiles[t[flip], r[flip], c[flip]]
        dead = torch.zeros(len(t), dtype=torch.bool)
    else:
        tiles = tiles.to(dtype)
        tiles[t[flip], r[flip], c[flip]] = -0.0
        dead = flip
    signed = dataclasses.replace(pack, tiles=tiles)
    check_index(signed)
    live = set(zip(unit_rows(signed).tolist(), signed.attn_index.col.tolist()))
    assert live == set(zip(rows[~dead].tolist(), cols[~dead].tolist()))


# ---------------------------------------------------------------------------
# plain walks of the index in the kernels' order
# ---------------------------------------------------------------------------


def walk_fwd(pack, s, t, v, rate=0.0):
    """K5's order: per unit, 32 entries a batch with the online softmax
    (m, den, acc rescaled when the max rises), then each split tile-row's
    segments merged in order by the flash rescale."""
    idx, sched = pack.attn_index, pack.schedule
    n, H = s.shape
    R = pack.tile_r
    seg_m = torch.full((sched.n_seg, R, H), ta._NEG)
    seg_den = torch.zeros((sched.n_seg, R, H))
    seg_acc = torch.zeros((sched.n_seg, R, H, v.shape[2]))
    for u in range(sched.n_seg * R):
        seg, r = divmod(u, R)
        grow = int(sched.seg_row[seg]) * R + r
        cols = idx.col[idx.ptr[u] : idx.ptr[u + 1]].long()
        m, den, acc = seg_m[seg, r], seg_den[seg, r], seg_acc[seg, r]
        for b in range(0, len(cols), 32):
            c = cols[b : b + 32]
            e = ta._leaky(s[grow] + t[c], SLOPE)
            m_new = torch.maximum(m, e.max(0).values)
            scale = torch.exp(m - m_new)
            den.mul_(scale)
            acc.mul_(scale[:, None])
            w = torch.exp(e - m_new)
            den.add_(w.sum(0))
            if rate:
                keep = ta.edge_keep(torch.full_like(c, grow), c, H, SEED, rate)
                w = torch.where(keep, w * ta._inv_keep(rate), 0.0)
            acc.add_((w[:, :, None] * v[c]).sum(0))
            m.copy_(m_new)
    m_out = torch.empty((n, H))
    den_out, acc_out = torch.empty((n, H)), torch.empty((n, H, v.shape[2]))
    for row in range(pack.n_tile_rows):
        segs = torch.nonzero(sched.seg_row == row).flatten()
        m = seg_m[segs].max(0).values
        scale = torch.exp(seg_m[segs] - m)
        m_out[row * R : (row + 1) * R] = m
        den_out[row * R : (row + 1) * R] = (seg_den[segs] * scale).sum(0)
        acc_out[row * R : (row + 1) * R] = (seg_acc[segs] * scale[..., None]).sum(0)
    return acc_out, m_out, den_out


def walk_bwd(pack, s, t, v, g, m, den, rho, rate=0.0):
    """K6's per-edge terms over the index's entries (each unit's row as
    dest, its listed columns as src)."""
    ds, dt, dv = torch.zeros_like(m), torch.zeros_like(m), torch.zeros_like(v)
    ta._edge_bwd(unit_rows(pack), pack.attn_index.col.long(), None, s, t, v, g, m,
                 torch.clamp(den, min=1e-16), rho, SLOPE, rate, SEED, ds, dt, dv)
    return ds, dt, dv


def _inputs(n, H, D, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((n, H), (n, H), (n, H, D), (n, H, D))]


@pytest.mark.parametrize("rate", [0.0, 0.5])
@pytest.mark.parametrize("graph", ["random", "hub"])
def test_index_walk_matches_plain_and_jax(csr, graph, rate):
    import jax
    import jax.numpy as jnp

    import parallel_gcn_tpu.ops.pallas_bcsr as pb
    from jax.experimental.pallas import tpu as pltpu
    from parallel_gcn_tpu.data.graph import build_graph as jax_build_graph
    from parallel_gcn_tpu.ops import tile_attention as jta

    host = csr if graph == "random" else hub_graph()
    kw = dict(bcsr=True, tile_size=128)
    tg = build_graph(host, device=CPU, tile_dtype="int8", **kw)
    jg = jax_build_graph(host, tile_dtype=np.dtype("int8"), **kw)
    pack = tg.bcsr
    s, t, v, cot = _inputs(tg.n_nodes, 2, 5, seed=4)
    ts, tt, tv, tc = map(torch.from_numpy, (s, t, v, cot))

    acc, m, den = walk_fwd(pack, ts, tt, tv, rate)
    plain = ta.gat_fwd_tiles_plain(pack, ts, tt, tv, slope=SLOPE, rate=rate, seed=SEED)
    for a, b in zip((acc, m, den), plain):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-5, atol=2e-6)
    out = acc / torch.clamp(den, min=1e-16)[:, :, None]
    rho = (tc * out).sum(-1)
    grads = walk_bwd(pack, ts, tt, tv, tc, m, den, rho, rate)
    plain = ta.gat_bwd_tiles_plain(pack, ts, tt, tv, tc, m, den, rho, slope=SLOPE, rate=rate,
                                   seed=SEED)
    for a, b in zip(grads, plain):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-5, atol=2e-5)

    old = pb._INTERPRET[0]
    pb._INTERPRET[0] = pltpu.InterpretParams()
    try:
        def f(s, t, v):
            return jta.gat_attend_tiles(jg, s, t, v, slope=SLOPE, attn_dropout=rate,
                                        seed=jnp.int32(SEED) if rate else None)

        jout, vjp = jax.vjp(f, *(jnp.asarray(x) for x in (s, t, v)))
        want = [np.asarray(x) for x in (jout, *vjp(jnp.asarray(cot)))]
    finally:
        pb._INTERPRET[0] = old
    np.testing.assert_allclose(out.numpy(), want[0], rtol=2e-5, atol=2e-6)
    for a, b in zip(grads, want[1:]):
        np.testing.assert_allclose(a.numpy(), b, rtol=2e-5, atol=2e-5)


def test_index_is_built_once_per_pack(csr):
    pack = build_graph(csr, device=CPU, bcsr=True, tile_size=128).bcsr
    assert pack.attn_index is pack.attn_index
    assert cb.attn_index(pack).col.numel() == pack.live_entries[0].numel()
