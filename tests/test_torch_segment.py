"""The ordered segment sums of parallel_gcn_tpu_torch (``ops.cuda_segment``).

On the CPU the wrappers run their plain versions (``index_add_``, which the
CPU runs in item order). Checked here: the CSR offsets and the stable
permutation against numpy; the GCN's hybrid residual against the JAX
package's ``graphsum`` segment backend on ``random_graph``; the GAT
residual's forward merge and backward, on a square pack and on a mesh slab
(whose dt and dv are summed by source), bit-equal to the ``index_add_`` code
the port ran before and within rtol 1e-5 (+ 1e-6·max|ref|) of JAX's
``gat_attend_tiles`` / ``gat_attend_rect`` at f32; the boundary halo's
backward with a row sent to several peers; the set-up arrays (the
longest-first work list, the items packed in segment order) and the
kernels' layout at the models' widths; and a numpy model of both kernels'
division of the work and item order (csrc/segment_sum.cuh), bit-equal to
the plain versions in f32, and with a 5,000-item hub in f32 and bf16. In
bf16 (the F4 case): a numpy model of kernel (a)'s numeric (f32 products of
bf16 operands, an f32 sum in item order, one rounding) bit-equal to the
port's CPU path, both plain versions' float32
accumulation, and the port's and JAX's ``_segment_once``'s errors against
an f64 sum on rows of up to 409 items, from which the port-against-JAX bf16
tolerance is derived. The kernels themselves run on the card in
``chip_smoke.py`` and in the ``cuda`` test below.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import parallel_gcn_tpu.ops.pallas_bcsr as pb
from parallel_gcn_tpu.data.graph import build_graph as jax_build_graph
from parallel_gcn_tpu.ops import tile_attention as jta
from parallel_gcn_tpu_torch.data.graph import build_graph, random_graph
from parallel_gcn_tpu_torch.ops import cuda_segment as cs
from parallel_gcn_tpu_torch.ops import graphsum as tgs
from parallel_gcn_tpu_torch.ops import tile_attention as ta
from parallel_gcn_tpu_torch.parallel import collectives
from test_torch_attention_rect import _attn, _packs

# the module (``parallel_gcn_tpu.ops`` exports the function under its name)
jgs = importlib.import_module("parallel_gcn_tpu.ops.graphsum")
torch.set_num_threads(1)

CPU = torch.device("cpu")
SLOPE, SEED = 0.2, 77


@pytest.fixture(autouse=True)
def interpret_mode():
    from jax.experimental.pallas import tpu as pltpu

    old = pb._INTERPRET[0]
    pb._INTERPRET[0] = pltpu.InterpretParams()
    yield
    pb._INTERPRET[0] = old


@pytest.fixture(scope="module")
def csr():
    return random_graph(300, 8, seed=5)[0]


def _hybrid(csr):
    kw = dict(hybrid=True, min_tile_nnz=120, tile_size=128, tile_cols=128)
    return build_graph(csr, device=CPU, **kw), jax_build_graph(csr, **kw)


@pytest.mark.parametrize("sort", [False, True])
def test_offsets_and_permutation_match_numpy(sort):
    rng = np.random.default_rng(1)
    n = 37
    idx = rng.integers(0, n - 3, 500)  # the last rows stay empty
    if sort:
        idx = np.sort(idx)
    seg = cs.segments(torch.from_numpy(idx), n)
    ptr = np.concatenate([[0], np.cumsum(np.bincount(idx, minlength=n))])
    np.testing.assert_array_equal(seg.ptr.numpy(), ptr)
    # the live segments lead the work list
    np.testing.assert_array_equal(np.sort(seg.work[:seg.n_live, 0].numpy()),
                                  np.flatnonzero(np.bincount(idx, minlength=n)))
    assert seg.ptr.dtype == torch.int32 and seg.work.dtype == torch.int32 and seg.n == n
    if sort:
        assert seg.perm is None
    else:
        assert seg.perm.dtype == torch.int32
        np.testing.assert_array_equal(seg.perm.numpy(), np.argsort(idx, kind="stable"))
    with pytest.raises(ValueError, match="outside"):
        cs.segments(torch.from_numpy(idx), n - 4)


def test_graph_and_slab_segments(csr):
    """The graph's residual rows are sorted (no permutation); a slab's
    residual sources take the stable source-sorted permutation."""
    tg, jg = _hybrid(csr)
    assert tg.is_hybrid and tg.row_seg.perm is None
    rows = tg.row.numpy()
    np.testing.assert_array_equal(
        tg.row_seg.ptr.numpy(),
        np.concatenate([[0], np.cumsum(np.bincount(rows, minlength=tg.n_nodes))]))
    np.testing.assert_array_equal(tg.col_seg.perm.numpy(),
                                  np.argsort(tg.col.numpy(), kind="stable"))
    port, _ = _packs(random_graph(2048, 8, seed=9)[0], 128, 50)
    rrow, rcol, _, row_seg, col_seg = _attn(port, True).residual
    assert row_seg.n == port.n_local and col_seg.n == port.n_buf
    np.testing.assert_array_equal(col_seg.perm.numpy(),
                                  np.argsort(rcol.numpy(), kind="stable"))
    np.testing.assert_array_equal(
        col_seg.ptr.numpy(),
        np.concatenate([[0], np.cumsum(np.bincount(rcol.numpy(), minlength=port.n_buf))]))


def test_gcn_residual_matches_jax_segment_backend(csr):
    tg, jg = _hybrid(csr)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((tg.n_nodes, 41)).astype(np.float32)
    got = tgs._segment(torch.from_numpy(x), tg, 1).numpy()
    want = np.asarray(jgs._segment_once(jnp.asarray(x), jg.row, jg.col, jg.val, jg.n_nodes))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 * np.abs(want).max())

    full = build_graph(csr, device=CPU)
    jfull = jax_build_graph(csr)
    cot = rng.standard_normal((full.n_nodes, 41)).astype(np.float32)
    tx = torch.from_numpy(x[: full.n_nodes]).requires_grad_()
    out = tgs.graphsum(tx, full, backend="segment")
    out.backward(torch.from_numpy(cot))
    jout, vjp = jax.vjp(lambda v: jgs.graphsum(v, jfull, backend="segment"),
                        jnp.asarray(x[: full.n_nodes]))
    for a, b in ((out.detach().numpy(), jout), (tx.grad.numpy(), vjp(jnp.asarray(cot))[0])):
        b = np.asarray(b)
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6 * np.abs(b).max())


def _index_add_(out, index, values):
    """The residual sums as the port ran them before the ordered sums."""
    return out.index_add_(0, index.index if isinstance(index, cs.Segments) else index, values)


def _close(got, ref):
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6 * float(np.abs(ref).max()))


def _inputs(n_rows, n_buf, H=2, D=5, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((n_rows, H), (n_buf, H), (n_buf, H, D), (n_rows, H, D))]


def _port_attend(fn, s, t, v, cot):
    ts, tt, tv = (torch.from_numpy(a).requires_grad_() for a in (s, t, v))
    out = fn(ts, tt, tv)
    out.backward(torch.from_numpy(cot))
    return [a.detach().numpy() for a in (out, ts.grad, tt.grad, tv.grad)]


@pytest.mark.parametrize("rate", [0.0, 0.5])
def test_gat_square_residual(csr, monkeypatch, rate):
    tg, jg = _hybrid(csr)
    s, t, v, cot = _inputs(tg.n_nodes, tg.n_nodes)
    seed = SEED if rate else None

    def attend(a, b, c):
        return ta.gat_attend_tiles(tg, a, b, c, slope=SLOPE, attn_dropout=rate, seed=seed)

    got = _port_attend(attend, s, t, v, cot)
    with monkeypatch.context() as m:
        m.setattr(ta, "segment_sum_", _index_add_)
        before = _port_attend(attend, s, t, v, cot)
    for a, b in zip(got, before):
        np.testing.assert_array_equal(a, b)

    def f(a, b, c):
        return jta.gat_attend_tiles(jg, a, b, c, slope=SLOPE, attn_dropout=rate,
                                    seed=jnp.int32(SEED) if rate else None)

    jout, vjp = jax.vjp(f, *(jnp.asarray(a) for a in (s, t, v)))
    for a, b in zip(got, (jout, *vjp(jnp.asarray(cot)))):
        _close(a, np.asarray(b))


@pytest.mark.parametrize("rate", [0.0, 0.5])
def test_gat_rect_residual(monkeypatch, rate):
    """A 4-way boundary slab with a residual: dt and dv of its residual
    edges are summed by source through the slab's permutation."""
    port, ref = _packs(random_graph(2048, 8, seed=9)[0], 128, 50)
    attn = _attn(port, True)
    s, t, v, cot = _inputs(port.n_local, port.n_buf)
    seed = SEED if rate else None

    def attend(a, b, c):
        return ta.gat_attend_rect(a, b, c, attn, slope=SLOPE, attn_dropout=rate, seed=seed)

    got = _port_attend(attend, s, t, v, cot)
    with monkeypatch.context() as m:
        m.setattr(ta, "segment_sum_", _index_add_)
        before = _port_attend(attend, s, t, v, cot)
    for a, b in zip(got, before):
        np.testing.assert_array_equal(a, b)

    packs = (ref.tiles_r[0], ref.trow_r[0], ref.tcol_r[0], ref.tiles_c[0], ref.trow_c[0],
             ref.tcol_c[0], ref.res_row[0], ref.res_col[0], ref.res_val[0])

    def f(a, b, c):
        return jta.gat_attend_rect(a, b, c, *map(jnp.asarray, packs), slope=SLOPE,
                                   has_res=True, attn_dropout=rate, seed=seed)

    jout, vjp = jax.vjp(f, *(jnp.asarray(a) for a in (s, t, v)))
    for a, b in zip(got, (jout, *vjp(jnp.asarray(cot)))):
        _close(a, np.asarray(b))


def test_halo_backward_with_repeated_rows():
    """A row sent to several peers (here: listed thrice) gets the sum of its
    copies' cotangents, in the order the schedule lists them."""
    n = 10
    send = np.array([3, 1, 3, 7, 1, 3, 0])
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((n, 4)).astype(np.float32)).requires_grad_()
    g = rng.standard_normal((n + len(send), 4)).astype(np.float32)
    with collectives.world(1, CPU):  # an all_to_all of one rank is the identity
        buf = collectives.gather_buffer(x, cs.segments(torch.from_numpy(send), n))
        np.testing.assert_array_equal(buf[n:].detach().numpy(), x.detach().numpy()[send])
        buf.backward(torch.from_numpy(g))
    want = g[:n].copy()
    for i, row in enumerate(send):
        want[row] += g[n + i]
    np.testing.assert_array_equal(x.grad.numpy(), want)


def test_adjoints():
    """``gather`` and ``segment_sum`` are each other's backward, and
    ``gather_sum_t``'s backward is the transposed sum."""
    rng = np.random.default_rng(3)
    n, m, e = 12, 9, 70
    row, col = rng.integers(0, n, e), rng.integers(0, m, e)
    val = rng.standard_normal(e).astype(np.float32)
    trow, tcol, tval = (torch.from_numpy(a) for a in (row, col, val))
    rs, ct = cs.segments(trow, n, tcol, tval), cs.segments(tcol, m, trow, tval)
    x = torch.from_numpy(rng.standard_normal((m, 3)).astype(np.float32)).requires_grad_()
    a = np.zeros((n, m), np.float32)
    np.add.at(a, (row, col), val)
    out = cs.gather_sum_t(x, rs, ct)
    g = rng.standard_normal((n, 3)).astype(np.float32)
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), a @ x.detach().numpy(), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(x.grad.numpy(), a.T @ g, rtol=1e-5, atol=1e-5)

    y = torch.from_numpy(rng.standard_normal((m, 2)).astype(np.float32)).requires_grad_()
    summed = cs.segment_sum(cs.gather(y, ct), rs)  # Σ over edges of y[col] into row
    summed.backward(torch.from_numpy(g[:, :2]))
    ones = np.zeros((n, m), np.float32)
    np.add.at(ones, (row, col), 1.0)
    np.testing.assert_allclose(summed.detach().numpy(), ones @ y.detach().numpy(),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(y.grad.numpy(), ones.T @ g[:, :2], rtol=1e-5, atol=1e-5)


def _owned_columns(lay, hub: bool, esize: int, width: int) -> list:
    """The columns each lane of a work entry's unit holds (csrc/segment_sum.cuh):
    the item walker's lanes all add every column (lane 0 stores); the column
    walker's lane t holds vectors t + p·lanes, p < passes (a hub team: one
    vector of the hub's width a lane)."""
    if lay.vec_bytes == 0:
        return [np.arange(width)]
    if hub:
        vec, lanes, passes = lay.hub_vec_bytes // esize, 32 * lay.hub_team, 1
    else:
        vec, passes = lay.vec_bytes // esize, lay.passes
        lanes = lay.group if lay.team == 1 else 32 * lay.team
    nvec = width // vec
    out = []
    for t in range(lanes):
        vs = [t + p * lanes for p in range(passes) if t + p * lanes < nvec]
        if vs:
            out.append(np.concatenate([np.arange(v * vec, (v + 1) * vec) for v in vs]))
    return out


def _kernel_model(seg, width, term, base=None, dtype=np.float32):
    """csrc/segment_sum.cuh in numpy: the units walk the work list
    (``seg.work``: hubs longest first, the other live segments, the empty
    ones): for kernel (a) (``base`` None) every segment, rows without items
    written as 0; for kernel (b) the live ones. The first ``n_hub`` entries
    go to hub teams (where the layout has them); each lane of an entry's
    unit holds the columns ``cs.layout`` gives it and adds the segment's
    items in sorted order (``perm``), one f32 rounding a product and a sum,
    from 0 or from ``base``, then rounds once to ``dtype``. Also checks that
    every (written row, column) has one owner and the other rows none."""
    esize = np.dtype(dtype).itemsize
    lay = cs.layout(width, esize, 16)
    n_hub = seg.n_hub if lay.hubs else 0
    work = seg.work.numpy()
    perm = None if seg.perm is None else seg.perm.numpy()
    n_work = seg.n if base is None else seg.n_live
    out = (np.zeros((seg.n, width), np.float32) if base is None
           else base.astype(np.float32))
    owners = np.zeros((seg.n, width), np.int64)
    for w in range(n_work):
        i, b, e = work[w, :3]
        for cols in _owned_columns(lay, w < n_hub, esize, width):
            owners[i, cols] += 1
            acc = out[i, cols]
            for k in range(b, e):
                acc = (acc + term(k if perm is None else perm[k], cols)).astype(np.float32)
            out[i, cols] = acc
    written = np.ones(seg.n, bool) if base is None else np.diff(seg.ptr.numpy()) > 0
    np.testing.assert_array_equal(owners, np.repeat(written[:, None], width, 1))
    return out.astype(dtype)


def _check_model(seg, idx, width, rng, n, n_src, dtype=np.float32):
    """Both kernels' model against the plain versions, bit for bit."""
    e = idx.size
    src = rng.integers(0, n_src, e)
    val = rng.standard_normal(e).astype(np.float32)
    x = rng.standard_normal((n_src, width)).astype(np.float32).astype(dtype)
    tdtype = torch.float32 if dtype == np.float32 else torch.bfloat16

    def t(a):
        return torch.from_numpy(a.astype(np.float32)).to(tdtype)

    packed = cs.segments(seg.index, seg.n, torch.from_numpy(src), torch.from_numpy(val))
    want = cs.gather_sum(t(x), packed)
    vr = val.astype(dtype).astype(np.float32)  # val as x's type
    x32 = x.astype(np.float32)
    got = _kernel_model(seg, width, lambda k, c: vr[k] * x32[src[k], c], dtype=dtype)
    np.testing.assert_array_equal(got.astype(np.float32), want.float().numpy())

    values = rng.standard_normal((e, width)).astype(np.float32).astype(dtype)
    base = rng.standard_normal((n, width)).astype(np.float32).astype(dtype)
    want = cs.segment_sum_(t(base), seg, t(values))
    v32 = values.astype(np.float32)
    got = _kernel_model(seg, width, lambda k, c: v32[k, c], base, dtype=dtype)
    np.testing.assert_array_equal(got.astype(np.float32), want.float().numpy())


@pytest.mark.parametrize("width", [1, 2, 5, 41, 64, 82, 130])
@pytest.mark.parametrize("sort", [False, True])
def test_kernel_model_is_bit_equal_to_plain(width, sort):
    rng = np.random.default_rng(width)
    n, n_src, e = 23, 31, 160
    idx = rng.integers(0, n - 2, e)
    if sort:
        idx = np.sort(idx)
    _check_model(cs.segments(torch.from_numpy(idx), n), idx, width, rng, n, n_src)


@pytest.mark.parametrize("width, dtype", [(2, np.float32), (41, np.float32),
                                          (600, jnp.bfloat16)])
@pytest.mark.parametrize("sort", [False, True])
def test_kernel_model_with_a_hub(width, dtype, sort):
    """One 5,000-item segment among short ones: the hub goes first to a team
    of warps (one vector a lane; the item walker: a whole warp)."""
    rng = np.random.default_rng(7)
    n, n_src = 40, 97
    idx = np.concatenate([np.full(5000, 17), rng.integers(0, n - 3, 300)])
    idx = np.sort(idx) if sort else rng.permutation(idx)
    seg = cs.segments(torch.from_numpy(idx), n)
    assert cs.layout(width, np.dtype(dtype).itemsize, 16).hubs
    assert seg.n_hub == 1 and int(seg.work[0, 0]) == 17
    _check_model(seg, idx, width, rng, n, n_src, dtype)


@pytest.mark.parametrize("n", [50, 700, 1000])  # more items than segments, as many, fewer
@pytest.mark.parametrize("sort", [False, True])
def test_work_list_and_packed_items_match_numpy(sort, n, monkeypatch):
    """The set-up arrays: the work list (every segment as (segment, begin,
    end, 0): the hubs longest first, then the other live segments longest
    first where there are fewer items than segments, else in segment
    order, then the empty ones; ties in segment order) and (a)'s items (src
    and the bits of val, in segment order)."""
    monkeypatch.setattr(cs, "HUB_ITEMS", 40)
    rng = np.random.default_rng(4)
    idx = rng.integers(0, n - 5, 700)
    idx[:90] = 11  # two hubs: rows 11 and 3
    idx[90:140] = 3
    if sort:
        idx = np.sort(idx)
    src = rng.integers(0, 1000, idx.size)
    val = rng.standard_normal(idx.size).astype(np.float32)
    seg = cs.segments(torch.from_numpy(idx), n, torch.from_numpy(src), torch.from_numpy(val))
    counts = np.bincount(idx, minlength=n)
    ptr = np.concatenate([[0], np.cumsum(counts)])
    ids = np.arange(n)
    group = np.where(counts >= 40, 0, np.where(counts > 0, 1, 2))
    longest = idx.size < n
    key = np.where((group == 0) | ((group == 1) & longest), -counts, ids)
    order = np.lexsort((ids, key, group))
    np.testing.assert_array_equal(
        seg.work.numpy(), np.stack([order, ptr[order], ptr[order + 1], 0 * order], 1))
    assert seg.work.dtype == torch.int32 and seg.work.is_contiguous()
    assert seg.n_hub == 2 and list(seg.work[:2, 0].numpy()) == [11, 3]
    assert seg.n_live == int((counts > 0).sum())
    by_segment = np.argsort(idx, kind="stable")
    np.testing.assert_array_equal(seg.items.numpy()[:, 0], src[by_segment])
    np.testing.assert_array_equal(seg.items.numpy()[:, 1], val[by_segment].view(np.int32))
    assert seg.items.dtype == torch.int32 and seg.items.shape == (idx.size, 2)
    assert seg.src is not None and seg.val is not None
    with pytest.raises(ValueError, match="built with src and val"):
        cs.gather_sum(torch.ones((1000, 3)), cs.segments(torch.from_numpy(idx), n))


@pytest.mark.parametrize("width, esize, align, want", [
    # (vector bytes, vectors, group, passes, team, hub team, hub vector bytes)
    (41, 2, 16, (2, 41, 32, 2, 1, 2, 2)),     # the GCN's residual, bf16 rows of 82 bytes
    (82, 2, 16, (4, 41, 32, 2, 1, 3, 2)),     # the stacked forward
    (600, 2, 16, (16, 75, 32, 1, 3, 5, 8)),   # SAGE/GIN: a team of 3 warps a row, hubs 5
    (602, 2, 16, (4, 301, 32, 2, 5, 1, 4)),   # GIN's layer 0: 5 warps, 2 passes, no hubs
    (300, 2, 16, (8, 75, 32, 1, 3, 5, 4)),    # TP halves: a team of 3 warps
    (150, 2, 16, (4, 75, 32, 4, 1, 5, 2)),    # TP quarters: rows of 300 bytes, one warp
    (41, 4, 16, (4, 41, 32, 2, 1, 2, 4)),
    (82, 4, 16, (8, 41, 32, 2, 1, 3, 4)),     # the GAT's numerators [E, 2, 41] f32
    (64, 4, 16, (16, 16, 16, 1, 1, 2, 4)),    # [E, 2, 32] f32
    (82, 4, 4, (4, 82, 32, 4, 1, 3, 4)),      # a column slice aligned to 4 bytes
    (2, 4, 16, (0, 2, 8, 1, 1, 1, 0)),        # the GAT's denominators: the item walker
    (2000, 4, 16, (16, 500, 32, 2, 8, 1, 16)),   # no hub kernel: 16 warps a hub
    (4096, 4, 16, (16, 1024, 32, 4, 8, 1, 16)),
])
def test_layout_of_the_models_widths(width, esize, align, want):
    lay = cs.layout(width, esize, align)
    assert (lay.vec_bytes, lay.nvec, lay.group, lay.passes, lay.team, lay.hub_team,
            lay.hub_vec_bytes) == want
    # a hub team covers the row one vector a lane, or there is none
    covered = 32 * lay.hub_team * lay.hub_vec_bytes >= width * esize
    assert lay.hubs == (lay.vec_bytes == 0 or covered)


@pytest.mark.parametrize("width, esize, align", [(41, 2, 16), (600, 2, 16), (2, 4, 16),
                                                 (82, 4, 4), (4096, 4, 16), (5000, 2, 2)])
def test_plan_is_the_layout_of_each_column_chunk(width, esize, align):
    """A call's launches, made once a shape: per column chunk its byte
    offset, whether it takes the hub kernel and the layout's arguments."""
    plan = cs._plan(width, esize, align)
    assert cs._plan(width, esize, align) is plan
    chunks = cs._column_chunks(width, esize, align)
    assert sum(cols for _, cols in chunks) == width and len(plan) == len(chunks)
    for (off, hubs, args), (c0, cols) in zip(plan, chunks):
        lay = cs.layout(cols, esize, align)
        assert off == c0 * esize and hubs == lay.hubs
        assert args == (cols, lay.vec_bytes, lay.group, lay.passes, lay.team, lay.hub_team,
                        lay.hub_vec_bytes)


# The bf16 residual's error relative to each row's Σ|term|, on
# ``_bf16_residual`` (44,808 items on 1,500 rows, up to 409 a row, as
# synth-reddit's residual has): measured 0.003861 for the port (one
# rounding) and 0.020899 for JAX's ``_segment_once`` (every product and
# partial sum rounded to bf16), rounded up here. The port's bound is
# analytic: one bf16 rounding (2^-8) of a sum at most Σ|term|, plus at most
# 409 float32 roundings (2^-24 each).
PORT_BF16_ERR = 2.0**-8 + 409 * 2.0**-24
JAX_BF16_ERR = 0.022
# port against JAX: within the sum of both errors (triangle inequality
# through the f64 sum)
PORT_VS_JAX_BF16 = PORT_BF16_ERR + JAX_BF16_ERR


def _bf16_residual(seed=11, n=1500, n_src=4000, width=41, max_len=409):
    """A residual in item order by row (sorted, as the GCN's is): Zipf row
    lengths up to ``max_len`` (every 300th row at it), Â-like values
    1/sqrt(d_i·d_j), bf16 features. Returns (index, src, val, x as bf16,
    row lengths)."""
    rng = np.random.default_rng(seed)
    lens = np.minimum(rng.zipf(1.5, n), max_len)
    lens[::300] = max_len
    index = np.repeat(np.arange(n), lens)
    src = rng.integers(0, n_src, index.size)
    val = (1.0 / np.sqrt(rng.integers(1, 60, index.size)
                         * rng.integers(1, 60, index.size))).astype(np.float32)
    x = rng.standard_normal((n_src, width)).astype(np.float32).astype(jnp.bfloat16)
    return index, src, val, x, lens


def test_bf16_gather_sum_rounds_once_and_its_distance_from_jax():
    index, src, val, x, lens = _bf16_residual()
    n, width = lens.size, x.shape[1]
    # kernel (a) in numpy: val rounded to bf16 (as JAX casts it), each
    # product of two bf16 values exact in f32, summed in f32 in item order,
    # one rounding to bf16 at the store
    terms = val.astype(jnp.bfloat16).astype(np.float32)[:, None] * x[src].astype(np.float32)
    ptr = np.concatenate([[0], np.cumsum(lens)])[:-1]
    acc = np.zeros((n, width), np.float32)
    for k in range(lens.max()):
        live = lens > k
        acc[live] = acc[live] + terms[ptr[live] + k]
    model = acc.astype(jnp.bfloat16).astype(np.float32)

    seg = cs.segments(torch.from_numpy(index), n, torch.from_numpy(src), torch.from_numpy(val))
    xt = torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
    port = cs.gather_sum(xt, seg)
    assert port.dtype == torch.bfloat16
    port = port.float().numpy()
    np.testing.assert_array_equal(port, model)
    # the chunked plain version accumulates across chunks in f32: the same bits
    chunked = cs.gather_sum_plain(xt, seg.index, torch.from_numpy(src), torch.from_numpy(val),
                                  n, n_chunks=7)
    np.testing.assert_array_equal(chunked.float().numpy(), model)

    jax_out = np.asarray(jgs._segment_once(jnp.asarray(x), jnp.asarray(index), jnp.asarray(src),
                                           jnp.asarray(val), n).astype(jnp.float32))
    t64 = terms.astype(np.float64)
    exact, scale = np.zeros((n, width)), np.zeros((n, width))
    np.add.at(exact, index, t64)
    np.add.at(scale, index, np.abs(t64))
    port_err = float((np.abs(port - exact) / scale).max())
    jax_err = float((np.abs(jax_out - exact) / scale).max())
    assert port_err <= PORT_BF16_ERR, port_err
    assert jax_err <= JAX_BF16_ERR, jax_err
    assert port_err < jax_err / 4  # one rounding against one a product and a sum
    assert (np.abs(port - jax_out) <= PORT_VS_JAX_BF16 * scale).all()


def test_bf16_segment_sum_plain_accumulates_in_f32():
    """Kernel (b)'s numeric in bf16: out's value and the terms summed in f32
    in item order, one rounding; rows without items keep their value."""
    rng = np.random.default_rng(5)
    n, e, width = 40, 900, 6
    idx = rng.integers(0, n - 3, e)
    values = rng.standard_normal((e, width)).astype(np.float32).astype(jnp.bfloat16)
    base = rng.standard_normal((n, width)).astype(np.float32).astype(jnp.bfloat16)
    seg = cs.segments(torch.from_numpy(idx), n)
    order = seg.perm.numpy()
    acc = base.astype(np.float32)
    for k in order:  # the stable sorted order is each row's item order
        acc[idx[k]] = acc[idx[k]] + values[k].astype(np.float32)
    want = acc.astype(jnp.bfloat16).astype(np.float32)
    for index in (seg, seg.index):
        out = torch.from_numpy(base.astype(np.float32)).to(torch.bfloat16)
        got = cs.segment_sum_(out, index, torch.from_numpy(values.astype(np.float32))
                              .to(torch.bfloat16))
        assert got is out and got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.float().numpy(), want)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel; no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("width", [2, 41, 82, 600])
def test_kernels_match_plain_on_card(cuda_device, width):
    """Both kernels against their plain versions on the CPU: f32 bit-equal,
    two launches bit-identical; a 5,000-item hub row among the short ones."""
    rng = np.random.default_rng(width)
    n, e = 5000, 60000
    idx = rng.integers(0, n, e)
    idx[rng.choice(e, 5000, replace=False)] = 123
    src = rng.integers(0, n, e)
    val = rng.standard_normal(e).astype(np.float32)
    x = rng.standard_normal((n, width)).astype(np.float32)
    values = rng.standard_normal((e, width)).astype(np.float32)
    for dev in (CPU, cuda_device):
        seg = cs.segments(torch.from_numpy(idx).to(dev), n, torch.from_numpy(src).to(dev),
                          torch.from_numpy(val).to(dev))
        args = (torch.from_numpy(x).to(dev), seg)
        a = cs.gather_sum(*args).cpu().numpy()
        np.testing.assert_array_equal(a, cs.gather_sum(*args).cpu().numpy())
        b = cs.segment_sum_(torch.zeros(n, width, device=dev), seg,
                            torch.from_numpy(values).to(dev)).cpu().numpy()
        if dev == CPU:
            want = (a, b)
    np.testing.assert_array_equal(a, want[0])
    np.testing.assert_array_equal(b, want[1])
