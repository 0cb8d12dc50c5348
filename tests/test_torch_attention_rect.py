"""Mesh-slab GAT attention (rect K5, K7) against the JAX package.

``ops.tile_attention.gat_attend_rect`` on rank 0's slab of a 4-way boundary
partition (local rows × a larger source buffer) against the JAX package's
``gat_attend_rect`` on the same slab, forward and (ds, dt, dv), with and
without a COO residual and with attention dropout 0 and 0.5. On the CPU the
port runs the plain versions of K5 and K7; the JAX side runs its Pallas
kernels in TPU-interpret mode. f32; tolerance rtol 1e-5 plus atol
1e-6·max|ref| (the same per-edge terms summed in another order). Plus the
plain K7 sweeps against a dense reference; plain walks of the slabs'
live-column indexes in the K7 kernels' order (per unit, 32-entry batches,
weighted row sums, one dot product per row, segments merged in order)
against the plain sweeps and JAX's gradients (rtol 2e-5, atol 2e-5: the
same terms in another order); and the kernels on the card (``cuda``
marker).
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import parallel_gcn_tpu.ops.pallas_bcsr as pb
from parallel_gcn_tpu.data.graph import HostCSR as JaxHostCSR
from parallel_gcn_tpu.ops import tile_attention as jta
from parallel_gcn_tpu.parallel import partition as jp
from parallel_gcn_tpu_torch.data.graph import add_self_loops_csr, random_graph
from parallel_gcn_tpu_torch.ops import tile_attention as ta
from parallel_gcn_tpu_torch.parallel import partition as tp

torch.set_num_threads(1)

SLOPE = 0.2
SEED = 1234567
H, D = 2, 8


@pytest.fixture(autouse=True)
def interpret_mode():
    from jax.experimental.pallas import tpu as pltpu

    old = pb._INTERPRET[0]
    pb._INTERPRET[0] = pltpu.InterpretParams()
    yield
    pb._INTERPRET[0] = old


@pytest.fixture(scope="module")
def csr():
    return random_graph(2048, 8, seed=9)[0]


def hub_csr(n=1200, deg=4, seed=0):
    """A symmetric random graph whose node 5 links to every 7th node, so
    that rank 0's first tile-row spans more buffer tiles than a segment
    holds."""
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


def _packs(csr, tile_c, min_nnz):
    """Rank 0's slab of the port's and the JAX package's 4-way boundary
    GAT packs (equal array for array, tests/test_torch_partition.py)."""
    kw = dict(tile_r=128, tile_c=tile_c, min_tile_nnz=min_nnz, boundary=True,
              balance=False)
    jcsr = JaxHostCSR(indptr=csr.indptr, indices=csr.indices, values=csr.values,
                      n_rows=csr.n_rows, n_cols=csr.n_cols, sym_scale=csr.sym_scale)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        port = tp.gat_mesh_pack(tp.partition_graph_hybrid(csr, 4, **kw))
        ref = jp.gat_mesh_pack(jp.partition_graph_hybrid(jcsr, 4, **kw))
    assert port.n_buf > port.n_local  # a rectangular slab
    return port, ref


def _attn(mp, has_res):
    r = 0
    return ta.rect_attention(mp.tiles_r[r], mp.trow_r[r], mp.tcol_r[r], mp.tiles_c[r],
                             mp.trow_c[r], mp.tcol_c[r], mp.res_row[r], mp.res_col[r],
                             mp.res_val[r], has_res, mp.n_local, mp.n_buf, "float32", "cpu")


def _inputs(n_rows, n_buf, seed=0, d=D):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((n_rows, H), (n_buf, H), (n_buf, H, d), (n_rows, H, d))]


def _close(got, ref):
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6 * float(np.abs(ref).max()))


@pytest.mark.parametrize("tile_c,min_nnz,has_res", [
    (128, 50, True),    # tiles + residual
    (256, 1, False),    # every edge in the tiles, rectangular tiles
])
@pytest.mark.parametrize("rate", [0.0, 0.5])
def test_gat_attend_rect_matches_jax(csr, tile_c, min_nnz, has_res, rate):
    port, ref = _packs(csr, tile_c, min_nnz)
    assert port.has_res == has_res
    s, t, v, cot = _inputs(port.n_local, port.n_buf)
    seed = SEED if rate else None

    ts, tt, tv = (torch.from_numpy(x).requires_grad_() for x in (s, t, v))
    out = ta.gat_attend_rect(ts, tt, tv, _attn(port, has_res), slope=SLOPE,
                             attn_dropout=rate, seed=seed)
    out.backward(torch.from_numpy(cot))

    r = 0
    packs = (ref.tiles_r[r], ref.trow_r[r], ref.tcol_r[r], ref.tiles_c[r], ref.trow_c[r],
             ref.tcol_c[r], ref.res_row[r], ref.res_col[r], ref.res_val[r])

    def f(s, t, v):
        return jta.gat_attend_rect(s, t, v, *map(jnp.asarray, packs), slope=SLOPE,
                                   has_res=has_res, attn_dropout=rate, seed=seed)

    jout, vjp = jax.vjp(f, jnp.asarray(s), jnp.asarray(t), jnp.asarray(v))
    jds, jdt, jdv = vjp(jnp.asarray(cot))
    _close(out.detach().numpy(), np.asarray(jout))
    for got, want in ((ts.grad, jds), (tt.grad, jdt), (tv.grad, jdv)):
        _close(got.numpy(), np.asarray(want))
    assert np.abs(tt.grad.numpy()[port.n_local:]).max() > 0  # the halo rows get gradients


def _dense_alpha(attn, s, t):
    """Dense [H, n_rows, n_buf] α of the slab's tile entries (no residual)."""
    dest, src = attn.rows.live_entries
    mask = torch.zeros((attn.n_rows, attn.n_buf), dtype=torch.bool)
    mask[dest, src] = True
    e = ta._leaky(s.T[:, :, None] + t.T[:, None, :], SLOPE)
    return torch.softmax(torch.where(mask, e, -1e9), dim=-1) * mask, mask


def test_rect_sweeps_match_dense_reference(csr):
    """The plain K7 sweeps, and rect K5, against the dense softmax
    jacobian of the slab's tile entries."""
    port, _ = _packs(csr, 128, 50)
    attn = _attn(port, False)
    s, t, v, g = (torch.from_numpy(x) for x in _inputs(port.n_local, port.n_buf, seed=3))
    acc, m, den = ta.gat_fwd_rect(attn.rows, s, t, v, slope=SLOPE)
    alpha, mask = _dense_alpha(attn, s, t)
    out = acc / den.clamp(min=1e-16)[:, :, None]
    _close(out.numpy(), torch.einsum("hij,jhd->ihd", alpha, v).numpy())
    rho = (g * out).sum(-1)
    ds = ta.gat_bwd_rect_row_plain(attn.rows, s, t, v, g, m, den, rho, slope=SLOPE)
    dt, dv = ta.gat_bwd_rect_col_plain(attn.cols, s, t, v, g, m, den, rho, slope=SLOPE)
    # de_ij = α_ij (⟨g_i, v_j⟩ − ρ_i) leaky'(s_i + t_j)
    dot = torch.einsum("ihd,jhd->hij", g, v)
    lg = ta._leaky_grad(s.T[:, :, None] + t.T[:, None, :], SLOPE)
    de = alpha * (dot - rho.T[:, :, None]) * lg * mask
    _close(ds.numpy(), de.sum(2).T.numpy())
    _close(dt.numpy(), de.sum(1).T.numpy())
    _close(dv.numpy(), torch.einsum("hij,ihd->jhd", alpha, g).numpy())


# ---------------------------------------------------------------------------
# plain walks of the slabs' live-column indexes in the K7 kernels' order
# ---------------------------------------------------------------------------


def _merge_segments(pack, part):
    """Each tile-row's rows from its segments' partial rows ``part``
    [n_seg, tile_r, ...], summed in segment order (the kernels' merge)."""
    sched, R = pack.schedule, pack.tile_r
    out = torch.zeros((pack.n_rows, *part.shape[2:]))
    for row in range(sched.n_tile_rows):
        for seg in torch.nonzero(sched.seg_row == row).flatten().tolist():
            out[row * R : (row + 1) * R] += part[seg]
    return out


def _units(pack):
    """(segment, row in the tile, global row, listed columns) of every unit
    of ``pack``'s live-column index, in order."""
    idx, sched, R = pack.attn_index, pack.schedule, pack.tile_r
    for u in range(sched.n_seg * R):
        seg, r = divmod(u, R)
        yield seg, r, int(sched.seg_row[seg]) * R + r, idx.col[idx.ptr[u] : idx.ptr[u + 1]].long()


def walk_rect_row(rows, s, t, v, g, m, den, rho, rate=0.0):
    """The row sweep's order: per unit (local row i), 32 entries a batch,
    A = α·leaky'(pre), the weighted row sum Σ A·keep·v_j and Σ A; once per
    unit ds_i = ⟨g_i, Σ A·keep·v_j⟩ − ρ_i·Σ A; split rows merged in order."""
    n_h = s.shape[1]
    den_g = torch.clamp(den, min=1e-16)
    part = torch.zeros((rows.schedule.n_seg, rows.tile_r, n_h))
    for seg, r, i, cols in _units(rows):
        sv, sum_a = torch.zeros((n_h, v.shape[2])), torch.zeros(n_h)
        for b in range(0, len(cols), 32):
            j = cols[b : b + 32]
            pre = s[i] + t[j]
            a_ = torch.exp(ta._leaky(pre, SLOPE) - m[i]) / den_g[i] * ta._leaky_grad(pre, SLOPE)
            c = a_
            if rate:
                keep = ta.edge_keep(torch.full_like(j, i), j, n_h, SEED, rate)
                c = torch.where(keep, a_ * ta._inv_keep(rate), 0.0)
            sv += (c[:, :, None] * v[j]).sum(0)
            sum_a += a_.sum(0)
        part[seg, r] = (g[i] * sv).sum(-1) - rho[i] * sum_a
    return _merge_segments(rows, part)


def walk_rect_col(cols, s, t, v, g, m, den, rho, rate=0.0):
    """The column sweep's order over the transposed copy: per unit (buffer
    row j), 32 entries (local rows i) a batch, an = α·keep/(1−rate),
    C = an·leaky'(pre), B = α·ρ_i·leaky'(pre); each g_i into the two
    weighted row sums dv_j = Σ an·g_i and w_j = Σ C·g_i; once per unit
    dt_j = ⟨v_j, w_j⟩ − Σ B; split rows merged in order. Returns (dt, dv)."""
    n_h, d = s.shape[1], v.shape[2]
    den_g = torch.clamp(den, min=1e-16)
    part = torch.zeros((cols.schedule.n_seg, cols.tile_r, n_h * d + n_h))
    for seg, r, j, dest in _units(cols):
        dv, w, sum_b = torch.zeros((n_h, d)), torch.zeros((n_h, d)), torch.zeros(n_h)
        for b in range(0, len(dest), 32):
            i = dest[b : b + 32]
            pre = s[i] + t[j]
            a_ = torch.exp(ta._leaky(pre, SLOPE) - m[i]) / den_g[i]
            lg = ta._leaky_grad(pre, SLOPE)
            an = a_
            if rate:
                keep = ta.edge_keep(i, torch.full_like(i, j), n_h, SEED, rate)
                an = torch.where(keep, a_ * ta._inv_keep(rate), 0.0)
            dv += (an[:, :, None] * g[i]).sum(0)
            w += ((an * lg)[:, :, None] * g[i]).sum(0)
            sum_b += (a_ * rho[i] * lg).sum(0)
        part[seg, r] = torch.cat([dv.flatten(), (v[j] * w).sum(-1) - sum_b])
    out = _merge_segments(cols, part)
    return out[:, n_h * d :], out[:, : n_h * d].view(-1, n_h, d)


@pytest.mark.parametrize("rate", [0.0, 0.5])
@pytest.mark.parametrize("slab", ["4-way", "hub"])
def test_sweep_walks_match_plain_and_jax(csr, slab, rate):
    """The K7 walks' order on rank 0's slab of a 4-way boundary partition
    (every edge in 128×256 tiles, buffer blocks without tiles) and of a hub
    graph whose first tile-row splits over several segments, against the
    plain sweeps and JAX's ``gat_attend_rect`` gradients in interpret mode."""
    port, ref = (_packs(csr, 256, 1) if slab == "4-way" else _packs(hub_csr(), 128, 1))
    attn = _attn(port, False)
    if slab == "hub":
        assert attn.rows.schedule.multi_row.numel() > 0  # a tile-row of several segments
    else:  # a buffer block with no tile: an empty segment of the column copy
        counts = torch.bincount(attn.cols.tile_rows.long(), minlength=attn.cols.n_tile_rows)
        assert int((counts == 0).sum()) > 0
    s, t, v, cot = _inputs(port.n_local, port.n_buf, seed=5)
    ts, tt, tv, tg = map(torch.from_numpy, (s, t, v, cot))
    kw = dict(slope=SLOPE, rate=rate, seed=SEED)
    acc, m, den = ta.gat_fwd_rect(attn.rows, ts, tt, tv, **kw)
    rho = (tg * acc / den.clamp(min=1e-16)[:, :, None]).sum(-1)
    bw = (ts, tt, tv, tg, m, den, rho)
    ds = walk_rect_row(attn.rows, *bw, rate=rate)
    dt, dv = walk_rect_col(attn.cols, *bw, rate=rate)

    def close(got, want):
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)

    close(ds.numpy(), ta.gat_bwd_rect_row_plain(attn.rows, *bw, **kw).numpy())
    for got, want in zip((dt, dv), ta.gat_bwd_rect_col_plain(attn.cols, *bw, **kw)):
        close(got.numpy(), want.numpy())

    r = 0
    packs = (ref.tiles_r[r], ref.trow_r[r], ref.tcol_r[r], ref.tiles_c[r], ref.trow_c[r],
             ref.tcol_c[r], ref.res_row[r], ref.res_col[r], ref.res_val[r])

    def f(s, t, v):
        return jta.gat_attend_rect(s, t, v, *map(jnp.asarray, packs), slope=SLOPE,
                                   has_res=False, attn_dropout=rate,
                                   seed=SEED if rate else None)

    _, vjp = jax.vjp(f, jnp.asarray(s), jnp.asarray(t), jnp.asarray(v))
    for got, want in zip((ds, dt, dv), vjp(jnp.asarray(cot))):
        close(got.numpy(), np.asarray(want))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel; no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.5])
def test_rect_kernels_match_plain_on_card(csr, cuda_device, rate):
    """Rect K5 and both K7 sweeps on the card against their plain versions
    on the same inputs (f32)."""
    port, _ = _packs(csr, 128, 50)
    attn = _attn(port, True)
    attn_d = ta.rect_attention(
        port.tiles_r[0], port.trow_r[0], port.tcol_r[0], port.tiles_c[0], port.trow_c[0],
        port.tcol_c[0], port.res_row[0], port.res_col[0], port.res_val[0], True,
        port.n_local, port.n_buf, "float32", cuda_device)
    s, t, v, g = (torch.from_numpy(x) for x in _inputs(port.n_local, port.n_buf, seed=4))
    kw = dict(slope=SLOPE, rate=rate, seed=SEED)
    acc, m, den = ta.gat_fwd_rect(attn.rows, s, t, v, **kw)
    got = ta.gat_fwd_rect(attn_d.rows, *(x.to(cuda_device) for x in (s, t, v)), **kw)
    for a, b in zip(got, (acc, m, den)):
        _close(a.cpu().numpy(), b.numpy())
    rho = (g * acc / den.clamp(min=1e-16)[:, :, None]).sum(-1)
    want = ta.gat_bwd_rect(attn, s, t, v, g, m, den, rho, **kw)
    got = ta.gat_bwd_rect(attn_d, *(x.to(cuda_device) for x in (s, t, v, g, m, den, rho)),
                          **kw)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-5 * float(b.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [32, 41])
@pytest.mark.parametrize("v_dtype", [torch.float32, torch.bfloat16])
def test_rect_sweeps_odd_shapes_on_card(csr, cuda_device, d, v_dtype):
    """Both K7 sweeps on the card against their plain versions on a slab
    with buffer blocks that hold no tile (empty segments of the column
    copy), at the GAT's widths d 32 and 41, attention dropout 0 and 0.5; two
    runs bit-identical."""
    port, _ = _packs(csr, 256, 1)
    args = (port.tiles_r[0], port.trow_r[0], port.tcol_r[0], port.tiles_c[0], port.trow_c[0],
            port.tcol_c[0], port.res_row[0], port.res_col[0], port.res_val[0], False,
            port.n_local, port.n_buf, "float32")
    attn, attn_d = ta.rect_attention(*args, "cpu"), ta.rect_attention(*args, cuda_device)
    counts = torch.bincount(attn.cols.tile_rows.long(), minlength=attn.cols.n_tile_rows)
    assert int((counts == 0).sum()) > 0
    s, t, v, g = (torch.from_numpy(x) for x in _inputs(port.n_local, port.n_buf, seed=6, d=d))
    v = v.to(v_dtype)
    for rate in (0.0, 0.5):
        kw = dict(slope=SLOPE, rate=rate, seed=SEED)
        acc, m, den = ta.gat_fwd_rect(attn.rows, s, t, v, **kw)
        rho = (g * acc / den.clamp(min=1e-16)[:, :, None]).sum(-1)
        bw = (s, t, v, g, m, den, rho)
        want = ta.gat_bwd_rect(attn, *bw, **kw)
        bw_d = tuple(x.to(cuda_device) for x in bw)
        got = ta.gat_bwd_rect(attn_d, *bw_d, **kw)
        again = ta.gat_bwd_rect(attn_d, *bw_d, **kw)
        for a, b, c in zip(got, want, again):
            assert torch.equal(a, c)
            np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), rtol=1e-4,
                                       atol=1e-5 * float(b.abs().max()))
