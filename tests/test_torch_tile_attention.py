"""parallel_gcn_tpu_torch GAT tile attention (K5, K6) against the JAX package.

On the CPU the port's wrappers run their plain PyTorch versions; the JAX
side runs its Pallas kernels in TPU-interpret mode, as
tests/test_torch_bcsr.py does. Tolerances: forward rtol 2e-5, atol 2e-6;
gradients rtol 2e-5, atol 2e-5 (the same f32 per-edge terms summed in
another order). The attention-dropout hash must be bit-equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import parallel_gcn_tpu.ops.pallas_bcsr as pb
from parallel_gcn_tpu.data.graph import build_graph as jax_build_graph
from parallel_gcn_tpu.ops import tile_attention as jta
from parallel_gcn_tpu_torch.data.graph import build_graph, random_graph
from parallel_gcn_tpu_torch.ops import tile_attention as ta

torch.set_num_threads(1)

CPU = torch.device("cpu")
SLOPE = 0.2
SEED = 77

# the four pack geometries of tests/test_tile_attention.py
GEOMETRIES = [
    (128, 120, "float32", "hybrid square"),
    (256, 120, "float32", "hybrid rectangular"),
    (128, 0, "float32", "pure pack"),
    (128, 120, "int8", "int8 pattern tiles"),
]


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


@pytest.fixture(scope="module")
def csr():
    return random_graph(300, 8, seed=5)[0]


def _graphs(csr, tile_c, min_nnz, tile_dtype):
    kw = dict(hybrid=True, min_tile_nnz=min_nnz or None, tile_size=128, tile_cols=tile_c)
    tg = build_graph(csr, device=CPU, tile_dtype=tile_dtype, **kw)
    jg = jax_build_graph(csr, tile_dtype=np.dtype(tile_dtype), **kw)
    return tg, jg


def _inputs(n, H, D, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((n, H), (n, H), (n, H, D), (n, H, D))]


def _port(graph, s, t, v, cot, rate):
    ts, tt, tv = (torch.from_numpy(x).requires_grad_() for x in (s, t, v))
    out = ta.gat_attend_tiles(graph, ts, tt, tv, slope=SLOPE, attn_dropout=rate,
                              seed=SEED if rate else None)
    out.backward(torch.from_numpy(cot))
    return [x.detach().numpy() for x in (out, ts.grad, tt.grad, tv.grad)]


def _jax(graph, s, t, v, cot, rate):
    def f(s, t, v):
        return jta.gat_attend_tiles(graph, s, t, v, slope=SLOPE, attn_dropout=rate,
                                    seed=jnp.int32(SEED) if rate else None)

    out, vjp = jax.vjp(f, *(jnp.asarray(x) for x in (s, t, v)))
    return [np.asarray(x) for x in (out, *vjp(jnp.asarray(cot)))]


@pytest.mark.parametrize("rate", [0.1, 0.5, 0.6])
def test_hash_mask_is_bit_equal_to_jax(rate):
    rng = np.random.default_rng(int(rate * 10))
    dest = rng.integers(0, 2**31 - 1, 4000)
    src = rng.integers(0, 2**31 - 1, 4000)
    for seed in (0, 12345, 2**31 - 2, int(rng.integers(0, 2**31 - 1))):
        got = ta.edge_keep(torch.from_numpy(dest), torch.from_numpy(src), 5, seed, rate)
        want = jta._edge_keep(jnp.asarray(dest, jnp.int32), jnp.asarray(src, jnp.int32),
                              5, jnp.int32(seed), rate)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        for h in (0, 3):
            thr = ta.rate_to_threshold(rate)
            assert thr == jta._rate_to_threshold(rate)
            one = ta.hash_keep(torch.from_numpy(dest), torch.from_numpy(src), h, seed, thr)
            np.testing.assert_array_equal(
                one.numpy(), np.asarray(jta._hash_keep(jnp.asarray(dest, jnp.int32),
                                                       jnp.asarray(src, jnp.int32), h,
                                                       jnp.int32(seed), thr)))
    keep = got.float().mean().item()
    assert abs(keep - (1 - rate)) < 0.02


@pytest.mark.parametrize("rate", [0.0, 0.5])
@pytest.mark.parametrize("tile_c,min_nnz,tile_dtype,label", GEOMETRIES)
def test_attend_tiles_matches_jax(csr, tile_c, min_nnz, tile_dtype, label, rate):
    """Forward and (ds, dt, dv) against JAX's gat_attend_tiles; at rate 0.5
    both take the same int32 seed, so their hash masks are identical."""
    tg, jg = _graphs(csr, tile_c, min_nnz, tile_dtype)
    if min_nnz:
        assert tg.is_hybrid and jg.is_hybrid, label
    s, t, v, cot = _inputs(tg.n_nodes, 3, 5)
    got = _port(tg, s, t, v, cot, rate)
    want = _jax(jg, s, t, v, cot, rate)
    np.testing.assert_allclose(got[0], want[0], rtol=2e-5, atol=2e-6, err_msg=label)
    for name, a, b in zip(("ds", "dt", "dv"), got[1:], want[1:]):
        np.testing.assert_allclose(a, b, rtol=2e-5, atol=2e-5, err_msg=f"{label}: {name}")


def test_wide_tiles_give_the_same_result():
    """Packs with tile_c > 512, which the JAX package view-splits for the
    TPU and the port takes whole, against the same graph packed at 512."""
    csr = random_graph(700, 10, seed=2)[0]
    layouts = {
        "1024 hybrid": dict(hybrid=True, min_tile_nnz=1000, tile_cols=1024),
        "1024 pure": dict(bcsr=True, tile_cols=1024),
        "512 pure": dict(bcsr=True, tile_cols=512),
    }
    res = {}
    for name, kw in layouts.items():
        g = build_graph(csr, device=CPU, tile_size=128, n_nodes_pad=1024, **kw)
        assert g.bcsr.tile_c == kw["tile_cols"] and g.is_hybrid == ("hybrid" in name)
        s, t, v, cot = _inputs(g.n_nodes, 2, 4, seed=1)
        res[name] = sum((_port(g, s, t, v, cot, rate) for rate in (0.0, 0.5)), [])
    for name in ("1024 hybrid", "1024 pure"):
        for a, b in zip(res[name], res["512 pure"]):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6, err_msg=name)


def test_plain_versions_match_a_dense_reference(csr):
    """gat_fwd_tiles_plain / gat_bwd_tiles_plain on a pure pack against the
    dense masked softmax and its autograd, rate 0.5 with the hash mask."""
    g = build_graph(csr, device=CPU, bcsr=True, tile_size=128)
    n, H, D, rate = g.n_nodes, 2, 3, 0.5
    s, t, v, cot = (torch.from_numpy(x) for x in _inputs(n, H, D, seed=3))
    dest, src = g.bcsr.live_entries
    mask = torch.zeros((n, n), dtype=torch.bool)
    mask[dest, src] = True
    ids = torch.arange(n)
    keep = torch.stack([ta.hash_keep(ids[:, None], ids[None, :], h, SEED,
                                     ta.rate_to_threshold(rate)) for h in range(H)])
    sr, tr, vr = (x.clone().requires_grad_() for x in (s, t, v))
    e = sr.T[:, :, None] + tr.T[:, None, :]
    e = torch.where(mask, torch.where(e >= 0, e, SLOPE * e), -1e9)
    a = torch.where(mask, torch.softmax(e, dim=-1), 0.0)
    a = torch.where(keep, a / (1 - rate), 0.0)
    ref = torch.einsum("hij,jhd->ihd", a, vr)
    ref.backward(cot)

    acc, m, den = ta.gat_fwd_tiles_plain(g.bcsr, s, t, v, slope=SLOPE, rate=rate, seed=SEED)
    out = acc / den.clamp(min=1e-16)[:, :, None]
    np.testing.assert_allclose(out.numpy(), ref.detach().numpy(), rtol=2e-5, atol=2e-6)
    rho = (cot * out).sum(-1)
    grads = ta.gat_bwd_tiles_plain(g.bcsr, s, t, v, cot, m, den, rho, slope=SLOPE,
                                   rate=rate, seed=SEED)
    for got, want in zip(grads, (sr.grad, tr.grad, vr.grad)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-5, atol=2e-5)


def test_attend_tiles_argument_errors(csr):
    tg, _ = _graphs(csr, 128, 120, "float32")
    s, t, v, _ = (torch.from_numpy(x) for x in _inputs(tg.n_nodes, 2, 3))
    with pytest.raises(ValueError, match="needs a seed"):
        ta.gat_attend_tiles(tg, s, t, v, slope=SLOPE, attn_dropout=0.3)
    with pytest.raises(ValueError, match="attn_dropout"):
        ta.gat_attend_tiles(tg, s, t, v, slope=SLOPE, attn_dropout=1.0, seed=1)
    with pytest.raises(ValueError, match="do not agree"):
        ta.gat_attend_tiles(tg, s, t[:, :1], v, slope=SLOPE)
    seg = build_graph(csr, device=CPU)
    with pytest.raises(ValueError, match="tile pack"):
        ta.gat_attend_tiles(seg, s, t, v, slope=SLOPE)


def test_gradients_keep_input_dtypes(csr):
    tg, _ = _graphs(csr, 128, 120, "int8")
    s, t, v = (torch.from_numpy(x).to(torch.bfloat16).requires_grad_()
               for x in _inputs(tg.n_nodes, 2, 3)[:3])
    out = ta.gat_attend_tiles(tg, s, t, v, slope=SLOPE)
    assert out.dtype == torch.float32
    out.sum().backward()
    assert s.grad.dtype == t.grad.dtype == v.grad.dtype == torch.bfloat16


@pytest.mark.parametrize("H", [1, 2, 3, 8])
def test_node_records_layout(H):
    """K6's per-node records: head h's s | t | m | max(den, 1e-16) | ρ at
    [5h, 5h + 5), rows padded with zeros to a multiple of 4 floats."""
    n = 7
    s, t, m, den, rho = (torch.randn((n, H), generator=torch.Generator().manual_seed(i))
                         for i in range(5))
    den[0] = 0.0
    rec = ta._node_records(s.bfloat16(), t, m, den, rho)
    R = -(-5 * H // 4) * 4
    assert rec.shape == (n, R) and rec.dtype == torch.float32
    for h in range(H):
        for f, x in enumerate((s.bfloat16().float(), t, m, den.clamp(min=1e-16), rho)):
            assert torch.equal(rec[:, 5 * h + f], x[:, h])
    assert not rec[:, 5 * H :].any()


@pytest.mark.cuda
@pytest.mark.parametrize("v_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("graph", ["hybrid 128x256", "hub split over segments"])
def test_kernels_match_plain_on_card(csr, cuda_device, graph, v_dtype):
    """K5/K6 against their plain versions on the card, and bit-identical
    across two runs; the second graph's tile-rows hold more tiles than a
    segment, so their units are merged by the second pass."""
    if graph == "hybrid 128x256":
        g = build_graph(csr, device=cuda_device, hybrid=True, tile_size=128, tile_cols=256,
                        tile_dtype="int8", min_tile_nnz=40)
    else:
        from tests.test_torch_attention_index import hub_graph

        g = build_graph(hub_graph(), device=cuda_device, bcsr=True, tile_size=128,
                        tile_dtype="int8")
        assert g.bcsr.schedule.multi_row.numel() > 0
    s, t, v, gr = (torch.from_numpy(x).to(cuda_device) for x in _inputs(g.n_nodes, 2, 41))
    v = v.to(v_dtype)
    rtol = 1e-4 if v_dtype == torch.float32 else 2e-3
    for rate in (0.0, 0.6):
        kw = dict(slope=SLOPE, rate=rate, seed=SEED)
        fwd = ta.gat_fwd_tiles(g.bcsr, s, t, v, **kw)
        assert all(map(torch.equal, fwd, ta.gat_fwd_tiles(g.bcsr, s, t, v, **kw)))
        ref = ta.gat_fwd_tiles_plain(g.bcsr, s, t, v, **kw)
        for a, b in zip(fwd, ref):
            torch.testing.assert_close(a, b, rtol=rtol, atol=1e-5)
        acc, m, den = ref
        rho = (gr * acc / den.clamp(min=1e-16)[:, :, None]).sum(-1)
        bwd = ta.gat_bwd_tiles(g.bcsr, s, t, v, gr, m, den, rho, **kw)
        assert all(map(torch.equal, bwd, ta.gat_bwd_tiles(g.bcsr, s, t, v, gr, m, den,
                                                           rho, **kw)))
        for a, b in zip(bwd, ta.gat_bwd_tiles_plain(g.bcsr, s, t, v, gr, m, den, rho, **kw)):
            torch.testing.assert_close(a, b, rtol=1e-3, atol=1e-4)
