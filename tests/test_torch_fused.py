"""parallel_gcn_tpu_torch fused dropout⊗matmul (K10).

On the CPU the wrapper runs the plain version. Its mask is the port's K1
mask: an identity W recovers the masked X, which must equal
``cuda_dropout.dropout`` bit for bit, and the forward must equal the
unfused pair ``feature_transform(dropout(x), w)`` (rtol 1e-6, f32). The
gradients must equal their analytic forms on the recovered mask (rtol and
atol 1e-4, as tests/test_fused.py). Against JAX: in interpret mode JAX's
kernel keeps every element (tests/test_fused.py), so the port's plain
version is given an all-keep mask and compared with JAX's forward and
``jax.grad`` at rtol and atol 1e-5 (f32, sums in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from parallel_gcn_tpu.ops import pallas_fused
from parallel_gcn_tpu_torch.ops import cuda_dropout as cd
from parallel_gcn_tpu_torch.ops import cuda_fused as cf
from parallel_gcn_tpu_torch.ops.sparse_matmul import feature_transform

torch.set_num_threads(1)

SEED = 0x2545_F491_4F6C_DD1D


@pytest.fixture(autouse=True)
def interpret_mode():
    old = pallas_fused._INTERPRET[0]
    pallas_fused._INTERPRET[0] = pltpu.InterpretParams()
    yield
    pallas_fused._INTERPRET[0] = old


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel; no CPU mode)")
    return torch.device("cuda")


def _randn(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


def _recovered(x, seed, rate):
    """(mask ⊙ x)/keep as the fused kernel sees it: x times an identity W."""
    return cf.dropout_matmul(x, torch.eye(x.shape[1], dtype=x.dtype), seed, rate)


@pytest.mark.parametrize("shape", [(96, 200), (300, 513), (64, 128)])
def test_forward_equals_unfused_pair(shape):
    rng = np.random.default_rng(0)
    x, w = _randn(rng, *shape), _randn(rng, shape[1], 24)
    rate = 0.4
    dropped = cd.dropout(x, SEED, rate)
    assert torch.equal(_recovered(x, SEED, rate), dropped)
    y = cf.dropout_matmul(x, w, SEED, rate)
    assert y.dtype == torch.float32 and y.shape == (shape[0], 24)
    torch.testing.assert_close(y, feature_transform(dropped, w), rtol=1e-6, atol=1e-6)


def test_gradients_match_recovered_mask():
    rng = np.random.default_rng(1)
    n, k, m, rate = 120, 300, 16, 0.3
    x = _randn(rng, n, k).requires_grad_(True)
    w = _randn(rng, k, m).requires_grad_(True)
    g = _randn(rng, n, m)
    xm = _recovered(x.detach(), 7, rate)
    cf.dropout_matmul(x, w, 7, rate).backward(g)
    torch.testing.assert_close(w.grad, xm.T @ g, rtol=1e-4, atol=1e-4)
    mask = (xm != 0).float() / (1 - rate)
    torch.testing.assert_close(x.grad, mask * (g @ w.detach().T), rtol=1e-4, atol=1e-4)


def test_same_seed_same_output_other_seed_other_mask():
    rng = np.random.default_rng(2)
    x, w = _randn(rng, 64, 256), _randn(rng, 256, 8)
    a = cf.dropout_matmul(x, w, 5, 0.5)
    assert torch.equal(a, cf.dropout_matmul(x, w, 5, 0.5))
    keep5 = _recovered(x, 5, 0.5) != 0
    keep6 = _recovered(x, 6, 0.5) != 0
    assert not torch.equal(keep5, keep6)
    assert abs(keep5.float().mean().item() - 0.5) < 0.02


def test_need_dx_false_returns_zeros():
    rng = np.random.default_rng(3)
    x = _randn(rng, 50, 40).requires_grad_(True)
    w = _randn(rng, 40, 6).requires_grad_(True)
    cf.dropout_matmul(x, w, 11, 0.2, need_dx=False).sum().backward()
    assert torch.equal(x.grad, torch.zeros_like(x))
    assert w.grad is not None and bool((w.grad != 0).any())


def test_bf16_rounding_points():
    """dW comes back in w's dtype from xmᵀ·bf16(g); dX uses the f32 1/keep,
    not the bf16-rounded one of the forward."""
    rng = np.random.default_rng(4)
    rate = 0.3  # bf16(1/0.7) != f32(1/0.7)
    x = _randn(rng, 40, 36).bfloat16().requires_grad_(True)
    w = _randn(rng, 36, 5).bfloat16().requires_grad_(True)
    g = _randn(rng, 40, 5)
    cf.dropout_matmul(x, w, 3, rate).backward(g)
    xm = cd.dropout(x.detach(), 3, rate)
    assert w.grad.dtype == torch.bfloat16 and x.grad.dtype == torch.bfloat16
    want_dw = (xm.float().T @ g.bfloat16().float()).bfloat16()
    assert torch.equal(w.grad, want_dw)
    keep = xm != 0
    gw = g @ w.detach().float().T
    want_dx = torch.where(keep, gw * (1 / (1 - rate)), 0.0).bfloat16()
    assert torch.equal(x.grad, want_dx)
    bf16_inv = cd._inv_keep(rate, torch.bfloat16)
    assert not torch.equal(x.grad, torch.where(keep, gw * bf16_inv, 0.0).bfloat16())


@pytest.mark.parametrize("shape", [(96, 200), (300, 513)])
def test_matches_jax_on_an_all_keep_mask(shape, monkeypatch):
    rng = np.random.default_rng(5)
    n, k = shape
    m, rate = 24, 0.4
    xn = rng.standard_normal((n, k)).astype(np.float32)
    r = (6.0 / (k + m)) ** 0.5  # a Glorot-range weight, as a GCN layer's
    wn = rng.uniform(-r, r, (k, m)).astype(np.float32)
    gn = (0.1 * rng.standard_normal((n, m))).astype(np.float32)  # a gradient's scale
    seed = jnp.asarray(42, jnp.int32)

    def loss(x, w):
        return jnp.vdot(pallas_fused.dropout_matmul(x, w, seed, rate, True), jnp.asarray(gn))

    jy = pallas_fused.dropout_matmul(jnp.asarray(xn), jnp.asarray(wn), seed, rate, True)
    jdx, jdw = jax.grad(loss, argnums=(0, 1))(jnp.asarray(xn), jnp.asarray(wn))
    monkeypatch.setattr(cd, "keep_mask",
                        lambda seed, rate, shape, device: torch.ones(shape, dtype=torch.bool))
    x = torch.from_numpy(xn).requires_grad_(True)
    w = torch.from_numpy(wn).requires_grad_(True)
    y = cf.dropout_matmul(x, w, 42, rate)
    y.backward(torch.from_numpy(gn))
    for got, want in ((y.detach(), jy), (x.grad, jdx), (w.grad, jdw)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_argument_errors_and_launch_counts():
    x, w = torch.ones(8, 4), torch.ones(4, 2)
    before = dict(cf.launches)
    cf.dropout_matmul(x, w, 1, 0.5)
    assert cf.launches == before  # CPU tensors never count as launches
    with pytest.raises(ValueError, match="rate"):
        cf.dropout_matmul(x, w, 1, 0.0)
    with pytest.raises(ValueError, match="unsupported device"):
        cf.dropout_matmul(x.to("meta"), w.to("meta"), 1, 0.5)


def test_dw_splits_cover_the_rows():
    for n, k, m in ((233472, 600, 41), (1001, 257, 24), (5, 3, 2), (64, 64, 48)):
        for blocks in (1, 132, 264, 528):
            for dtype in (torch.bfloat16, torch.float32):
                splits, rows = cf.dw_splits(n, k, m, blocks, dtype)
                assert rows % 64 == 0 and (splits - 1) * rows < n <= splits * rows


@pytest.mark.parametrize("k", [8, 16, 64, 257, 320, 321, 600, 602, 1433, 3703])
def test_dw_slab_is_the_fewest_slabs_of_at_most_320_columns(k):
    slab = cf.dw_slab(k)
    slabs = -(-k // slab)
    assert slab % 64 == 0 and 64 <= slab <= 320
    assert slabs == -(-k // 320) and (slabs - 1) * slab < k


# ragged shapes for the card: n not a multiple of any row tile, k not a
# multiple of 4 or 8, W chunked (k = 1433 at m 47 and 72), m around 16, 48
# and 64 (72: the bf16 forward's second W chunk, dW's second column block
# and dX's CUDA-core path)
CARD_SHAPES = [((1001, 257, 24), torch.float32, 0.3), ((517, 600, 41), torch.bfloat16, 0.3),
               ((517, 602, 7), torch.bfloat16, 0.1), ((777, 257, 16), torch.bfloat16, 0.6),
               ((333, 1433, 47), torch.bfloat16, 0.1), ((1001, 600, 72), torch.bfloat16, 0.6),
               ((333, 1433, 72), torch.float32, 0.6), ((517, 602, 41), torch.float32, 0.1),
               ((777, 600, 7), torch.float32, 0.6), ((1001, 257, 47), torch.float32, 0.1)]


@pytest.mark.cuda
def test_kernels_match_plain_on_card(cuda_device):
    rng = np.random.default_rng(6)
    for (n, k, m), dtype, rate in CARD_SHAPES:
        x = _randn(rng, n, k).to(dtype).to(cuda_device)
        w = _randn(rng, k, m).to(dtype).to(cuda_device)
        g = _randn(rng, n, m).to(cuda_device)
        eye = torch.eye(k, dtype=dtype, device=cuda_device)
        assert torch.equal(cf._fwd(x, eye, SEED, rate), cd.dropout(x, SEED, rate).float())
        rtol = 1e-4 if dtype == torch.float32 else 2e-3
        got = cf._fwd(x, w, SEED, rate)
        assert torch.equal(got, cf._fwd(x, w, SEED, rate))
        torch.testing.assert_close(got, cf.dropout_matmul_plain(x, w, SEED, rate),
                                   rtol=rtol, atol=1e-4)
        got = cf._dw(x, g, SEED, rate, dtype)
        assert torch.equal(got, cf._dw(x, g, SEED, rate, dtype))
        torch.testing.assert_close(got.float(),
                                   cf.dropout_matmul_dw_plain(x, g, SEED, rate, dtype).float(),
                                   rtol=rtol, atol=1e-3)
        got = cf._dx(g, w, SEED, rate, dtype)
        assert torch.equal(got, cf._dx(g, w, SEED, rate, dtype))
        torch.testing.assert_close(got.float(),
                                   cf.dropout_matmul_dx_plain(g, w, SEED, rate, dtype).float(),
                                   rtol=rtol, atol=1e-4)


# ---------------------------------------------------------------------------
# Plain models of the bf16 kernels' data movement (csrc/dropout_matmul.cu):
# which row, column and Philox counter each thread's registers hold, built
# from the kernels' own index expressions, and mma.sync.m16n8k16 and
# ldmatrix.trans by their PTX definitions. Values are small integers (or
# f32 split into bf16 terms) so that float64 sums are exact.

_LANES = np.arange(32)
_G, _Q = _LANES >> 2, _LANES & 3
_THR = cd.keep_threshold(0.3)


def _mma(a, b):
    """D = A·B of one mma.sync.m16n8k16 from the lanes' registers: a [32, 4,
    2] (a0..a3, low and high half), b [32, 2, 2] (b0, b1)."""
    A = np.zeros((16, 16))
    B = np.zeros((16, 8))
    for h in range(2):
        A[_G, 2 * _Q + h] = a[:, 0, h]
        A[_G + 8, 2 * _Q + h] = a[:, 1, h]
        A[_G, 2 * _Q + 8 + h] = a[:, 2, h]
        A[_G + 8, 2 * _Q + 8 + h] = a[:, 3, h]
        B[2 * _Q + h, _G] = b[:, 0, h]
        B[2 * _Q + 8 + h, _G] = b[:, 1, h]
    return A @ B


def _c_frag(d):
    """The lanes' accumulator registers [32, 4] of D [16, 8]: c[2h + j] is
    D[g + 8h][2q + j]."""
    return np.stack([d[_G + 8 * (i >> 1), 2 * _Q + (i & 1)] for i in range(4)], axis=1)


def _ldsm_trans(rows):
    """ldmatrix.x4.trans: rows [32, 8], the 8 values at the address lane l
    gives (row l & 7 of matrix l >> 3); returns [32, 4, 2], lane t's
    register i = (M_i[2q][g], M_i[2q + 1][g])."""
    m = rows.reshape(4, 8, 8)
    return np.stack([np.stack([m[i, 2 * _Q, _G], m[i, 2 * _Q + 1, _G]], axis=1)
                     for i in range(4)], axis=1)


def _keep_bits(seed, b, k4):
    """The kernels' keep bits [..., 4] of flat elements b .. b+3: one Philox
    counter b >> 2 when k4 (k % 4 == 0, b a multiple of 4), else
    Mask::keep4's two counters."""
    b = np.asarray(b, np.int64)
    flat = b[..., None] + np.arange(4)
    if k4:
        assert (b % 4 == 0).all()
        ctr = np.repeat(b[..., None] >> 2, 4, axis=-1)
    else:
        ctr = flat >> 2
    ct = torch.from_numpy(ctr.reshape(-1))
    words = cd.philox4x32_10(ct & 0xFFFFFFFF, ct >> 32, torch.zeros_like(ct),
                             torch.zeros_like(ct), seed & 0xFFFFFFFF, seed >> 32)
    w = torch.stack(words, 1).numpy()[np.arange(ct.numel()), (flat & 3).reshape(-1)]
    return (w < _THR).reshape(flat.shape)


def _small_ints(rng, *shape):
    return rng.integers(-3, 4, shape).astype(np.float64)


def _xswz(r):
    return (r & 3) << 1


def _emulate_fwd(x, w, seed, inv_keep):
    """fwd_mma_kernel (kKC 64, kNB 64, kWBytes 64 KB): each warp's 16-row
    tiles through its ring, with the visit count of every x element."""
    n, k = x.shape
    m = w.shape[1]
    out = np.zeros((n, m))
    seen = np.zeros((n, k), np.int64)
    np_max = (min(64, m) + 15) // 16
    kw_max = 65536 // (np_max * 32) // 64 * 64
    # a thread's staged reads of step s: row g at byte a_off, 4 bf16 there
    a_off = [_G * 128 + (((2 * s + (_Q >> 1)) ^ _xswz(_G)) << 4) + 8 * (_Q & 1)
             for s in range(4)]
    for n0 in range(0, m, 64):
        npp = (min(64, m - n0) + 15) // 16
        for k0w in range(0, k, kw_max):
            kcs = min(kw_max, k - k0w + 63) // 64
            e = np.arange(kcs * 4 * npp * 128)
            reg, ln, sp = e & 3, (e >> 2) & 31, e >> 7
            kk = k0w + 16 * (sp // npp) + 4 * (ln & 3) + 2 * (reg & 1)
            nn = n0 + (2 * (sp % npp) + (reg >> 1)) * 8 + (ln >> 2)
            wf = np.stack([np.where((nn < m) & (kk + h < k),
                                    w[np.minimum(kk + h, k - 1), np.minimum(nn, m - 1)], 0.0)
                           for h in range(2)], -1).reshape(kcs * 4, npp, 32, 4, 2)
            for tile in range(-(-n // 16)):
                acc = np.zeros((8, 32, 4))
                row = tile * 16 + _G
                for kc in range(kcs):
                    for s in range(4):
                        # the staged byte offset back to (row, column): pieces
                        # of 16 bytes at p ^ xswz(row)
                        r_st, b_st = a_off[s] // 128, a_off[s] % 128
                        col = k0w + kc * 64 + 8 * ((b_st >> 4) ^ _xswz(r_st)) + (b_st & 15) // 2
                        np.testing.assert_array_equal(col, k0w + kc * 64 + 16 * s + 4 * _Q)
                        a = np.zeros((32, 4, 2))
                        for hh, r in ((0, row), (1, row + 8)):
                            cols = col[:, None] + np.arange(4)
                            ok = (r[:, None] < n) & (cols < k)
                            v = np.where(ok, x[np.minimum(r, n - 1)[:, None],
                                               np.minimum(cols, k - 1)], 0.0)
                            live = (r < n) & (col < k)
                            bits = _keep_bits(seed, np.where(live, r * k + col, 0), k % 4 == 0)
                            v = np.where(live[:, None] & bits, v * inv_keep, 0.0)
                            if n0 == 0:
                                np.add.at(seen, (np.minimum(r, n - 1)[:, None].repeat(4, 1)[ok],
                                                 cols[ok]), 1)
                            a[:, hh, :] = v[:, :2]       # a0 / a1: columns 4q, 4q+1
                            a[:, 2 + hh, :] = v[:, 2:]   # a2 / a3: columns 4q+2, 4q+3
                        for pp in range(npp):
                            b = wf[kc * 4 + s, pp]
                            acc[2 * pp] += _c_frag(_mma(a, b[:, 0:2]))
                            acc[2 * pp + 1] += _c_frag(_mma(a, b[:, 2:4]))
                for t in range(2 * npp):
                    for i in range(4):
                        r = row + 8 * (i >> 1)
                        c = n0 + t * 8 + 2 * _Q + (i & 1)
                        ok = (r < n) & (c < m)
                        out[r[ok], c[ok]] += acc[t][ok, i]
    return out, seen


K_CASES = [600, 602, 257, 1433]


@pytest.mark.parametrize("k", K_CASES)
def test_forward_fragment_model_reads_each_x_once_with_k1_mask(k):
    """The forward's fragments (permuted k order, W in fragment order, the
    mask in registers, one Philox counter per 4 columns when k % 4 == 0)
    give xm·W: each x element read once, the mask K1's."""
    rng = np.random.default_rng(k)
    n, m, seed, rate = 133, 24, 77, 0.3
    x, w = _small_ints(rng, n, k), _small_ints(rng, k, m)
    out, seen = _emulate_fwd(x, w, seed, 2.0)
    assert (seen == 1).all()
    keep = cd.keep_mask(seed, rate, (n, k), "cpu").numpy()
    np.testing.assert_array_equal(out, (np.where(keep, 2.0 * x, 0.0)) @ w)


def _split3(g):
    """g (f32) as the three bf16 terms dx_mma_kernel multiplies: hi, mid,
    lo, each as f32."""
    g = torch.as_tensor(g, dtype=torch.float32)
    hi = g.bfloat16().float()
    r = g - hi
    mid = r.bfloat16().float()
    lo = (r - mid).bfloat16().float()
    return hi, mid, lo


def _emulate_dx(gm, w, seed, inv_keep):
    """dx_mma_kernel (kDxRows 64, 8 warps = 4 row groups × 2 column
    halves): g's three terms, W in fragment order with the pair's permuted
    columns, the epilogue's Philox groups; dX before rounding and the visit
    count of every output."""
    n, m = gm.shape
    k = w.shape[0]
    ks = -(-m // 16)
    cw_max = 65536 // (ks * 512) * 16
    terms = [t.double().numpy() for t in reversed(_split3(gm))]  # lo, mid, hi
    out = np.zeros((n, k))
    seen = np.zeros((n, k), np.int64)
    for c0w in range(0, k, cw_max):
        pairs = -(-min(cw_max, k - c0w) // 16)
        e = np.arange(pairs * ks * 128)
        reg, ln, ps = e & 3, (e >> 2) & 31, e >> 7
        gg = ln >> 2
        col = c0w + 16 * (ps // ks) + 4 * (gg >> 1) + (gg & 1) + 2 * (reg >> 1)
        j = 16 * (ps % ks) + 8 * (reg & 1) + 2 * (ln & 3)
        wf = np.stack([np.where((col < k) & (j + h < m),
                                w[np.minimum(col, k - 1), np.minimum(j + h, m - 1)], 0.0)
                       for h in range(2)], -1).reshape(pairs, ks, 32, 4, 2)
        for tile in range(-(-n // 64)):
            for warp in range(8):
                row = tile * 64 + (warp & 3) * 16 + _G
                a = np.zeros((3, ks, 32, 4, 2))
                for t in range(3):
                    for s in range(ks):
                        for rg in range(4):
                            r = row + 8 * (rg & 1)
                            for h in range(2):
                                jj = 16 * s + 2 * _Q + 8 * (rg >> 1) + h
                                ok = (r < n) & (jj < m)
                                a[t, s, :, rg, h] = np.where(
                                    ok, terms[t][np.minimum(r, n - 1), np.minimum(jj, m - 1)], 0.0)
                for pr in range(warp >> 2, pairs, 2):
                    da = sum(_mma(a[t, s], wf[pr, s][:, 0:2]) for t in range(3) for s in range(ks))
                    db = sum(_mma(a[t, s], wf[pr, s][:, 2:4]) for t in range(3) for s in range(ks))
                    ca, cb = _c_frag(da), _c_frag(db)
                    col0 = c0w + 16 * pr + 4 * _Q
                    for h in range(2):
                        orow = row + 8 * h
                        vals = np.stack([ca[:, 2 * h], ca[:, 2 * h + 1],
                                         cb[:, 2 * h], cb[:, 2 * h + 1]], 1)
                        live = (orow < n) & (col0 < k)
                        bits = _keep_bits(seed, np.where(live, orow * k + col0, 0), k % 4 == 0)
                        for t in range(4):
                            ok = live & (col0 + t < k)
                            out[orow[ok], col0[ok] + t] = np.where(
                                bits[ok, t], vals[ok, t] * inv_keep, 0.0)
                            seen[orow[ok], col0[ok] + t] += 1
    return out, seen


@pytest.mark.parametrize("k", K_CASES)
def test_dx_fragment_model_writes_each_output_once_with_k1_mask(k):
    """dX's permuted output columns cover [n, k] once, each group of 4
    under K1's Philox counter, and the three bf16 terms give g·Wᵀ."""
    rng = np.random.default_rng(k + 1)
    n, m, seed, rate = 70, 41, 78, 0.3
    g = rng.standard_normal((n, m)).astype(np.float32)
    w = _small_ints(rng, k, m)
    out, seen = _emulate_dx(g, w, seed, 2.0)
    assert (seen == 1).all()
    keep = cd.keep_mask(seed, rate, (n, k), "cpu").numpy()
    want = np.where(keep, 2.0 * (g.astype(np.float64) @ w.T), 0.0)
    np.testing.assert_allclose(out, want, rtol=1e-12, atol=1e-12)


def test_dx_split_terms_reproduce_the_f32_product():
    """g = hi + mid + lo exactly; the three bf16-term products summed in f32
    are within 1e-6 of the f32 g·Wᵀ before rounding, and within one bf16
    ulp of dropout_matmul_dx_plain after the mask and dX's bf16 rounding."""
    rng = np.random.default_rng(9)
    n, k, m, rate, seed = 500, 600, 41, 0.1, 0x2545
    g = torch.from_numpy((rng.standard_normal((n, m)) / n).astype(np.float32))
    w = torch.from_numpy(rng.uniform(-0.1, 0.1, (k, m)).astype(np.float32)).bfloat16()
    terms = _split3(g)
    np.testing.assert_array_equal(sum(t.double() for t in terms).numpy(), g.double().numpy())
    for t in terms:
        assert torch.equal(t.bfloat16().float(), t)
    ref = g @ w.float().T
    split = sum(t @ w.float().T for t in reversed(terms))
    torch.testing.assert_close(split, ref, rtol=1e-6, atol=1e-6 * float(ref.abs().max()))
    keep = cd.keep_mask(seed, rate, (n, k), "cpu")
    got = torch.where(keep, split * (1.0 / (1.0 - rate)), 0.0).bfloat16().float()
    want = cf.dropout_matmul_dx_plain(g, w, seed, rate, torch.bfloat16).float()
    assert bool(((got - want).abs() <= 2.0**-7 * want.abs()).all())


def _emulate_dw(x, g, seed, inv_keep, blocks):
    """dw_mma_kernel (kDwRows 64): splits from dw_splits(blocks), x slabs of
    dw_slab(k) columns staged row-swizzled (piece p of row r at p ^ (r & 7)) and
    masked in place by each thread's fixed pieces, ldmatrix.trans
    fragments of xm and bf16 g, the partials summed in split order; the
    visit count of every masked x element."""
    n, k = x.shape
    m = g.shape[1]
    slab = cf.dw_slab(k)
    pieces = slab // 8
    splits, rows = cf.dw_splits(n, k, m, blocks)
    gb_all = torch.from_numpy(g).float().bfloat16().double().numpy()
    ws = np.zeros((splits, k, m))
    seen = np.zeros((n, k), np.int64)
    tid = np.arange(slab)
    xp, xr = tid % pieces, tid // pieces
    for sp in range(splits):
        rs0, rs1 = sp * rows, min(sp * rows + rows, n)
        for cs0 in range(0, k, slab):
            for n0 in range(0, m, 48):
                npp = (min(48, m - n0) + 15) // 16
                acc = np.zeros((slab // 32, 2, 6, 32, 4))
                for r0 in range(rs0, rs1, 64):
                    # stage[r][physical piece][8]: x's logical piece p at p ^ (r & 7)
                    stage = np.zeros((64, pieces, 8))
                    for i in range(8):
                        r = xr + 8 * i
                        row, col = r0 + r, cs0 + 8 * xp
                        cols = col[:, None] + np.arange(8)
                        ok = (row[:, None] < rs1) & (cols < k)
                        v = np.where(ok, x[np.minimum(row, n - 1)[:, None],
                                           np.minimum(cols, k - 1)], 0.0)
                        live = (row < rs1) & (col < k)
                        b = np.where(live, row * k + col, 0)
                        bits = np.concatenate([_keep_bits(seed, b, k % 4 == 0),
                                               _keep_bits(seed, b + 4, k % 4 == 0)], 1)
                        v = np.where(live[:, None] & bits, v * inv_keep, 0.0)
                        if n0 == 0:
                            np.add.at(seen, (np.minimum(row, n - 1)[:, None].repeat(8, 1)[ok],
                                             cols[ok]), 1)
                        stage[r, xp ^ (r & 7)] = v
                    gb = np.zeros((64, 56))
                    for r in range(min(64, rs1 - r0)):
                        cols = np.arange(n0, min(n0 + 48, m))
                        gb[r, cols - n0] = gb_all[r0 + r, cols]
                    for warp in range(slab // 32):
                        for s in range(4):
                            mj, mr = _LANES >> 3, _LANES & 7
                            ra = 16 * s + mr + 8 * (mj >> 1)
                            a = []
                            for mt in range(2):
                                pa = (warp * 32 + mt * 16) // 8 + (mj & 1)
                                a.append(_ldsm_trans(stage[ra, pa ^ (ra & 7)]))
                            rb = 16 * s + mr + 8 * (mj & 1)
                            for pp in range(npp):
                                nc = (2 * pp + (mj >> 1)) * 8
                                b = _ldsm_trans(gb[rb[:, None], nc[:, None] + np.arange(8)])
                                for mt in range(2):
                                    acc[warp, mt, 2 * pp] += _c_frag(_mma(a[mt], b[:, 0:2]))
                                    acc[warp, mt, 2 * pp + 1] += _c_frag(_mma(a[mt], b[:, 2:4]))
                for warp in range(slab // 32):
                    for mt in range(2):
                        for t in range(2 * npp):
                            for i in range(4):
                                kc = cs0 + warp * 32 + mt * 16 + _G + 8 * (i >> 1)
                                c = n0 + t * 8 + 2 * _Q + (i & 1)
                                ok = (kc < k) & (c < m)
                                ws[sp, kc[ok], c[ok]] = acc[warp, mt, t][ok, i]
    return sum(ws[i] for i in range(splits)), seen


@pytest.mark.parametrize("k", K_CASES)
def test_dw_fragment_model_masks_each_x_once_with_k1_mask(k):
    """dW's staging masks every x element once per column block with K1's
    bits (8 elements, two Philox counters, a thread-piece), and its
    ldmatrix.trans fragments over the swizzled stage give xmᵀ·bf16(g)."""
    rng = np.random.default_rng(k + 2)
    n, m, seed, rate = 150, 41, 79, 0.3
    x, g = _small_ints(rng, n, k), _small_ints(rng, n, m)
    dw, seen = _emulate_dw(x, g, seed, 2.0, blocks=4 * -(-k // cf.dw_slab(k)))
    assert (seen == 1).all()
    keep = cd.keep_mask(seed, rate, (n, k), "cpu").numpy()
    np.testing.assert_array_equal(dw, np.where(keep, 2.0 * x, 0.0).T @ g)
