"""parallel_gcn_tpu_torch dropout (K1) and fused ReLU→dropout (K2).

The port's mask contract (ops/cuda_dropout.py): Philox4x32-10 keyed by the
64-bit seed, counter i >> 2, word i & 3, keep iff word < thr. On the CPU the
wrappers run the plain int64 torch Philox; it must equal an independent
numpy Philox4x32-10 (checked against Random123's known-answer vectors) bit
for bit. The TPU kernels' hardware PRNG bits cannot be reproduced, so the
JAX comparison checks the scaling of kept elements only.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from parallel_gcn_tpu.ops.pallas_dropout import dropout_pallas, relu_dropout_pallas
from parallel_gcn_tpu_torch.ops import cuda_dropout as cd

torch.set_num_threads(1)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel; no CPU mode)")
    return torch.device("cuda")


INTERP = pltpu.InterpretParams()
_M32 = np.uint64(0xFFFFFFFF)


def philox_np(c, key):
    """Philox4x32-10 in numpy uint64 (products of two uint32 fit)."""
    c0, c1, c2, c3 = (np.asarray(v, dtype=np.uint64) for v in c)
    k0, k1 = np.uint64(key[0]), np.uint64(key[1])
    m0, m1 = np.uint64(0xD2511F53), np.uint64(0xCD9E8D57)
    for rnd in range(10):
        if rnd:
            k0 = (k0 + np.uint64(0x9E3779B9)) & _M32
            k1 = (k1 + np.uint64(0xBB67AE85)) & _M32
        p0, p1 = m0 * c0, m1 * c2
        c0, c1, c2, c3 = ((p1 >> np.uint64(32)) ^ c1 ^ k0, p1 & _M32,
                          (p0 >> np.uint64(32)) ^ c3 ^ k1, p0 & _M32)
    return c0, c1, c2, c3


def words_np(seed, n):
    ctr = np.arange((n + 3) // 4, dtype=np.uint64)
    z = np.zeros_like(ctr)
    out = philox_np((ctr & _M32, ctr >> np.uint64(32), z, z),
                    (seed & 0xFFFFFFFF, seed >> 32))
    return np.stack(out, axis=1).reshape(-1)[:n]


@pytest.mark.parametrize("ctr,key,want", [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
])
def test_philox_known_answers(ctr, key, want):
    """Random123's kat_vectors for philox4x32_10, numpy and torch."""
    assert tuple(int(v) for v in philox_np([[c] for c in ctr], key)) == want
    got = cd.philox4x32_10(*(torch.tensor([c], dtype=torch.int64) for c in ctr), *key)
    assert tuple(int(v) for v in got) == want


@pytest.mark.parametrize("seed,n", [(0, 1), (7, 4099), (0xDEADBEEF12345678, 10_001)])
def test_torch_philox_words_match_numpy(seed, n):
    got = cd.philox_words(seed, n, "cpu").numpy().astype(np.uint64)
    np.testing.assert_array_equal(got, words_np(seed, n))


def test_counter_high_word_matches_numpy():
    """Counters above 2³² put their high half in the second counter word."""
    ctr = np.array([2**32 - 1, 2**32, 2**40 + 5], dtype=np.uint64)
    z = np.zeros_like(ctr)
    want = philox_np((ctr & _M32, ctr >> np.uint64(32), z, z), (3, 9))
    t = torch.from_numpy(ctr.astype(np.int64))
    zt = torch.zeros_like(t)
    got = cd.philox4x32_10(t & 0xFFFFFFFF, t >> 32, zt, zt, 3, 9)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy().astype(np.uint64), w)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("relu", [False, True])
def test_dropout_equals_numpy_contract(dtype, relu):
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((123, 77)).astype(np.float32)).to(dtype)
    seed, rate = 0x0123_4567_89AB_CDEF, 0.3
    out = cd.relu_dropout(x, seed, rate) if relu else cd.dropout(x, seed, rate)
    keep = words_np(seed, x.numel()).reshape(x.shape) < cd.keep_threshold(rate)
    if relu:
        keep &= x.float().numpy() > 0
    inv = torch.tensor(1 / (1 - rate), dtype=dtype)
    want = torch.where(torch.from_numpy(keep), x * inv, torch.zeros((), dtype=dtype))
    assert torch.equal(out, want)
    assert out.dtype == dtype


def _contract(x, seed, rate, relu):
    """The mask contract by the numpy Philox, on x's own flat index."""
    keep = words_np(seed, x.numel()).reshape(x.shape) < cd.keep_threshold(rate)
    if relu:
        keep &= x.float().numpy() > 0
    inv = torch.tensor(1 / (1 - rate), dtype=x.dtype)
    return torch.where(torch.from_numpy(keep), x * inv, torch.zeros((), dtype=x.dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("r", range(1, 8))
def test_contract_on_lengths_off_the_vector_width(dtype, r):
    """n ≡ r (mod 8): the last n % 8 (bf16) or n % 4 (f32) elements are the
    kernel's scalar tail; K1, K2 and K1's backward keep the contract."""
    n = 8 * 129 + r
    rng = np.random.default_rng(r)
    x = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(dtype)
    g = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(dtype)
    seed, rate = 0xFEDC_BA98_7654_3210, 0.4
    assert torch.equal(cd.dropout(x, seed, rate), _contract(x, seed, rate, False))
    assert torch.equal(cd.relu_dropout(x, seed, rate), _contract(x, seed, rate, True))
    xr = x.clone().requires_grad_()
    cd.dropout(xr, seed, rate).backward(g)
    assert torch.equal(xr.grad, _contract(g, seed, rate, False))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("offset", [1, 3, 6])
def test_contract_on_a_view_with_storage_offset(dtype, offset):
    """A contiguous view whose data does not start on a 16-byte boundary:
    the mask follows the view's own flat index, as for a fresh tensor."""
    rng = np.random.default_rng(offset)
    base = torch.from_numpy(rng.standard_normal(offset + 63 * 17).astype(np.float32)).to(dtype)
    x = base[offset:].view(63, 17)
    assert x.is_contiguous() and x.storage_offset() == offset
    seed, rate = 0x0BAD_5EED, 0.3
    for relu in (False, True):
        fn = cd.relu_dropout if relu else cd.dropout
        want = _contract(x, seed, rate, relu)
        assert torch.equal(fn(x, seed, rate), want)
        assert torch.equal(fn(x.clone(), seed, rate), want)


def test_keep_threshold_matches_pallas():
    assert cd.keep_threshold(0.1) == min(int(round(0.9 * 2.0**32)), 2**32 - 1)
    assert cd.keep_threshold(0.0) == 2**32 - 1


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_keep_rate_within_binomial_bounds(rate):
    n = 200_000
    out = cd.dropout(torch.ones(n // 100, 100), 42, rate)
    kept = int((out != 0).sum())
    sd = (n * rate * (1 - rate)) ** 0.5
    assert abs(kept - n * (1 - rate)) < 5 * sd
    assert not torch.equal(out, cd.dropout(torch.ones(n // 100, 100), 43, rate))


def test_relu_dropout_equals_dropout_of_relu():
    x = torch.randn(300, 129, generator=torch.Generator().manual_seed(3))
    for seed in (1, 2**40 + 3):
        assert torch.equal(cd.relu_dropout(x, seed, 0.4),
                           cd.dropout(torch.relu(x), seed, 0.4))


def test_dropout_backward_reuses_forward_mask():
    x = torch.randn(200, 50, generator=torch.Generator().manual_seed(4)).requires_grad_()
    g = torch.randn(200, 50, generator=torch.Generator().manual_seed(5))
    out = cd.dropout(x, 11, 0.3)
    out.backward(g)
    assert torch.equal(x.grad != 0, out != 0)
    assert torch.equal(x.grad, cd.dropout(g, 11, 0.3))


def test_relu_dropout_backward_from_output():
    x = torch.randn(200, 50, generator=torch.Generator().manual_seed(6)).requires_grad_()
    g = torch.randn(200, 50, generator=torch.Generator().manual_seed(7))
    out = cd.relu_dropout(x, 9, 0.25)
    out.backward(g)
    want = torch.where(out > 0, g * torch.tensor(1 / 0.75), torch.zeros(()))
    assert torch.equal(x.grad, want)
    assert (x.grad[x <= 0] == 0).all()


def test_rate_zero_is_identity():
    x = torch.randn(10, 7)
    before = dict(cd.launches)
    assert cd.dropout(x, 1, 0.0) is x
    assert torch.equal(cd.relu_dropout(x, 1, 0.0), torch.relu(x))
    cd.dropout(x, 1, 0.5)
    assert cd.launches == before  # CPU tensors never count as launches


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_kept_values_match_jax_scaling(dtype):
    """JAX's Pallas kernels in interpret mode keep every element (degenerate
    bits); the port's kept elements must equal them bit for bit, including
    1/keep rounded to the input dtype."""
    rng = np.random.default_rng(8)
    xn = rng.standard_normal((64, 96)).astype(np.float32)
    xj = jnp.asarray(xn, dtype)
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(
        torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32)
    seed, rate = jnp.asarray(5, jnp.int32), 0.1
    for jfn, tfn in ((dropout_pallas, cd.dropout), (relu_dropout_pallas, cd.relu_dropout)):
        j = np.asarray(jfn(xj, seed, rate, INTERP).astype(jnp.float32))
        t = tfn(xt, 5, rate).float().numpy()
        kept = t != 0
        assert kept.mean() > 0.4
        np.testing.assert_array_equal(t[kept], j[kept])


def test_non_cpu_non_cuda_tensor_raises():
    with pytest.raises(ValueError, match="unsupported device"):
        cd.dropout(torch.empty(4, 4, device="meta"), 1, 0.5)


@pytest.mark.cuda
def test_kernel_matches_plain_on_card(cuda_device):
    x = torch.randn(1001, 257, device=cuda_device)
    for relu in (False, True):
        fn = cd.relu_dropout if relu else cd.dropout
        assert torch.equal(fn(x, 77, 0.3), cd.dropout_plain(x, 77, 0.3, relu))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_bit_equal_on_ragged_and_misaligned_views(cuda_device, dtype):
    """K1, K2 and K1's backward on the card, bit for bit against the plain
    version: lengths n ≡ 0…7 (mod 8) and views whose data starts 0…3
    elements past a 16-byte boundary (the kernel's scalar path)."""
    gen = torch.Generator().manual_seed(12)
    seed, rate = 0x1234_5678_9ABC, 0.1
    for r in range(8):
        for offset in range(4):
            n = 8 * 40_001 + r
            x = torch.randn(offset + n, generator=gen).to(dtype).to(cuda_device)[offset:]
            g = torch.randn(offset + n, generator=gen).to(dtype).to(cuda_device)[offset:]
            for relu in (False, True):
                fn = cd.relu_dropout if relu else cd.dropout
                assert torch.equal(fn(x, seed, rate), cd.dropout_plain(x, seed, rate, relu))
            xr = x.clone().requires_grad_()
            cd.dropout(xr, seed, rate).backward(g)
            assert torch.equal(xr.grad, cd.dropout_plain(g, seed, rate))
