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
        splits, rows = cf.dw_splits(n, k, m)
        assert rows % 64 == 0 and (splits - 1) * rows < n <= splits * rows


@pytest.mark.cuda
def test_kernels_match_plain_on_card(cuda_device):
    rng = np.random.default_rng(6)
    for (n, k, m), dtype in (((1001, 257, 24), torch.float32),
                             ((517, 600, 41), torch.bfloat16)):
        x = _randn(rng, n, k).to(dtype).to(cuda_device)
        w = _randn(rng, k, m).to(dtype).to(cuda_device)
        g = _randn(rng, n, m).to(cuda_device)
        eye = torch.eye(k, dtype=dtype, device=cuda_device)
        assert torch.equal(cf._fwd(x, eye, SEED, 0.3), cd.dropout(x, SEED, 0.3).float())
        rtol = 1e-4 if dtype == torch.float32 else 2e-3
        torch.testing.assert_close(cf._fwd(x, w, SEED, 0.3),
                                   cf.dropout_matmul_plain(x, w, SEED, 0.3),
                                   rtol=rtol, atol=1e-4)
        torch.testing.assert_close(cf._dw(x, g, SEED, 0.3, dtype).float(),
                                   cf.dropout_matmul_dw_plain(x, g, SEED, 0.3, dtype).float(),
                                   rtol=rtol, atol=1e-3)
        torch.testing.assert_close(cf._dx(g, w, SEED, 0.3, dtype).float(),
                                   cf.dropout_matmul_dx_plain(g, w, SEED, 0.3, dtype).float(),
                                   rtol=rtol, atol=1e-4)
