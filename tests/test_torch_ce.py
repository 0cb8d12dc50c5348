"""parallel_gcn_tpu_torch fused masked softmax-CE (K9) against the JAX package.

The port's plain version (which the wrapper runs for CPU tensors) against
JAX's ``masked_softmax_xent_fused`` with the Pallas kernel in interpret
mode, on the same numpy inputs: loss within rtol 1e-5 (sums in another
order), accuracy exact, gradients within rtol 2e-5 / atol 1e-7 (the JAX
test's own bounds). Plus the kernel's tie rule, inert padding and the eval
variant under ``no_grad``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import parallel_gcn_tpu.ops.pallas_ce as pce
from parallel_gcn_tpu_torch.ops import cuda_ce
from parallel_gcn_tpu_torch.ops.loss import masked_softmax_xent

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def interpret_mode():
    old = pce._INTERPRET[0]
    pce._INTERPRET[0] = True
    yield
    pce._INTERPRET[0] = old


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel; no CPU mode)")
    return torch.device("cuda")


def _case(n, c, seed=0):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((n, c)).astype(np.float32) * 3
    labels = rng.integers(0, c, n).astype(np.int32)
    mask = rng.random(n) < 0.4
    return logits, labels, mask, max(int(mask.sum()), 1)


def _torch(logits, labels, mask):
    return (torch.from_numpy(logits), torch.from_numpy(labels.astype(np.int64)),
            torch.from_numpy(mask))


@pytest.mark.parametrize("n,c", [(1024, 41), (1024, 7), (700, 41), (512, 3)])
def test_loss_and_accuracy_match_jax(n, c):
    logits, labels, mask, num = _case(n, c)
    jl, ja = pce.masked_softmax_xent_fused(jnp.asarray(logits), jnp.asarray(labels),
                                           jnp.asarray(mask), num)
    tl, ta = cuda_ce.masked_softmax_xent_fused(*_torch(logits, labels, mask), num)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    assert float(ta) == float(ja)
    assert tl.dtype == ta.dtype == torch.float32


@pytest.mark.parametrize("n,c", [(1024, 41), (700, 5)])
def test_gradient_matches_jax_grad(n, c):
    logits, labels, mask, num = _case(n, c, seed=3)
    jl, jlab, jm = jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(mask)
    for scale in (1.0, 3.0):
        want = jax.grad(
            lambda l: scale * pce.masked_softmax_xent_fused(l, jlab, jm, num)[0])(jl)
        t, tlab, tm = _torch(logits, labels, mask)
        t.requires_grad_(True)
        loss, acc = cuda_ce.masked_softmax_xent_fused(t, tlab, tm, num)
        assert not acc.requires_grad
        (scale * loss).backward()
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(want), rtol=2e-5, atol=1e-7)


def test_padded_rows_are_inert():
    """Rows with mask False and huge logits (padding, label −1) add nothing
    to the loss, the accuracy or the gradient."""
    logits, labels, mask, num = _case(600, 11, seed=5)
    big = np.concatenate([logits, np.full((424, 11), 1e9, np.float32)])
    big_labels = np.concatenate([labels, np.full(424, -1, np.int32)])
    big_mask = np.concatenate([mask, np.zeros(424, bool)])
    a = cuda_ce.masked_softmax_xent_fused(*_torch(logits, labels, mask), num)
    t, tlab, tm = _torch(big, big_labels, big_mask)
    t.requires_grad_(True)
    b = cuda_ce.masked_softmax_xent_fused(t, tlab, tm, num)
    np.testing.assert_allclose(float(b[0].detach()), float(a[0]), rtol=1e-6)
    assert float(b[1]) == float(a[1])
    b[0].backward()
    assert torch.equal(t.grad[600:], torch.zeros(424, 11))


def test_exact_tie_counts_as_correct():
    """K9's accuracy is truth == row max: a tie between the true class and
    another counts as correct (as in JAX's kernel); ops/loss.py takes the
    first argmax and does not."""
    logits = np.zeros((4, 5), np.float32)
    logits[:, 1] = logits[:, 3] = 2.0  # classes 1 and 3 tie for the max
    labels = np.array([3, 3, 1, 0], np.int32)
    mask = np.ones(4, bool)
    _, ja = pce.masked_softmax_xent_fused(jnp.asarray(logits), jnp.asarray(labels),
                                          jnp.asarray(mask), 4)
    _, ta = cuda_ce.masked_softmax_xent_fused(*_torch(logits, labels, mask), 4)
    _, argmax_acc = masked_softmax_xent(*_torch(logits, labels, mask), 4)
    assert float(ta) == float(ja) == 0.75
    assert float(argmax_acc) == 0.25


def test_no_grad_runs_the_eval_variant(monkeypatch):
    calls = []
    plain = cuda_ce.masked_softmax_xent_fused_plain

    def spy(*args):
        calls.append(args[-1])  # write_grad
        return plain(*args)

    monkeypatch.setattr(cuda_ce, "masked_softmax_xent_fused_plain", spy)
    logits, labels, mask, num = _case(256, 7, seed=9)
    t, tlab, tm = _torch(logits, labels, mask)
    t.requires_grad_(True)
    with torch.no_grad():
        loss, _ = cuda_ce.masked_softmax_xent_fused(t, tlab, tm, num)
    assert loss.grad_fn is None and calls == [False]
    loss, _ = cuda_ce.masked_softmax_xent_fused(t, tlab, tm, num)
    assert loss.grad_fn is not None and calls == [False, True]
    # the plain version's gradient is that of the loss expression
    _, _, grad = plain(t, tlab, tm, num, True)
    ref = t.detach().clone().requires_grad_(True)
    masked_softmax_xent(ref, tlab, tm, num)[0].backward()
    torch.testing.assert_close(grad, ref.grad, rtol=2e-5, atol=1e-7)


def test_cpu_tensors_never_count_as_launches():
    before = dict(cuda_ce.launches)
    logits, labels, mask, num = _case(64, 3)
    cuda_ce.masked_softmax_xent_fused(*_torch(logits, labels, mask), num)
    assert cuda_ce.launches == before


def test_non_cpu_non_cuda_tensor_raises():
    meta = torch.empty(4, 3, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_ce.masked_softmax_xent_fused(meta, torch.zeros(4, dtype=torch.int64),
                                          torch.ones(4, dtype=torch.bool), 4)


@pytest.mark.cuda
@pytest.mark.parametrize("c", [41, 100, 7, 16, 47, 64, 72])  # staged rows; the looped path past 64
def test_kernel_matches_plain_on_card(cuda_device, c):
    logits, labels, mask, num = _case(1001, c, seed=4)
    t, tlab, tm = (v.to(cuda_device) for v in _torch(logits, labels, mask))
    for write_grad in (False, True):
        got = cuda_ce._run(t, tlab, tm, num, write_grad)
        again = cuda_ce._run(t, tlab, tm, num, write_grad)
        want = cuda_ce.masked_softmax_xent_fused_plain(t, tlab, tm, num, write_grad)
        torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=0)
        assert float(got[1]) == float(want[1])
        assert all(torch.equal(a, b) for a, b in zip(got, again) if a is not None)
        if write_grad:
            torch.testing.assert_close(got[2], want[2], rtol=2e-5, atol=1e-7)


def _butterfly(vals):
    """A warp's xor-shuffle sum (offsets 16, 8, 4, 2, 1) in f32: lane 0's."""
    lanes = np.arange(32)
    for o in (16, 8, 4, 2, 1):
        vals = (vals + vals[lanes ^ o]).astype(np.float32)
    return vals[0]


def _block_sum(thread_vals):
    """ce_kernel's block_sum2: a butterfly in each of the 8 warps, then the
    warps' sums in warp order (f32)."""
    total = np.float32(0)
    for w in range(8):
        total = np.float32(total + _butterfly(thread_vals[32 * w:32 * w + 32]))
    return total


def _kernel_order_sums(terms):
    """The one-launch sum of ce_kernel over per-row f32 terms [n]: block b
    owns rows 128b .. 128b + 127; its row r is worked by warp (r // 4) % 8
    at lane 8·(r % 4), which adds it to its running sum; the block sums its
    threads (_block_sum) into a partial; the last block's thread t adds
    partials t, t + 256, ... in order, then _block_sum."""
    n = terms.shape[0]
    partials = []
    for b in range(-(-n // 128)):
        acc = np.zeros(256, np.float32)
        for r in range(min(128, n - b * 128)):
            t = ((r // 4) % 8) * 32 + 8 * (r % 4)
            acc[t] = np.float32(acc[t] + terms[b * 128 + r])
        partials.append(_block_sum(acc))
    acc = np.zeros(256, np.float32)
    for i, p in enumerate(partials):
        acc[i % 256] = np.float32(acc[i % 256] + p)
    return _block_sum(acc)


@pytest.mark.parametrize("n", [100, 1001, 40000])
def test_one_launch_block_order_sum_matches_plain_and_jax(n):
    """K9 sums its rows' loss and correct terms in one launch, in a fixed
    order of blocks (a ticket counter picks the last block to finish; the
    order of the sum does not depend on which). That order, modelled in f32
    for 1, 8 and 313 blocks (more than the last block's 256 threads),
    reproduces the plain version and JAX's interpret-mode kernel: loss
    within rtol 1e-5, accuracy exact."""
    logits, labels, mask, num = _case(n, 41, seed=11)
    t = torch.from_numpy(logits)
    lmax = t.amax(1, keepdim=True)
    lse = torch.log(torch.exp(t - lmax).sum(1))
    truth = (t - lmax).gather(1, torch.from_numpy(labels.astype(np.int64))[:, None])[:, 0]
    maskf = torch.from_numpy(mask).float()
    loss_terms = (maskf * (lse - truth)).numpy()
    correct_terms = (maskf * (truth >= 0).float()).numpy()
    loss = np.float32(_kernel_order_sums(loss_terms) / np.float32(num))
    acc = np.float32(_kernel_order_sums(correct_terms) / np.float32(num))
    assert loss == np.float32(_kernel_order_sums(loss_terms) / np.float32(num))
    pl, pa, _ = cuda_ce.masked_softmax_xent_fused_plain(*_torch(logits, labels, mask), num)
    jl, ja = pce.masked_softmax_xent_fused(jnp.asarray(logits), jnp.asarray(labels),
                                           jnp.asarray(mask), num)
    np.testing.assert_allclose(loss, float(pl), rtol=1e-5)
    np.testing.assert_allclose(loss, float(jl), rtol=1e-5)
    assert acc == float(pa) == float(ja)
