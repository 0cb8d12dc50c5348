"""parallel_gcn_tpu_torch SDDMM on BCSR tiles (K8) against the JAX package.

On the CPU the port's op runs its plain PyTorch version (and its backward
the SpMM's plain version); the JAX side runs the Pallas kernels in
TPU-interpret mode, as tests/test_sddmm.py does. Inputs are made with numpy
from a seed. Tolerance rtol/atol 2e-5: the same f32 products (bf16 inputs
are exact in f32) summed in another order.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import parallel_gcn_tpu.ops.pallas_bcsr as pb
from parallel_gcn_tpu.data.graph import build_graph as jax_build_graph
from parallel_gcn_tpu.ops.pallas_sddmm import sddmm_bcsr as jax_sddmm
from parallel_gcn_tpu_torch.data.graph import build_graph, random_graph
from parallel_gcn_tpu_torch.ops import cuda_sddmm as cs

torch.set_num_threads(1)

CPU = torch.device("cpu")
TOL = dict(rtol=2e-5, atol=2e-5)
# (nodes, K, seed): the two graphs of tests/test_sddmm.py
GRAPHS = [(260, 32, 0), (200, 16, 3)]


@pytest.fixture(autouse=True)
def interpret_mode():
    old = pb._INTERPRET[0]
    pb._INTERPRET[0] = True
    yield
    pb._INTERPRET[0] = old


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel; no CPU mode)")
    return torch.device("cuda")


def _packs(n, seed):
    csr, _ = random_graph(n, 6, seed=seed)
    return (build_graph(csr, device=CPU, bcsr=True).bcsr,
            jax_build_graph(csr, bcsr=True).bcsr)


def _inputs(n_nodes, k, seed):
    rng = np.random.default_rng(seed + 1)
    return (rng.standard_normal((n_nodes, k)).astype(np.float32),
            rng.standard_normal((n_nodes, k)).astype(np.float32))


def _dense_tiles(pack, dense):
    tr, tc = pack.tile_r, pack.tile_c
    return np.stack([dense[r * tr:(r + 1) * tr, c * tc:(c + 1) * tc]
                     for r, c in zip(pack.tile_rows.tolist(), pack.tile_cols.tolist())])


@pytest.mark.parametrize("n,k,seed", GRAPHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_jax_interpret(n, k, seed, dtype):
    tp, jp = _packs(n, seed)
    an, bn = _inputs(tp.n_nodes, k, seed)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    want = np.asarray(jax_sddmm(jp, jnp.asarray(an, jdt), jnp.asarray(bn, jdt)))
    tdt = getattr(torch, dtype)
    got = cs.sddmm_bcsr(tp, torch.from_numpy(an).to(tdt), torch.from_numpy(bn).to(tdt))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("n,k,seed", GRAPHS)
def test_grads_match_jax(n, k, seed):
    """d/da, d/db of sum(out ⊙ w_tiles), w_tiles the pack's Â values."""
    tp, jp = _packs(n, seed)
    an, bn = _inputs(tp.n_nodes, k, seed)
    w = np.array(jp.tiles, np.float32)
    np.testing.assert_array_equal(w, tp.tiles.numpy())
    da, db = jax.grad(lambda a, b: jnp.sum(jax_sddmm(jp, a, b) * w), argnums=(0, 1))(
        jnp.asarray(an), jnp.asarray(bn))
    a = torch.from_numpy(an).requires_grad_()
    b = torch.from_numpy(bn).requires_grad_()
    (cs.sddmm_bcsr(tp, a, b) * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(a.grad.numpy(), np.asarray(da), **TOL)
    np.testing.assert_allclose(b.grad.numpy(), np.asarray(db), **TOL)


def test_grads_in_bf16_keep_the_input_dtype():
    tp, _ = _packs(200, 3)
    an, bn = _inputs(tp.n_nodes, 16, 3)
    a = torch.from_numpy(an).bfloat16().requires_grad_()
    b = torch.from_numpy(bn).bfloat16().requires_grad_()
    w = tp.tiles.float()
    (cs.sddmm_bcsr(tp, a, b) * w).sum().backward()
    assert a.grad.dtype == b.grad.dtype == torch.bfloat16
    # dA = W·B with the cotangent tiles rounded to b's dtype (bf16)
    W = np.zeros((tp.n_nodes, tp.n_nodes), np.float32)
    tr = tp.tile_r
    for t, (r, c) in enumerate(zip(tp.tile_rows.tolist(), tp.tile_cols.tolist())):
        W[r * tr:(r + 1) * tr, c * tr:(c + 1) * tr] = w[t].bfloat16().float().numpy()
    want = W @ b.detach().float().numpy()
    np.testing.assert_allclose(a.grad.float().numpy(), want, rtol=8e-3, atol=1e-2)


@pytest.mark.parametrize("n,k,seed", GRAPHS)
def test_plain_matches_dense_product_sliced(n, k, seed):
    tp, _ = _packs(n, seed)
    an, bn = _inputs(tp.n_nodes, k, seed)
    got = cs.sddmm_plain(tp, torch.from_numpy(an), torch.from_numpy(bn), batch=3)
    np.testing.assert_allclose(got.numpy(), _dense_tiles(tp, an @ bn.T), **TOL)


@pytest.mark.parametrize("n,seed", [(260, 0), (200, 3), (300, 5)])
def test_mirror_perm_equals_jax(n, seed):
    tp, jp = _packs(n, seed)
    assert tp.mirror_perm is not None
    np.testing.assert_array_equal(tp.mirror_perm.numpy(), np.asarray(jp.mirror_perm))
    perm = tp.mirror_perm.long()
    assert torch.equal(tp.tile_rows[perm], tp.tile_cols)
    assert torch.equal(perm[perm], torch.arange(len(perm)))


def test_rejects_non_square_tiles_and_missing_mirror():
    csr, _ = random_graph(260, 6, seed=0)
    rect = build_graph(csr, device=CPU, bcsr=True, tile_size=128, tile_cols=256).bcsr
    a = torch.zeros(rect.n_nodes, 4)
    with pytest.raises(ValueError, match="square tiles"):
        cs.sddmm_bcsr(rect, a, a)
    tp, _ = _packs(260, 0)
    a = torch.zeros(tp.n_nodes, 4)
    with pytest.raises(ValueError, match="mirror_perm"):
        cs.sddmm_bcsr(dataclasses.replace(tp, mirror_perm=None), a, a)


def test_rejects_mismatched_inputs():
    tp, _ = _packs(260, 0)
    a = torch.zeros(tp.n_nodes, 4)
    with pytest.raises(ValueError, match="rows"):
        cs.sddmm_bcsr(tp, a[:-1], a)
    with pytest.raises(ValueError, match="differ in K"):
        cs.sddmm_bcsr(tp, a, torch.zeros(tp.n_nodes, 5))
    with pytest.raises(ValueError, match="unsupported device"):
        cs._sddmm_impl(tp, a.to("meta"), a.to("meta"))


def test_cpu_runs_plain_and_counts_no_launch():
    tp, _ = _packs(200, 3)
    an, bn = _inputs(tp.n_nodes, 8, 3)
    before = cs.launches["sddmm"]
    out = cs.sddmm_bcsr(tp, torch.from_numpy(an), torch.from_numpy(bn))
    assert cs.launches["sddmm"] == before
    assert torch.equal(out, cs.sddmm_plain(tp, torch.from_numpy(an), torch.from_numpy(bn)))


@pytest.mark.cuda
def test_kernel_matches_plain_on_card(cuda_device):
    tp, _ = _packs(260, 0)
    pack = tp.to(cuda_device)
    an, bn = _inputs(tp.n_nodes, 41, 0)
    for dtype, rtol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-3)):
        a = torch.from_numpy(an).to(cuda_device, dtype).requires_grad_()
        b = torch.from_numpy(bn).to(cuda_device, dtype).requires_grad_()
        out = cs.sddmm_bcsr(pack, a, b)
        ref = cs.sddmm_plain(pack, a.detach(), b.detach())
        torch.testing.assert_close(out, ref, rtol=rtol, atol=1e-5 * float(ref.abs().max()))
        assert torch.equal(out, cs.sddmm_bcsr(pack, a, b))
        if dtype == torch.float32:  # exact f32 FMAs in k order, as the plain product
            assert torch.equal(out, ref)
        (out * pack.tiles.float()).sum().backward()
        assert a.grad.dtype == dtype and torch.isfinite(a.grad.float()).all()
