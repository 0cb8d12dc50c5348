"""parallel_gcn_tpu_torch GCN model, loss and Adam against the JAX package.

Both packages start from the same weights (``convert.params_from_numpy``).
With dropouts 0 the port's forward and weight gradients must match JAX
``GCNModel.apply``; with dropout > 0 they must match ``golden_forward`` /
``golden_grads`` given the port's own Philox masks. Tolerance rtol 1e-4,
atol 1e-6 (float32; the golden oracle divides by keep where the kernels
multiply by 1/keep).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import parallel_gcn_tpu.ops.pallas_bcsr as pb
from parallel_gcn_tpu.data.graph import build_graph as jax_build_graph
from parallel_gcn_tpu.golden import (
    GoldenAdamState,
    golden_adam_step,
    golden_forward,
    golden_grads,
)
from parallel_gcn_tpu.models.gcn import GCNModel as JaxGCN
from parallel_gcn_tpu.ops.loss import masked_softmax_xent as jax_xent
from parallel_gcn_tpu.optim import adam_step as jax_adam_step
from parallel_gcn_tpu.optim import init_adam as jax_init_adam
from parallel_gcn_tpu_torch.convert import adam_state_from_numpy, params_from_numpy
from parallel_gcn_tpu_torch.data.graph import build_graph
from parallel_gcn_tpu_torch.data.synthetic import synthetic_csr
from parallel_gcn_tpu_torch.models.gcn import GCNModel, init_params
from parallel_gcn_tpu_torch.ops import cuda_dropout as cd
from parallel_gcn_tpu_torch.ops.loss import l2_penalty, masked_softmax_xent
from parallel_gcn_tpu_torch.optim import adam_step, init_adam

torch.set_num_threads(1)

CPU = torch.device("cpu")
RTOL, ATOL = 1e-4, 1e-6
N, F_IN, C = 600, 40, 5


@pytest.fixture(autouse=True)
def interpret_mode():
    from jax.experimental.pallas import tpu as pltpu

    old = pb._INTERPRET[0]
    pb._INTERPRET[0] = pltpu.InterpretParams()
    yield
    pb._INTERPRET[0] = old


def _data(build_kw, seed=0):
    csr = synthetic_csr(N, 9000, seed=seed, n_communities=8, shuffle=False)
    jkw = {k: (np.int8 if v == "int8" else v) for k, v in build_kw.items()}
    tg = build_graph(csr, device=CPU, **build_kw)
    jg = jax_build_graph(csr, **jkw)
    rng = np.random.default_rng(seed)
    x = np.zeros((tg.n_nodes, F_IN), np.float32)
    x[:N] = rng.standard_normal((N, F_IN))
    labels = np.full(tg.n_nodes, -1, np.int64)
    labels[:N] = rng.integers(0, C, N)
    mask = np.zeros(tg.n_nodes, bool)
    mask[:N] = rng.random(N) < 0.6
    return csr, tg, jg, x, labels, mask


def _weights(dims, seed=1):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((a, b)) * 0.3).astype(np.float32)
            for a, b in zip(dims[:-1], dims[1:])]


BACKENDS = {
    "dense": dict(dense=True),
    "segment": dict(),
    "hybrid_int8": dict(hybrid=True, tile_dtype="int8", min_tile_nnz=60),
}


@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("backend", sorted(BACKENDS))
def test_forward_and_grads_match_jax_at_dropout_zero(backend, residual):
    _, tg, jg, x, labels, mask = _data(BACKENDS[backend])
    w_np = _weights([F_IN, 16, 16, C])
    n_train = int(mask.sum())
    jm = JaxGCN(n_layers=3, dropouts=(0.0, 0.0, 0.0), residual=residual,
                backend="auto", dropout_impl="threefry")

    def jloss(ws):
        logits = jm.apply(ws, jnp.asarray(x), jg, training=True)
        return jax_xent(logits, jnp.asarray(labels, jnp.int32), jnp.asarray(mask), n_train)

    (jl, jacc), jgrads = jax.value_and_grad(jloss, has_aux=True)(
        [jnp.asarray(w) for w in w_np])
    tm = GCNModel(params_from_numpy(w_np, CPU), (0.0, 0.0, 0.0), residual=residual)
    logits = tm(torch.from_numpy(x), tg, training=True)
    tl, tacc = masked_softmax_xent(logits, torch.from_numpy(labels),
                                   torch.from_numpy(mask), n_train)
    tgrads = torch.autograd.grad(tl, list(tm.weights))
    np.testing.assert_allclose(float(tl), float(jl), rtol=RTOL, atol=ATOL)
    assert float(tacc) == pytest.approx(float(jacc), abs=1.5 / n_train)
    jlogits = jm.apply([jnp.asarray(w) for w in w_np], jnp.asarray(x), jg, training=False)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               rtol=RTOL, atol=ATOL)
    for a, b in zip(tgrads, jgrads):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL, atol=ATOL)


def _port_masks(seeds, shapes, rates):
    return [
        (cd.philox_words(s, a * b, "cpu").view(a, b) < cd.keep_threshold(r)).numpy()
        if r > 0 else None
        for s, (a, b), r in zip(seeds, shapes, rates)
    ]


@pytest.mark.parametrize("dropouts", [(0.3, 0.2), (0.0, 0.5)])
def test_dropout_forward_and_grads_match_golden(dropouts):
    csr, tg, _, x, labels, mask = _data(BACKENDS["hybrid_int8"])
    w_np = _weights([F_IN, 16, C], seed=2)
    seeds = [11, 2**50 + 7]
    tm = GCNModel(params_from_numpy(w_np, CPU), dropouts)
    logits = tm(torch.from_numpy(x), tg, training=True, seeds=seeds)
    n_train = int(mask.sum())
    ce, _ = masked_softmax_xent(logits, torch.from_numpy(labels),
                                torch.from_numpy(mask), n_train)
    grads = torch.autograd.grad(ce, list(tm.weights))

    masks = _port_masks(seeds, [(tg.n_nodes, F_IN), (tg.n_nodes, 16)], dropouts)
    masks = [None if m is None else m[:N] for m in masks]
    keep = [1 - r for r in dropouts]
    glog, _ = golden_forward(w_np, x[:N], csr, masks, keep)
    ggrads, _ = golden_grads(w_np, x[:N], csr, labels[:N], mask[:N], masks, keep)
    np.testing.assert_allclose(logits.detach().numpy()[:N], glog, rtol=RTOL, atol=ATOL)
    for a, b in zip(grads, ggrads):
        np.testing.assert_allclose(a.numpy(), b, rtol=RTOL, atol=1e-5)


def test_input_preagg_is_exact():
    _, tg, _, x, _, _ = _data(BACKENDS["segment"])
    w = params_from_numpy(_weights([F_IN, 16, C]), CPU)
    tm = GCNModel(w, (0.0, 0.3))
    xt = torch.from_numpy(x)
    plain = tm(xt, tg, training=True, seeds=[1, 2])
    agg = tm.aggregate(xt, tg)
    hoisted = tm(agg, tg, training=True, seeds=[1, 2], input_preagg=True)
    torch.testing.assert_close(hoisted, plain, rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError):
        GCNModel(w, (0.1, 0.3))(agg, tg, training=True, seeds=[1, 2], input_preagg=True)


def test_glorot_init_range_and_determinism():
    a = init_params(torch.Generator().manual_seed(5), 30, [20], 4)
    b = init_params(torch.Generator().manual_seed(5), 30, [20], 4)
    assert [tuple(w.shape) for w in a] == [(30, 20), (20, 4)]
    for w, (r, c) in zip(a, [(30, 20), (20, 4)]):
        assert w.abs().max() <= (6 / (r + c)) ** 0.5
        assert w.std() > 0.3 * (6 / (r + c)) ** 0.5
    assert all(torch.equal(u, v) for u, v in zip(a, b))


def test_loss_matches_jax_with_padding_rows():
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((50, 7)).astype(np.float32) * 3
    labels = rng.integers(0, 7, 50)
    labels[-5:] = -1
    mask = rng.random(50) < 0.5
    mask[-5:] = False
    tl, ta = masked_softmax_xent(torch.from_numpy(logits), torch.from_numpy(labels),
                                 torch.from_numpy(mask), int(mask.sum()))
    jl, ja = jax_xent(jnp.asarray(logits), jnp.asarray(labels, jnp.int32),
                      jnp.asarray(mask), int(mask.sum()))
    assert float(tl) == pytest.approx(float(jl), rel=1e-6)
    assert float(ta) == float(ja)
    w = rng.standard_normal((6, 3)).astype(np.float32)
    assert float(l2_penalty(torch.from_numpy(w))) == pytest.approx(float((w * w).sum()), rel=1e-6)


def test_adam_matches_jax_and_golden():
    w_np = _weights([8, 6, 3], seed=6)
    rng = np.random.default_rng(7)
    kw = dict(learning_rate=0.01, weight_decay=5e-4, beta1=0.9, beta2=0.999, eps=1e-8)
    tw = params_from_numpy(w_np, CPU)
    ts = init_adam(tw)
    jw = [jnp.asarray(w) for w in w_np]
    js = jax_init_adam(jw)
    gw = [w.copy() for w in w_np]
    gs = GoldenAdamState(m=[np.zeros_like(w) for w in w_np],
                         v=[np.zeros_like(w) for w in w_np])
    for _ in range(5):
        g = [rng.standard_normal(w.shape).astype(np.float32) for w in w_np]
        adam_step(tw, [torch.from_numpy(a) for a in g], ts, **kw)
        jw, js = jax_adam_step(jw, [jnp.asarray(a) for a in g], js, **kw)
        gw = golden_adam_step(gw, g, gs, 0.01, 5e-4, 0.9, 0.999, 1e-8, [True, False])
    for t, j, gg in zip(tw, jw, gw):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(t.numpy(), gg, rtol=1e-6, atol=1e-7)
    conv = adam_state_from_numpy(js.step, [np.asarray(m) for m in js.m],
                                 [np.asarray(v) for v in js.v], CPU)
    assert conv.step == ts.step == 5
    for a, b in zip(conv.m + conv.v, ts.m + ts.v):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-9)
