"""parallel_gcn_tpu_torch GAT model and trainer against the JAX package.

Both packages start from the same parameters (``convert.params_from_numpy``
of a JAX ``init_gat_params`` draw). At dropout 0 the port's forward on each
backend (dense, segment, tile) must match ``golden.golden_gat_forward`` and
JAX ``GATModel.apply`` (rtol 2e-5, atol 2e-5), and its loss gradients must
match ``jax.grad`` and each other across backends (rtol 2e-4, atol 2e-5).
The JAX side runs its Pallas kernels in TPU-interpret mode. The trainer's
GAT path is in tests/test_torch_gat_train.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import parallel_gcn_tpu.ops.pallas_bcsr as pb
from parallel_gcn_tpu.data.graph import build_graph as jax_build_graph
from parallel_gcn_tpu.golden import golden_gat_forward
from parallel_gcn_tpu.models.gat import GATModel as JaxGAT
from parallel_gcn_tpu.models.gat import init_gat_params as jax_init_gat_params
from parallel_gcn_tpu.ops.loss import masked_softmax_xent as jax_xent
from parallel_gcn_tpu.optim import init_adam as jax_init_adam
from parallel_gcn_tpu_torch.convert import adam_state_from_numpy, params_from_numpy
from parallel_gcn_tpu_torch.data.graph import build_graph, random_graph
from parallel_gcn_tpu_torch.models.gat import GATModel, init_gat_params
from parallel_gcn_tpu_torch.ops.loss import masked_softmax_xent

torch.set_num_threads(1)

CPU = torch.device("cpu")
N, F_IN, C = 300, 10, 4
LAYOUTS = {
    "dense": dict(dense=True),
    "segment": dict(),
    "tile": dict(hybrid=True, min_tile_nnz=120, tile_size=128),
}


@pytest.fixture(autouse=True)
def interpret_mode():
    from jax.experimental.pallas import tpu as pltpu

    old = pb._INTERPRET[0]
    pb._INTERPRET[0] = pltpu.InterpretParams()
    yield
    pb._INTERPRET[0] = old


@pytest.fixture(scope="module")
def data():
    csr, _ = random_graph(N, 8, seed=3)
    graphs = {b: (build_graph(csr, device=CPU, **kw), jax_build_graph(csr, **kw))
              for b, kw in LAYOUTS.items()}
    assert graphs["tile"][0].is_hybrid
    rng = np.random.default_rng(0)
    x = rng.standard_normal((N, F_IN)).astype(np.float32)
    labels = rng.integers(0, C, N)
    mask = rng.random(N) < 0.6
    return csr, graphs, x, labels, mask


def _pad(a, n, fill=0):
    out = np.full((n, *a.shape[1:]), fill, a.dtype)
    out[: a.shape[0]] = a
    return out


def _params(L, H, seed=1):
    jp = jax_init_gat_params(jax.random.PRNGKey(seed), F_IN, [6] * (L - 1), C, H)
    return jp, jax.tree.map(np.asarray, jp)


@pytest.mark.parametrize("backend", sorted(LAYOUTS))
@pytest.mark.parametrize("L,H", [(2, 1), (2, 4), (3, 2)])
def test_forward_matches_golden_and_jax(data, L, H, backend):
    csr, graphs, x, _, _ = data
    tg, jg = graphs[backend]
    jp, pnp = _params(L, H)
    xp = _pad(x, tg.n_nodes)
    model = GATModel(params_from_numpy(pnp), (0.0,) * L, heads=H, backend=backend)
    out = model(torch.from_numpy(xp), tg, training=False).detach().numpy()[:N]
    np.testing.assert_allclose(out, golden_gat_forward(pnp, x, csr, H), rtol=2e-5, atol=2e-5)
    jm = JaxGAT(n_layers=L, dropouts=(0.0,) * L, heads=H, backend=backend)
    want = np.asarray(jm.apply(jp, jnp.asarray(xp), jg, training=False))[:N]
    np.testing.assert_allclose(out, want, rtol=2e-5, atol=2e-5)


def _port_loss_grads(pnp, graph, backend, x, labels, mask, H):
    model = GATModel(params_from_numpy(pnp), (0.0, 0.0), heads=H, backend=backend)
    n = graph.n_nodes
    logits = model(torch.from_numpy(_pad(x, n)), graph, training=True)
    loss, _ = masked_softmax_xent(logits, torch.from_numpy(_pad(labels, n, -1)),
                                  torch.from_numpy(_pad(mask, n)), int(mask.sum()))
    return [g.numpy() for g in torch.autograd.grad(loss, list(model.weights))]


@pytest.mark.parametrize("backend", ["segment", "tile"])
def test_loss_gradients_match_jax_and_each_other(data, backend):
    _, graphs, x, labels, mask = data
    H = 2
    jp, pnp = _params(2, H, seed=4)
    tg, jg = graphs[backend]
    got = _port_loss_grads(pnp, tg, backend, x, labels, mask, H)
    n = tg.n_nodes
    jm = JaxGAT(n_layers=2, dropouts=(0.0, 0.0), heads=H, backend=backend)

    def jloss(params):
        logits = jm.apply(params, jnp.asarray(_pad(x, n)), jg, training=True)
        return jax_xent(logits, jnp.asarray(_pad(labels, n, -1), jnp.int32),
                        jnp.asarray(_pad(mask, n)), int(mask.sum()))[0]

    want = jax.tree.leaves(jax.grad(jloss)(jp))
    assert len(got) == len(want) == 6
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, np.asarray(b), rtol=2e-4, atol=2e-5)
    if backend == "tile":
        seg = _port_loss_grads(pnp, graphs["segment"][0], "segment", x, labels, mask, H)
        for a, b in zip(got, seg):
            np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-5)


def test_params_round_trip_from_jax_init(data):
    """JAX init_gat_params → numpy → port: JAX's leaf order, equal
    forwards, and the Adam moments in the same order."""
    csr, graphs, x, _, _ = data
    jp, pnp = _params(3, 2, seed=7)
    flat = params_from_numpy(pnp)
    leaves = jax.tree.leaves(jp)
    assert [tuple(p.shape) for p in flat] == [tuple(a.shape) for a in leaves]
    for p, a in zip(flat, leaves):
        np.testing.assert_array_equal(p.numpy(), np.asarray(a))
    assert [tuple(p.shape) for p in flat[:3]] == [(F_IN, 12), (2, 6), (2, 6)]  # W, a_dst, a_src
    np.testing.assert_array_equal(flat[1].numpy(), pnp[0]["a_dst"])
    tg, jg = graphs["tile"]
    xp = _pad(x, tg.n_nodes)
    out = GATModel(flat, (0.0,) * 3, heads=2, backend="tile")(
        torch.from_numpy(xp), tg, training=False)
    want = JaxGAT(n_layers=3, dropouts=(0.0,) * 3, heads=2, backend="tile").apply(
        jp, jnp.asarray(xp), jg, training=False)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)
    step, m, v = jax_init_adam(jp)
    m = jax.tree.map(lambda a: np.asarray(a) + 1.0, m)
    state = adam_state_from_numpy(np.asarray(step), m, jax.tree.map(np.asarray, v), CPU)
    for got, want in zip(state.m, jax.tree.leaves(m)):
        np.testing.assert_array_equal(got.numpy(), want)
    assert len(state.v) == 9


def test_init_gat_params_shapes_and_determinism():
    a = init_gat_params(torch.Generator().manual_seed(5), 20, [8], 3, heads=4)
    b = init_gat_params(torch.Generator().manual_seed(5), 20, [8], 3, heads=4)
    assert [tuple(p.shape) for p in a] == [(20, 32), (4, 8), (4, 8), (32, 12), (4, 3), (4, 3)]
    assert all(torch.equal(p, q) for p, q in zip(a, b))
    r = (6.0 / (20 + 32)) ** 0.5
    assert float(a[0].abs().max()) <= r and a[0].dtype == torch.float32


def test_attention_dropout_keeps_the_rate_and_is_seeded(data):
    """Training forwards with attention dropout on every backend: the same
    seeds give the same logits, other seeds other logits; on the tile backend
    the mask is the hash of (dest, src, head, seed)."""
    _, graphs, x, _, _ = data
    _, pnp = _params(2, 2, seed=2)
    for backend, (tg, _) in graphs.items():
        model = GATModel(params_from_numpy(pnp), (0.2, 0.3), heads=2,
                         attn_dropout=0.5, backend=backend)
        xp = torch.from_numpy(_pad(x, tg.n_nodes))
        a = model(xp, tg, training=True, seeds=[1, 11, 2, 22])
        b = model(xp, tg, training=True, seeds=[1, 11, 2, 22])
        c = model(xp, tg, training=True, seeds=[1, 12, 2, 22])
        assert torch.equal(a, b) and not torch.equal(a, c), backend
        assert torch.isfinite(a).all()
        with pytest.raises(ValueError, match="4 seeds"):
            model(xp, tg, training=True, seeds=[1, 2])
