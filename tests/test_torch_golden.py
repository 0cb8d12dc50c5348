"""The port's numpy golden model equals the JAX package's on the same
inputs, function by function."""

import numpy as np
import pytest

from parallel_gcn_tpu import golden as jg
from parallel_gcn_tpu.data.graph import HostCSR as JaxCSR
from parallel_gcn_tpu_torch import golden as tg
from parallel_gcn_tpu_torch.data.graph import random_graph


def _graphs(n=60, seed=0):
    csr, _ = random_graph(n, avg_degree=5, seed=seed)
    jcsr = JaxCSR(indptr=csr.indptr, indices=csr.indices, values=csr.values,
                  n_rows=csr.n_rows, n_cols=csr.n_cols)
    return csr, jcsr


def _weights(rng, dims):
    return [rng.uniform(-tg.glorot_range(a, b), tg.glorot_range(a, b), (a, b)).astype(np.float32)
            for a, b in zip(dims[:-1], dims[1:])]


def _inputs(layers=3, residual_dims=False, seed=1):
    rng = np.random.default_rng(seed)
    tcsr, jcsr = _graphs()
    n = tcsr.n_rows
    hidden = [12, 12][: layers - 1] if residual_dims else [12, 9][: layers - 1]
    dims = [10, *hidden, 4]
    x = rng.standard_normal((n, dims[0])).astype(np.float32)
    keep = [0.8, 0.6, 0.9][:layers]
    masks = [(rng.random((n, dims[i])) < keep[i]).astype(np.float32) for i in range(layers)]
    labels = rng.integers(0, dims[-1], n).astype(np.int32)
    mask = rng.random(n) < 0.5
    return rng, tcsr, jcsr, _weights(rng, dims), x, masks, keep, labels, mask


def _same(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for u, v in zip(a, b):
            _same(u, v)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_csr_matvec_and_glorot_range():
    tcsr, jcsr = _graphs()
    x = np.random.default_rng(2).standard_normal((tcsr.n_rows, 7)).astype(np.float32)
    _same(tg.csr_matvec_dense(tcsr, x), jg.csr_matvec_dense(jcsr, x))
    assert tg.glorot_range(602, 600) == jg.glorot_range(602, 600)


@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("dropout", [False, True])
def test_golden_forward(residual, dropout):
    _, tcsr, jcsr, w, x, masks, keep, _, _ = _inputs(residual_dims=residual)
    m, k = (masks, keep) if dropout else (None, None)
    _same(tg.golden_forward(w, x, tcsr, m, k, residual=residual),
          jg.golden_forward(w, x, jcsr, m, k, residual=residual))


def test_golden_loss_acc():
    rng, tcsr, jcsr, w, x, _, _, labels, mask = _inputs()
    logits = rng.standard_normal((tcsr.n_rows, 4)).astype(np.float32)
    _same(tg.golden_loss_acc(logits, labels, mask, w[0], 5e-4),
          jg.golden_loss_acc(logits, labels, mask, w[0], 5e-4))


@pytest.mark.parametrize("residual", [False, True])
def test_golden_grads(residual):
    _, tcsr, jcsr, w, x, masks, keep, labels, mask = _inputs(residual_dims=residual)
    _same(tg.golden_grads(w, x, tcsr, labels, mask, masks, keep, residual=residual),
          jg.golden_grads(w, x, jcsr, labels, mask, masks, keep, residual=residual))


def test_golden_adam_step():
    rng, _, _, w, *_ = _inputs()
    grads = [rng.standard_normal(a.shape).astype(np.float32) for a in w]
    states = [mod.GoldenAdamState(m=[np.zeros_like(a) for a in w],
                                  v=[np.zeros_like(a) for a in w]) for mod in (tg, jg)]
    flags = [True] + [False] * (len(w) - 1)
    tw, jw = list(w), list(w)
    for _ in range(3):
        tw = tg.golden_adam_step(tw, grads, states[0], 0.01, 5e-4, 0.9, 0.999, 1e-8, flags)
        jw = jg.golden_adam_step(jw, grads, states[1], 0.01, 5e-4, 0.9, 0.999, 1e-8, flags)
    _same(tw, jw)
    _same((states[0].m, states[0].v, states[0].step), (states[1].m, states[1].v, states[1].step))


def test_golden_gat_sage_gin_forwards():
    rng, tcsr, jcsr, _, x, *_ = _inputs()
    heads, d = 2, 3
    gat = [{"W": rng.standard_normal((10, heads * d)).astype(np.float32),
            "a_src": rng.standard_normal((heads, d)).astype(np.float32),
            "a_dst": rng.standard_normal((heads, d)).astype(np.float32)},
           {"W": rng.standard_normal((heads * d, heads * 4)).astype(np.float32),
            "a_src": rng.standard_normal((heads, 4)).astype(np.float32),
            "a_dst": rng.standard_normal((heads, 4)).astype(np.float32)}]
    _same(tg.golden_gat_forward(gat, x, tcsr, heads), jg.golden_gat_forward(gat, x, jcsr, heads))
    sage = [{"neigh": rng.standard_normal((10, 8)).astype(np.float32),
             "self": rng.standard_normal((10, 8)).astype(np.float32)},
            {"neigh": rng.standard_normal((8, 4)).astype(np.float32),
             "self": rng.standard_normal((8, 4)).astype(np.float32)}]
    _same(tg.golden_sage_forward(sage, x, tcsr), jg.golden_sage_forward(sage, x, jcsr))
    gin = [{"w1": rng.standard_normal((10, 8)).astype(np.float32),
            "w2": rng.standard_normal((8, 8)).astype(np.float32)},
           {"w1": rng.standard_normal((8, 4)).astype(np.float32)}]
    for eps in (0.0, 0.3):
        _same(tg.golden_gin_forward(gin, x, tcsr, eps), jg.golden_gin_forward(gin, x, jcsr, eps))
