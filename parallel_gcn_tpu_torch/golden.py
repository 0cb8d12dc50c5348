"""Golden sequential model — the numerical oracle, in numpy.

A copy of ``parallel_gcn_tpu/golden.py`` (the port imports nothing of the
JAX package) over the port's own ``HostCSR``: a pure-NumPy re-expression of
the semantics shared by the reference's sequential CPU baseline
(hpdga-spring23/src/{gcn,module,optim}.cpp) and its CUDA framework
(src/{gcn,module,optim}.cu):

    Z = softmax(Â · dropout(ReLU(Â · dropout(X)·W0) …)·W_{L-1})
    loss = mean_{labeled} CE + wd/2·||W0||²  (L2 on the first weight only,
                                              src/gcn.cu:157-158)
    Adam with bias-corrected step size and L2 folded into the gradient
    (src/optim.cu:42-62)

Everything is float32. Dropout masks are passed in explicitly so the oracle is
deterministic and RNG-agnostic. Used by the tests and by
``harness.performance_golden`` (the sequential baseline's epoch time) —
never on the training path.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from parallel_gcn_tpu_torch.data.graph import HostCSR


def csr_matvec_dense(csr: HostCSR, x: np.ndarray) -> np.ndarray:
    """out = Â·x via explicit CSR traversal (hpdga-spring23/src/module.cpp:88-110,
    but with the precomputed values of src/parser.cpp:164-181)."""
    out = np.zeros((csr.n_rows, x.shape[1]), dtype=np.float32)
    rows = csr.row_ids()
    np.add.at(out, rows, csr.values[:, None] * x[csr.indices])
    return out


def glorot_range(rows: int, cols: int) -> float:
    """Glorot-uniform half-range (src/variable.cu:63-83)."""
    return float(np.sqrt(6.0 / (rows + cols)))


def golden_forward(
    weights: list[np.ndarray],
    x: np.ndarray,
    graph: HostCSR,
    dropout_masks: list[np.ndarray] | None = None,
    keep_probs: list[float] | None = None,
    residual: bool = False,
):
    """Forward pass; returns (logits, intermediates for backward)."""
    L = len(weights)
    h = x.astype(np.float32)
    saved = {"inputs": [], "pre_relu": [], "relu_mask": [], "res_applied": []}
    prev = None
    for layer in range(L):
        if dropout_masks is not None and dropout_masks[layer] is not None:
            h = h * dropout_masks[layer] / np.float32(keep_probs[layer])
        saved["inputs"].append(h)
        h = h @ weights[layer]
        h = csr_matvec_dense(graph, h)
        # INNER layers only, like GCNModel.apply and the reference's
        # ResidualConnection placement (src/gcn.cu:85-112: never the output
        # layer, src/module.cu:566-593)
        res = (
            residual
            and 0 < layer < L - 1
            and prev is not None
            and prev.shape == h.shape
        )
        if res:
            h = h + prev
        saved["res_applied"].append(bool(res))
        saved["pre_relu"].append(h)
        if layer < L - 1:
            mask = h > 0
            saved["relu_mask"].append(mask)
            h = np.where(mask, h, 0.0).astype(np.float32)
            prev = h
    return h, saved


def golden_loss_acc(
    logits: np.ndarray,
    labels: np.ndarray,
    mask: np.ndarray,
    weights0: np.ndarray,
    weight_decay: float,
):
    """Masked softmax CE + L2 term + reference-style accuracy.

    Matches the fused kernel src/module.cu:484-524 (max-subtraction, mean over
    the split's samples) plus finalize (src/gcn.cu:440-455: + wd·||W0||²/2).
    Accuracy = argmax(logits) == label, matching ops.loss (the reference's
    truth-logit-equals-max trick, src/gcn.cu:264-289, agrees except on exact
    logit ties; see masked_softmax_xent_sums for why the trick is unsound
    under XLA recomputation).
    """
    num_samples = int(mask.sum())
    lmax = logits.max(axis=1, keepdims=True)
    shifted = logits - lmax
    lse = np.log(np.exp(shifted).sum(axis=1))
    safe_labels = np.clip(labels, 0, None)
    truth = shifted[np.arange(len(labels)), safe_labels]
    ce = float((mask * (lse - truth)).sum() / num_samples)
    loss = ce + weight_decay * float((weights0**2).sum()) / 2.0
    correct = mask & (logits.argmax(axis=1) == safe_labels)
    acc = float(correct.sum() / num_samples)
    return loss, acc, ce


def golden_grads(
    weights: list[np.ndarray],
    x: np.ndarray,
    graph: HostCSR,
    labels: np.ndarray,
    mask: np.ndarray,
    dropout_masks: list[np.ndarray] | None = None,
    keep_probs: list[float] | None = None,
    residual: bool = False,
):
    """Full hand-written backward producing dCE/dW per layer (no L2 term —
    the reference folds L2 into Adam, src/optim.cu:50-51)."""
    L = len(weights)
    logits, saved = golden_forward(
        weights, x, graph, dropout_masks, keep_probs, residual=residual
    )

    num_samples = int(mask.sum())
    lmax = logits.max(axis=1, keepdims=True)
    e = np.exp(logits - lmax)
    prob = e / e.sum(axis=1, keepdims=True)
    onehot = np.zeros_like(prob)
    safe_labels = np.clip(labels, 0, None)
    onehot[np.arange(len(labels)), safe_labels] = 1.0
    g = (mask[:, None] * (prob - onehot) / num_samples).astype(np.float32)

    grads = [None] * L
    res_cot = None  # residual cotangent flowing to the previous layer's output
    for layer in reversed(range(L)):
        if layer < L - 1:
            if res_cot is not None:
                # layer+1's residual read this layer's post-relu output
                g = g + res_cot
                res_cot = None
            g = np.where(saved["relu_mask"][layer], g, 0.0).astype(np.float32)
        # g is now the cotangent at the residual-add point (pre-relu)
        if saved["res_applied"][layer]:
            res_cot = g
        g = csr_matvec_dense(graph, g)  # Âᵀ=Â (symmetric)
        a_in = saved["inputs"][layer]
        grads[layer] = (a_in.T @ g).astype(np.float32)
        if layer > 0:
            g = (g @ weights[layer].T).astype(np.float32)
            if dropout_masks is not None and dropout_masks[layer] is not None:
                g = g * dropout_masks[layer] / np.float32(keep_probs[layer])
    return grads, logits


@dataclass
class GoldenAdamState:
    m: list[np.ndarray]
    v: list[np.ndarray]
    step: int = 0


def golden_adam_step(
    weights: list[np.ndarray],
    grads: list[np.ndarray],
    state: GoldenAdamState,
    lr: float,
    wd: float,
    b1: float,
    b2: float,
    eps: float,
    decay_flags: list[bool],
):
    """One Adam step matching src/optim.cu:42-62 exactly (float32 math,
    step_size computed on host, eps outside the sqrt)."""
    state.step += 1
    t = state.step
    step_size = np.float32(lr * np.sqrt(1.0 - b2**t) / (1.0 - b1**t))
    new_weights = []
    for i, (w, g) in enumerate(zip(weights, grads)):
        g = g.astype(np.float32)
        if decay_flags[i]:
            g = g + np.float32(wd) * w
        state.m[i] = np.float32(b1) * state.m[i] + np.float32(1 - b1) * g
        state.v[i] = np.float32(b2) * state.v[i] + np.float32(1 - b2) * g * g
        new_weights.append(
            (w - step_size * state.m[i] / (np.sqrt(state.v[i]) + np.float32(eps))).astype(
                np.float32
            )
        )
    return new_weights


def golden_gat_forward(
    params: list[dict],
    x: np.ndarray,
    graph: HostCSR,
    heads: int,
    leaky_slope: float = 0.2,
):
    """GAT forward oracle (no dropout): dense masked attention in NumPy —
    an independent re-expression of models/gat.py (paper arXiv:1710.10903
    eqs. 1-6: LeakyReLU edge logits from the a_src/a_dst decomposition,
    per-destination softmax over N(i) ∪ {i}, heads concatenated on hidden
    layers and averaged on the last)."""
    n = csr_n = graph.n_rows
    mask = np.zeros((n, n), dtype=bool)
    mask[graph.row_ids(), graph.indices] = True  # self-loop-first CSR

    h = x.astype(np.float32)
    L = len(params)
    for layer in range(L):
        W = params[layer]["W"].astype(np.float32)
        a_s = params[layer]["a_src"].astype(np.float32)
        a_d = params[layer]["a_dst"].astype(np.float32)
        d = a_s.shape[1]
        hw = (h @ W).reshape(n, heads, d)
        s = np.einsum("nhd,hd->nh", hw, a_s)
        t = np.einsum("nhd,hd->nh", hw, a_d)
        e = s.T[:, :, None] + t.T[:, None, :]  # [heads, dst, src]
        e = np.where(e > 0, e, leaky_slope * e)
        e = np.where(mask[None], e, np.float32(-1e9))
        e = e - e.max(axis=-1, keepdims=True)
        w_exp = np.exp(e)
        alpha = w_exp / w_exp.sum(axis=-1, keepdims=True)
        out = np.einsum("hij,jhd->ihd", alpha, hw)
        if layer == L - 1:
            h = out.mean(axis=1)
        else:
            h = out.reshape(csr_n, heads * d)
            h = np.where(h > 0, h, np.expm1(h)).astype(np.float32)  # ELU
    return h.astype(np.float32)


def _adjacency_plus_I(graph: HostCSR) -> np.ndarray:
    """Dense 0/1 (A+I) from the self-loop-first CSR — built from the INDEX
    structure only, independent of the stored 1/sqrt(deg·deg) values, so it
    is a true oracle for the diagonal-rewrite aggregators (models/sage.py)."""
    n = graph.n_rows
    a = np.zeros((n, n), dtype=np.float32)
    a[graph.row_ids(), graph.indices] = 1.0
    return a


def golden_sage_forward(
    params: list[dict], x: np.ndarray, graph: HostCSR
) -> np.ndarray:
    """GraphSAGE-mean forward oracle (no dropout): dense NumPy re-expression
    of models/sage.py SAGEModel — h' = act(h·W_self + mean_{N∪{i}}(h)·W_neigh)
    with the mean over the self-loop-inclusive neighborhood (paper
    arXiv:1706.02216, mean aggregator)."""
    a = _adjacency_plus_I(graph)
    mean_op = a / a.sum(axis=1, keepdims=True)
    h = x.astype(np.float32)
    L = len(params)
    for layer in range(L):
        w = params[layer]
        h = h @ w["self"].astype(np.float32) + mean_op @ (
            h @ w["neigh"].astype(np.float32)
        )
        if layer < L - 1:
            h = np.maximum(h, 0.0)
    return h.astype(np.float32)


def golden_gin_forward(
    params: list[dict], x: np.ndarray, graph: HostCSR, eps: float = 0.0
) -> np.ndarray:
    """GIN-eps forward oracle (no dropout): dense NumPy re-expression of
    models/sage.py GINModel — z = (1+eps)·h_i + Σ_{N(i)} h_j, then the
    2-layer MLP per inner layer / single linear classifier on the last
    (paper arXiv:1810.00826 eq. 4.1)."""
    a = _adjacency_plus_I(graph)
    h = x.astype(np.float32)
    L = len(params)
    for layer in range(L):
        # self-loop-inclusive sum + eps·h == (1+eps)·h + sum over N(i)
        z = eps * h + a @ h
        w = params[layer]
        z = z @ w["w1"].astype(np.float32)
        if "w2" in w:
            z = np.maximum(z, 0.0) @ w["w2"].astype(np.float32)
        h = np.maximum(z, 0.0) if layer < L - 1 else z
    return h.astype(np.float32)
