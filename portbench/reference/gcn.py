"""The GCN of Kipf & Welling (arXiv:1609.02907) as the reference trainer
runs it: layer l is [ReLU →] dropout → H·W_l → Â·(·), no biases, logits
after the last aggregation. Â·X is a constant of the data, so with no input
dropout layer 0 reads it (Â·(X·W0) = (Â·X)·W0).

Also the work of an epoch counted from these equations (``work``), for the
whole step's share of the peak and the aggregation's roofline."""

from __future__ import annotations

import torch

from portbench.reference.common import RefData, dropout


def n_layers(params: dict) -> int:
    return int(params["n_layers"])


def _dropouts(params: dict) -> list[float]:
    d = params["dropouts"]
    return [float(x) for x in (d if isinstance(d, list) else [d])]


def dims(params: dict, input_dim: int, n_classes: int) -> list[int]:
    h = params["hidden_dims"]
    return [input_dim, *(h if isinstance(h, list) else [h]), n_classes]


def leaf_shapes(params: dict, input_dim: int, n_classes: int) -> list[tuple[int, int]]:
    """One weight a layer, in the trainer's leaf order."""
    d = dims(params, input_dim, n_classes)
    return list(zip(d[:-1], d[1:]))


def forward(data: RefData, w: list[torch.Tensor], params: dict, *, training: bool,
            seeds, q) -> torch.Tensor:
    """Logits [n, classes]; ``seeds`` one dropout seed a layer; ``q`` the
    rounding of each product's operands."""
    rates = _dropouts(params)
    h = None
    for layer, wl in enumerate(w):
        rate = rates[layer] if training else 0.0
        if layer == 0 and rates[0] == 0.0:
            h = q(data.ax) @ q(wl)
            continue
        h = data.x if layer == 0 else torch.relu(h)
        if rate > 0.0:
            h = dropout(h, seeds[layer], rate, q)
        h = data.aggregate(q(q(h) @ q(wl)))
    return h


def work(params: dict, n: int, nnz: int, input_dim: int, n_classes: int) -> dict:
    """An epoch's model FLOPs and Â-products by these equations: the train
    forward, its backward (no gradient of the input features) and the val
    forward; a val layer whose inputs all equal the next train forward's
    (every dropout up to it 0) is that forward's product and counted once.

    ``agg`` lists an epoch's reads of Â, each the tuple of the products'
    widths that can share it: at each layer, the train forward with the val
    forward of the same weights (the previous update's, deferred), and the
    backward alone, since it waits for the forward. ``agg_run`` the same for
    the products made once a run (Â·X, at the input's width)."""
    d = dims(params, input_dim, n_classes)
    rates = _dropouts(params)
    gemm = lambda a, b: 2.0 * n * a * b
    flops, agg, agg_run = 0.0, [], []
    preagg = rates[0] == 0.0
    if preagg:
        agg_run.append((d[0],))
    for layer in range(len(d) - 1):
        a, b = d[layer], d[layer + 1]
        shared_eval = all(r == 0.0 for r in rates[: layer + 1])
        flops += gemm(a, b) * (2 if layer == 0 else 3)  # forward, dW, dX above layer 0
        if not shared_eval:
            flops += gemm(a, b)
        if not (layer == 0 and preagg):
            agg += [(b,) if shared_eval else (b, b), (b,)]
    flops += sum(2.0 * nnz * f for group in agg for f in group)
    return dict(flops=flops, agg=agg, agg_run=agg_run)
