"""GraphSAGE with the mean aggregator (arXiv:1706.02216) over N(i) ∪ {i},
as the program's parameter files configure it: layer l is [ReLU →] dropout
→ h·W_self + mean_{j ∈ N(i) ∪ {i}} (h·W_neigh)_j, no biases; leaves
``[neigh_l, self_l]`` a layer, leaf 0 decayed. The mean over the
self-loop-inclusive neighbourhood is D⁻¹(A+I)·g = Â·(s ⊙ g) / s with
s = sqrt(deg).

Also the work of an epoch counted from these equations (``work``)."""

from __future__ import annotations

import torch

from portbench.reference.common import RefData, dropout
from portbench.reference.gcn import _dropouts, dims, n_layers  # noqa: F401


def leaf_shapes(params: dict, input_dim: int, n_classes: int) -> list[tuple[int, int]]:
    """``[neigh, self]`` a layer."""
    d = dims(params, input_dim, n_classes)
    return [s for a, b in zip(d[:-1], d[1:]) for s in ((a, b), (a, b))]


def forward(data: RefData, w: list[torch.Tensor], params: dict, *, training: bool,
            seeds, q) -> torch.Tensor:
    rates = _dropouts(params)
    h = data.x
    for layer in range(len(w) // 2):
        if layer:
            h = torch.relu(h)
        rate = rates[layer] if training else 0.0
        if rate > 0.0:
            h = dropout(h, seeds[layer], rate, q)
        hq = q(h)
        neigh = q(hq @ q(w[2 * layer]))
        h = hq @ q(w[2 * layer + 1]) + data.aggregate(data.sqrt_deg * neigh) / data.sqrt_deg
    return h


def work(params: dict, n: int, nnz: int, input_dim: int, n_classes: int) -> dict:
    """As ``gcn.work``: two products a layer each way (self and neigh), and a
    layer's Â-products read as there: the train forward with the val forward
    not shared with the next train forward, then the backward."""
    d = dims(params, input_dim, n_classes)
    rates = _dropouts(params)
    flops, agg = 0.0, []
    for layer in range(len(d) - 1):
        a, b = d[layer], d[layer + 1]
        g = 2.0 * n * a * b
        flops += 2 * g * (2 if layer == 0 else 3)  # forward, dW, dX above layer 0
        shared_eval = all(r == 0.0 for r in rates[: layer + 1])
        if not shared_eval:
            flops += 2 * g
        agg += [(b,) if shared_eval else (b, b), (b,)]
    flops += sum(2.0 * nnz * f for group in agg for f in group)
    return dict(flops=flops, agg=agg, agg_run=[])
