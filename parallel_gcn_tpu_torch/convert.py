"""Parameters of the JAX package as the port's tensors.

The JAX package's GCN params are a list of arrays; its GAT, SAGE and GIN
params are lists of per-layer dicts (``{W, a_src, a_dst}``, ``{neigh,
self}``, ``{w1, w2}`` with ``{w1}`` for GIN's last layer); its Adam state is
a (step, m, v) tuple shaped like the params. Taken as numpy leaves
(``np.asarray``), these functions turn them into the port's flat lists of
float32 tensors in JAX's leaf order (``jax.tree.leaves`` sorts each dict's
keys), so both packages can run from identical weights and optimizer state.
``params_to_numpy`` maps the port's flat leaves back to JAX's layers with
a model's per-layer keys (``model.layer_keys``, ``models.layer_keys``;
``utils.checkpoint`` writes them so).
"""

from __future__ import annotations

import numpy as np
import torch

from parallel_gcn_tpu_torch.optim import AdamState

def _leaves(params) -> list:
    """Flatten a list of arrays or of per-layer dicts in JAX's leaf order."""
    out = []
    for p in params:
        out += [p[k] for k in sorted(p)] if isinstance(p, dict) else [p]
    return out


def _tensors(leaves, device) -> list[torch.Tensor]:
    return [
        torch.from_numpy(np.array(a, dtype=np.float32, copy=True)).to(device)
        for a in _leaves(leaves)
    ]


def params_from_numpy(params: list, device="cpu") -> list[torch.Tensor]:
    """Any family's per-layer arrays or dicts (a GCN's arrays, a GAT's
    ``{W, a_src, a_dst}``, SAGE's ``{neigh, self}``, GIN's ``{w1[, w2]}``) as
    the port's flat parameter list of float32 tensors on ``device`` in leaf
    order, e.g. ``[W_0, a_dst_0, a_src_0, W_1, ...]``."""
    return _tensors(params, device)


def params_to_numpy(leaves: list, keys: list[tuple[str, ...] | None]) -> list:
    """The port's flat leaves (tensors or arrays) as JAX's layers, float32:
    layer i an array where ``keys[i]`` is None, else the dict of its keys
    (a model's ``layer_keys``); the inverse of ``params_from_numpy``."""
    arrays = [np.asarray(t.detach().cpu() if isinstance(t, torch.Tensor) else t, np.float32)
              for t in leaves]
    if len(arrays) != sum(1 if k is None else len(k) for k in keys):
        raise ValueError(f"{len(arrays)} leaves do not fit the layers' keys {keys}")
    out, i = [], 0
    for k in keys:
        if k is None:
            out.append(arrays[i])
            i += 1
        else:
            out.append(dict(zip(k, arrays[i : i + len(k)])))
            i += len(k)
    return out


def adam_state_from_numpy(step, m: list, v: list, device) -> AdamState:
    """The port's ``AdamState`` from a step count and the moments, shaped
    like the params (arrays, or per-layer dicts for a GAT), in leaf order."""
    return AdamState(step=torch.tensor(int(np.asarray(step)), dtype=torch.int32, device=device),
                     m=_tensors(m, device), v=_tensors(v, device))
