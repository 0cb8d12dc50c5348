"""Parameters of the JAX package as the port's tensors.

The JAX package's GCN params are a list of arrays, its GAT params a list of
per-layer ``{W, a_src, a_dst}`` dicts, and its Adam state a (step, m, v)
tuple shaped like the params. Taken as numpy leaves (``np.asarray``), these
functions turn them into the port's flat lists of float32 tensors in JAX's
leaf order (``jax.tree.leaves`` sorts dict keys: ``W, a_dst, a_src``), so
both packages can run from identical weights and optimizer state;
``gat_params_to_numpy`` maps the port's flat GAT leaves back to JAX's
per-layer dicts (``utils.checkpoint`` writes them so).
"""

from __future__ import annotations

import numpy as np
import torch

from parallel_gcn_tpu_torch.optim import AdamState

# a GAT layer's keys in JAX's leaf order (sorted), the port's leaves a layer
_GAT_LEAF_KEYS = ("W", "a_dst", "a_src")


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


def weights_from_numpy(weights: list[np.ndarray], device) -> list[torch.Tensor]:
    """One float32 tensor on ``device`` per layer weight."""
    return _tensors(weights, device)


def gat_params_from_numpy(params: list[dict], device="cpu") -> list[torch.Tensor]:
    """A GAT's per-layer ``{W, a_src, a_dst}`` arrays as the port's flat
    parameter list ``[W_0, a_dst_0, a_src_0, W_1, ...]``."""
    return _tensors(params, device)


def gat_params_to_numpy(leaves: list) -> list[dict]:
    """The port's flat GAT leaves ``[W_0, a_dst_0, a_src_0, W_1, ...]``
    (tensors or arrays) as JAX's per-layer ``{W, a_dst, a_src}`` float32
    arrays: the inverse of ``gat_params_from_numpy``."""
    if len(leaves) % len(_GAT_LEAF_KEYS):
        raise ValueError(f"{len(leaves)} GAT leaves: not {len(_GAT_LEAF_KEYS)} per layer")
    arrays = [np.asarray(t.detach().cpu() if isinstance(t, torch.Tensor) else t, np.float32)
              for t in leaves]
    k = len(_GAT_LEAF_KEYS)
    return [dict(zip(_GAT_LEAF_KEYS, arrays[i : i + k])) for i in range(0, len(arrays), k)]


def adam_state_from_numpy(step, m: list, v: list, device) -> AdamState:
    """The port's ``AdamState`` from a step count and the moments, shaped
    like the params (arrays, or per-layer dicts for a GAT), in leaf order."""
    return AdamState(step=torch.tensor(int(np.asarray(step)), dtype=torch.int32, device=device),
                     m=_tensors(m, device), v=_tensors(v, device))
