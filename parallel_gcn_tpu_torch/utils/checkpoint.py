"""Checkpoint / resume in the JAX package's ``.npz`` format.

Port of ``parallel_gcn_tpu/utils/checkpoint.py`` in numpy, so a file moves
between the two packages both ways. A checkpoint holds the whole training
state as plain numeric arrays (no pickling):

- ``w{i}``, ``m{i}``, ``v{i}``: layer i's weights and Adam moments. A GCN
  layer is one array. A GAT, SAGE or GIN layer is JAX's dict (``{W, a_dst,
  a_src}``, ``{neigh, self}``, ``{w1[, w2]}``), saved as ``w{i}_<key>`` plus
  the ``w{i}__keys`` manifest, so ``n_weights`` counts layers, not the
  port's leaves (a model's ``layer_keys`` gives each layer's);
- ``step`` (Adam's count), ``epoch`` (epochs trained), ``n_weights``.

The JAX package also stores its threefry ``key``, which the port cannot
continue: the port ignores it on load and writes none. The port's dropout
seeds come from one ``torch.Generator`` per run (``train.epoch_seeds``); it
stores that generator's seed as ``torch_seed``, a name the JAX package does
not read. A resumed run draws the seeds of epochs ``epoch + 1, ...`` from
the same stream (``train.skip_epochs``), from a JAX file and a port file
alike.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from parallel_gcn_tpu_torch.convert import params_to_numpy

_SEED_KEY = "torch_seed"
# a GAT layer's keys in a pre-manifest file (the JAX loader's fallback)
_GAT_KEYS = ("W", "a_src", "a_dst")


@dataclass
class Checkpoint:
    """A loaded checkpoint: flat float32 leaves in JAX's leaf order (a
    layer's dict by sorted key, e.g. ``W, a_dst, a_src``), Adam's count, the
    epochs trained and the port's generator seed (None in a JAX file)."""

    weights: list[np.ndarray]
    m: list[np.ndarray]
    v: list[np.ndarray]
    step: int
    epoch: int
    seed: int | None


def _put(flat: dict, name: str, layer) -> None:
    if isinstance(layer, dict):
        keys = sorted(layer)
        flat[f"{name}__keys"] = np.asarray(keys)
        for k in keys:
            flat[f"{name}_{k}"] = np.asarray(layer[k], np.float32)
    else:
        flat[name] = np.asarray(layer, np.float32)


def _get(data, name: str) -> list[np.ndarray]:
    """Layer ``name``'s leaves in JAX's leaf order."""
    if name in data:
        return [np.asarray(data[name], np.float32)]
    if f"{name}__keys" in data:
        keys = [str(k) for k in data[f"{name}__keys"]]
    else:
        keys = list(_GAT_KEYS)
    return [np.asarray(data[f"{name}_{k}"], np.float32) for k in sorted(keys)]


def save_checkpoint(path: str, weights: list, opt_state, epoch: int, *,
                    keys: list[tuple[str, ...] | None], seed: int | None = None) -> None:
    """Write the run's state to ``path`` (``.npz``): ``weights`` and the
    ``optim.AdamState`` ``opt_state`` (tensors, the port's flat leaves),
    grouped into JAX's layers by ``keys`` (the model's ``layer_keys``: None for
    a GCN layer's array, else the layer dict's keys), ``epoch``, and the
    generator ``seed``."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    flat = {"epoch": np.asarray(epoch),
            "step": np.asarray(int(opt_state.step), dtype=np.int32)}
    if seed is not None:
        flat[_SEED_KEY] = np.asarray(seed, dtype=np.int64)
    ws, ms, vs = (params_to_numpy(list(t), keys) for t in (weights, opt_state.m, opt_state.v))
    for i, (w, m, v) in enumerate(zip(ws, ms, vs)):
        _put(flat, f"w{i}", w)
        _put(flat, f"m{i}", m)
        _put(flat, f"v{i}", v)
    flat["n_weights"] = np.asarray(len(ws))
    np.savez(path, **flat)


def load_checkpoint(path: str) -> Checkpoint:
    """Read a checkpoint written by either package."""
    with np.load(path) as data:
        n = int(data["n_weights"])
        leaves = {p: [a for i in range(n) for a in _get(data, f"{p}{i}")] for p in "wmv"}
        return Checkpoint(weights=leaves["w"], m=leaves["m"], v=leaves["v"],
                          step=int(data["step"]), epoch=int(data["epoch"]),
                          seed=int(data[_SEED_KEY]) if _SEED_KEY in data else None)
