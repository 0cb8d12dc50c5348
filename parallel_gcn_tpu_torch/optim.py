"""Adam, matching the reference's math (src/optim.cu:42-62).

Port of ``parallel_gcn_tpu/optim.py``: L2 decay folded into the gradient of
leaf 0 only (the first layer's weight, src/gcn.cu:157-158), biased moments,
and a bias-corrected step size

    step_size = lr · sqrt(1 − β2^t) / (1 − β1^t)
    w -= step_size · m / (sqrt(v) + eps)        # eps outside the sqrt

The step count t is a device tensor and the step size is computed on the
device in float32, as the JAX package's ``adam_step`` does, so a step holds
no host scalar that depends on t: an epoch captured in a CUDA graph takes a
new step size each replay, and the host never reads the count.

Unlike the JAX version, ``adam_step`` updates weights, moments and the count
IN PLACE (under ``torch.no_grad()``), which saves a copy of every parameter
per step.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class AdamState:
    step: torch.Tensor  # int32 scalar on the weights' device: steps taken
    m: list[torch.Tensor]  # first moments, one per weight
    v: list[torch.Tensor]  # second moments


def init_adam(weights: list[torch.Tensor]) -> AdamState:
    return AdamState(
        step=torch.zeros((), dtype=torch.int32, device=weights[0].device),
        m=[torch.zeros_like(w) for w in weights],
        v=[torch.zeros_like(w) for w in weights],
    )


def adam_step(
    weights: list[torch.Tensor],
    grads: list[torch.Tensor],
    state: AdamState,
    *,
    learning_rate: float,
    weight_decay: float,
    beta1: float = 0.9,
    beta2: float = 0.999,
    eps: float = 1e-8,
) -> None:
    """One update of ``weights`` and ``state``, in place. Decay applies to
    ``weights[0]`` only."""
    f32 = np.float32
    b1, b2 = f32(beta1), f32(beta2)
    one = f32(1.0)
    with torch.no_grad():
        state.step.add_(1)
        t = state.step.float()
        # float32 throughout, as jnp's f32 power and sqrt of the JAX step
        step_size = (float(f32(learning_rate)) * torch.sqrt(1.0 - torch.pow(float(b2), t))
                     / (1.0 - torch.pow(float(b1), t)))
        for i, (w, g, m, v) in enumerate(zip(weights, grads, state.m, state.v)):
            g = g.float()
            if i == 0 and weight_decay:
                g = g + float(f32(weight_decay)) * w
            m.mul_(float(b1)).add_(float(one - b1) * g)
            v.mul_(float(b2)).add_(float(one - b2) * g * g)
            w.sub_(step_size * m / (v.sqrt() + float(f32(eps))))
