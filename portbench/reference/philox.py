"""The dropout mask the program's kernels draw, worked out again (frozen copy
of the mask contract in ``parallel_gcn_tpu_torch/ops/cuda_dropout.py``):
element i of a contiguous [rows, F] tensor is kept iff word ``i & 3`` of
Philox4x32-10 counter ``i >> 2`` under the layer's 64-bit seed is below
round((1 − rate)·2³²). Also the per-epoch dropout seeds of
``train.epoch_seeds``: one draw of ``randint(0, 2**62, (n_layers,))`` an
epoch from a CPU ``torch.Generator`` seeded with the run's seed."""

from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF
_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85


def _mulhilo(m: int, b: torch.Tensor):
    pl = (b & 0xFFFF) * m
    ph = (b >> 16) * m
    s = pl + ((ph & 0xFFFF) << 16)
    return (ph >> 16) + (s >> 32), s & _M32


def philox_words(seed: int, n: int, device) -> torch.Tensor:
    """The n uint32 words (as int64) of elements 0..n−1."""
    ctr = torch.arange(0, (n + 3) // 4, dtype=torch.int64, device=device)
    c0, c1 = ctr & _M32, ctr >> 32
    c2 = torch.zeros_like(ctr)
    c3 = torch.zeros_like(ctr)
    k0, k1 = seed & _M32, (seed >> 32) & _M32
    for rnd in range(10):
        if rnd:
            k0 = (k0 + _W0) & _M32
            k1 = (k1 + _W1) & _M32
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return torch.stack([c0, c1, c2, c3], dim=1).reshape(-1)[:n]


def keep_mask(seed: int, rate: float, rows: int, cols: int, device) -> torch.Tensor:
    """Bool [rows, cols]: the elements a dropout at ``rate`` keeps."""
    thr = min(int(round((1.0 - rate) * 2.0**32)), 2**32 - 1)
    return (philox_words(seed, rows * cols, device) < thr).view(rows, cols)


def epoch_seeds(run_seed: int, epochs: int, n_layers: int) -> list[list[int]]:
    """Each epoch's per-layer dropout seeds of a run seeded ``run_seed``."""
    gen = torch.Generator().manual_seed(run_seed)
    return [torch.randint(0, 2**62, (n_layers,), generator=gen).tolist()
            for _ in range(epochs)]
