"""Inverted dropout and fused ReLU→dropout: CUDA kernel and plain version.

Port of ``parallel_gcn_tpu/ops/pallas_dropout.py`` (K1 ``dropout_pallas``,
K2 ``relu_dropout_pallas``); the kernel is ``csrc/dropout.cu``.

The TPU kernels draw their mask from the TPU's hardware PRNG, which no other
device reproduces. The port's mask contract: Philox4x32-10 keyed by the
64-bit ``seed``; element i of the flattened tensor uses counter
``(i + o) >> 2`` and output word ``(i + o) & 3``, and is kept iff that word
is below ``thr = min(round(keep·2³²), 2³²−1)``. The element offset ``o`` is
0 for a whole tensor; a slice of a longer masked tensor passes the index of
its first element, and draws the matching slice of that tensor's mask (the
streaming GAT attention masks its edge chunks so). The kernel takes
offsets that are multiples of 4 (whole counters). Kept elements become
``x · (1/keep)`` in x's dtype. The mask depends only on (seed, i), so

- the backward of ``dropout`` is ``dropout`` of the cotangent with the same
  seed (the mask is never stored);
- ``relu_dropout(x) == dropout(relu(x))`` bit for bit, and its backward
  ``g·1[out>0]/keep`` needs only the saved output (plain elementwise torch,
  as the JAX package leaves it to XLA).

Seeds. The kernel reads its seed from device memory, so that a launch
captured in a CUDA graph draws a new mask each replay: a wrapper takes a
seed slot (a one-element integer tensor on x's device, which the trainer
rewrites before each epoch, ``train.SeedSlots``) or a Python int (unit
tests, kernel checks), which ``seed_tensor`` writes to the device with a
fill kernel. The plain version takes either, without reading a slot on the
host.

Each wrapper runs the kernel for a CUDA tensor and the plain PyTorch version
(``dropout_plain``), which computes the same bits with int64 arithmetic, for
a CPU tensor. The kernel takes any contiguous tensor: one whose data is not
16-byte aligned (a view with a storage offset) or whose length is not a
whole number of 16-byte vectors takes the kernel's scalar path for those
elements, with the same bits. ``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from parallel_gcn_tpu_torch.ops import _build

_M32 = 0xFFFFFFFF
_PHILOX_M0 = 0xD2511F53
_PHILOX_M1 = 0xCD9E8D57
_PHILOX_W0 = 0x9E3779B9
_PHILOX_W1 = 0xBB67AE85

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# kernel launches by wrapper: "dropout" (K1), "relu_dropout" (K2)
launches = {"dropout": 0, "relu_dropout": 0}

Seed = int | torch.Tensor  # a Python int, or a slot the kernels read on the device


def seed_tensor(seed: Seed, device, dtype: torch.dtype = torch.int64) -> torch.Tensor:
    """``seed`` as the one-element tensor on ``device`` that a kernel reads:
    a slot as it is (cast to ``dtype`` if it holds another integer type), an
    int (a uint64, or for ``torch.int32`` a uint32) as its bits in
    ``dtype``, written by a fill kernel (no host-to-device copy)."""
    if isinstance(seed, torch.Tensor):
        if seed.numel() != 1 or seed.is_floating_point() or seed.device != torch.device(device):
            raise ValueError(f"a seed slot is one integer element on {device}, got "
                             f"{tuple(seed.shape)} {seed.dtype} on {seed.device}")
        return seed if seed.dtype == dtype else seed.to(dtype)
    bits = 64 if dtype == torch.int64 else 32
    if not 0 <= seed < 2**bits:
        raise ValueError(f"seed must be a uint{bits}, got {seed}")
    signed = seed - 2**bits if seed >= 2 ** (bits - 1) else seed
    return torch.full((1,), signed, dtype=dtype, device=device)


def _seed_halves(seed: Seed, device):
    """(low, high) 32-bit words of a uint64 seed: ints, or int64 0-d
    tensors on ``device`` for a slot (never read on the host)."""
    if isinstance(seed, torch.Tensor):
        key = seed.reshape(()).to(device=device, dtype=torch.int64)
        return key & _M32, (key >> 32) & _M32
    return seed & _M32, (seed >> 32) & _M32


def keep_threshold(rate: float) -> int:
    """uint32 threshold with P(word < thr) = 1 - rate
    (pallas_dropout.py:61)."""
    keep = 1.0 - rate
    return min(int(round(keep * 2.0**32)), 2**32 - 1)


def _mulhilo(m: int, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) 32-bit halves of m·b for m < 2³² and int64 b < 2³², without
    overflowing int64: b is split into 16-bit halves."""
    pl = (b & 0xFFFF) * m  # < 2^48
    ph = (b >> 16) * m  # < 2^48
    s = pl + ((ph & 0xFFFF) << 16)  # < 2^49
    return (ph >> 16) + (s >> 32), s & _M32


def philox4x32_10(
    c0: torch.Tensor, c1: torch.Tensor, c2: torch.Tensor, c3: torch.Tensor,
    k0: int | torch.Tensor, k1: int | torch.Tensor,
) -> tuple[torch.Tensor, ...]:
    """Philox4x32-10 on int64 tensors holding uint32 words; the key words are
    ints or int64 0-d tensors."""
    for rnd in range(10):
        if rnd:
            k0 = (k0 + _PHILOX_W0) & _M32
            k1 = (k1 + _PHILOX_W1) & _M32
        hi0, lo0 = _mulhilo(_PHILOX_M0, c0)
        hi1, lo1 = _mulhilo(_PHILOX_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def philox_words(seed: Seed, n: int, device, offset: int = 0) -> torch.Tensor:
    """The n uint32 words (as int64) the mask contract assigns to elements
    0..n-1 at element offset ``offset`` for ``seed`` (an int or a slot)."""
    lo = offset >> 2
    ctr = torch.arange(lo, (offset + n + 3) // 4, dtype=torch.int64, device=device)
    zero = torch.zeros_like(ctr)
    words = philox4x32_10(ctr & _M32, ctr >> 32, zero, zero, *_seed_halves(seed, device))
    skip = offset & 3
    return torch.stack(words, dim=1).reshape(-1)[skip : skip + n]


def keep_mask(seed: Seed, rate: float, shape, device, offset: int = 0) -> torch.Tensor:
    """The contract's keep mask of a contiguous tensor of ``shape`` at
    element offset ``offset``: the element with flat index i is kept iff
    word ``(i + offset) & 3`` of Philox counter ``(i + offset) >> 2`` is
    below ``keep_threshold(rate)``. K1, K2 and the fused dropout⊗matmul
    kernel (``ops/cuda_fused.py``) all draw this mask."""
    n = math.prod(shape)
    return (philox_words(seed, n, device, offset) < keep_threshold(rate)).view(shape)


@functools.lru_cache(maxsize=64)
def _inv_keep(rate: float, dtype: torch.dtype) -> float:
    """1/keep rounded to ``dtype`` (as the Pallas kernel multiplies by it),
    as a Python float. A Python scalar keeps the multiply free of a
    host-to-device copy; its value is exact in float32, so ``x * s`` rounds
    like a product with a ``dtype`` scalar."""
    return float(torch.tensor(1.0 / (1.0 - rate), dtype=dtype))


def dropout_plain(x: torch.Tensor, seed: Seed, rate: float,
                  relu: bool = False, offset: int = 0) -> torch.Tensor:
    """Plain PyTorch version of the kernel (same bits, same rounding), at
    any element offset."""
    keep = keep_mask(seed, rate, x.shape, x.device, offset)
    if relu:
        keep = keep & (x > 0)
    return torch.where(keep, x * _inv_keep(rate, x.dtype), 0.0)


def _run(x: torch.Tensor, seed: Seed, rate: float, relu: bool,
         offset: int = 0) -> torch.Tensor:
    if x.device.type == "cpu":
        return dropout_plain(x, seed, rate, relu, offset)
    if x.device.type != "cuda":
        raise ValueError(f"dropout: unsupported device {x.device}")
    if offset < 0 or offset % 4:
        raise ValueError(f"the dropout kernel takes element offsets that are multiples of 4, "
                         f"got {offset}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"dropout kernel takes float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("dropout kernel needs a contiguous tensor")
    slot = seed_tensor(seed, x.device)
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    lib = _build.load_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.pgcn_dropout(
            x.data_ptr(), out.data_ptr(), x.numel(), _DTYPE_CODE[x.dtype],
            int(relu), slot.data_ptr(), offset >> 2, keep_threshold(rate),
            _inv_keep(rate, x.dtype), ctypes.c_void_p(stream),
        )
    _build.check(rc, "dropout kernel")
    launches["relu_dropout" if relu else "dropout"] += 1
    return out


class _Dropout(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, seed, rate, offset):
        ctx.seed, ctx.rate, ctx.offset = seed, rate, offset
        return _run(x, seed, rate, relu=False, offset=offset)

    @staticmethod
    def backward(ctx, g):
        # same (seed, index) → same mask, applied to the cotangent
        return (_run(g.contiguous(), ctx.seed, ctx.rate, relu=False, offset=ctx.offset),
                None, None, None)


class _ReluDropout(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, seed, rate):
        out = _run(x, seed, rate, relu=True)
        ctx.save_for_backward(out)
        ctx.rate = rate
        return out

    @staticmethod
    def backward(ctx, g):
        (out,) = ctx.saved_tensors
        return torch.where(out > 0, g * _inv_keep(ctx.rate, g.dtype), 0.0), None, None


def dropout(x: torch.Tensor, seed: Seed, rate: float, offset: int = 0) -> torch.Tensor:
    """Inverted dropout of ``x`` (K1) with ``seed`` (an int or a slot), its
    elements at ``offset`` in the mask's index (the module docstring). Rate
    0 is the identity."""
    if rate <= 0.0:
        return x
    return _Dropout.apply(x, seed, rate, offset)


def relu_dropout(x: torch.Tensor, seed: Seed, rate: float) -> torch.Tensor:
    """``dropout(relu(x))`` in one pass (K2) with ``seed`` (an int or a
    slot). Rate 0 is a plain ReLU."""
    if rate <= 0.0:
        return torch.relu(x)
    return _ReluDropout.apply(x, seed, rate)
