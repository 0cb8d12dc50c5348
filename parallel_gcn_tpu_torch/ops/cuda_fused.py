"""Fused inverted dropout and matmul ``(mask ⊙ X)·W / keep``: CUDA kernels
and plain versions.

Port of ``parallel_gcn_tpu/ops/pallas_fused.py`` (K10 ``_fwd_kernel``,
``_dw_kernel``, ``_dx_kernel``, behind ``dropout_matmul``); the kernels are
``csrc/dropout_matmul.cu``. X is read once and the masked X never exists in
memory: each kernel regenerates the mask.

The mask is the port's K1 mask (``cuda_dropout.keep_mask``): element (r, c)
of the contiguous [N, K] X has flat index r·K + c, so for one seed the
fused and unfused (``dropout`` then ``feature_transform``) paths drop the
same elements, and ``fuse_dropout_matmul`` changes a trajectory only by
matmul rounding, as in the JAX package (pallas_fused.py:106-116).

Rounding points (pallas_fused.py:49-104, 226-238):
  forward  xm = where(mask, x · (1/keep rounded to x's dtype), 0) in x's
           dtype; Y = xm @ W with f32 accumulation, returned in f32;
  dW       xmᵀ @ g with g rounded to x's dtype, f32 accumulation, returned
           in W's dtype;
  dX       where(mask, (g @ Wᵀ in f32) · (1/keep as f32), 0) in x's dtype.

The seed is an int or a slot the kernels read on the device, as for K1
(``cuda_dropout.seed_tensor``). Each wrapper runs the kernel for CUDA
tensors and the plain PyTorch version for CPU tensors; ``launches`` counts
kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from parallel_gcn_tpu_torch.ops import _build, cuda_dropout
from parallel_gcn_tpu_torch.ops.cuda_dropout import Seed, seed_tensor

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_DW_CHUNK = 64  # rows of a dW split are a multiple of this (csrc/dropout_matmul.cu kSplitRows)
_DW_MAX_SLAB = 320  # x columns a bf16 dW block owns at most (kDwMaxSlab)
_DW_NB = 48  # g columns a bf16 dW block owns (kDwNB); the f32 kernel's blocks are 64 x 48

# kernel launches by kernel: "fused_fwd", "fused_dw", "fused_dx"
launches = {"fused_fwd": 0, "fused_dw": 0, "fused_dx": 0}


def _masked_x(x: torch.Tensor, seed: Seed, rate: float) -> torch.Tensor:
    keep = cuda_dropout.keep_mask(seed, rate, x.shape, x.device)
    return torch.where(keep, x * cuda_dropout._inv_keep(rate, x.dtype), 0.0)


def dropout_matmul_plain(x: torch.Tensor, w: torch.Tensor, seed: Seed,
                         rate: float) -> torch.Tensor:
    """Plain forward: ``xm @ w.to(x.dtype)`` in f32, [N, M] float32."""
    xm = _masked_x(x, seed, rate)
    return torch.matmul(xm.float(), w.to(x.dtype).float())


def dropout_matmul_dw_plain(x: torch.Tensor, g: torch.Tensor, seed: Seed, rate: float,
                            w_dtype: torch.dtype) -> torch.Tensor:
    """Plain dW: ``xmᵀ @ g.to(x.dtype)`` in f32, returned in ``w_dtype``."""
    xm = _masked_x(x, seed, rate)
    return torch.matmul(xm.float().T, g.float().to(x.dtype).float()).to(w_dtype)


def dropout_matmul_dx_plain(g: torch.Tensor, w: torch.Tensor, seed: Seed, rate: float,
                            x_dtype: torch.dtype) -> torch.Tensor:
    """Plain dX: ``where(mask, (g @ wᵀ)·(1/keep), 0)`` in f32, returned in
    ``x_dtype``."""
    gw = torch.matmul(g.float(), w.float().T)
    keep = cuda_dropout.keep_mask(seed, rate, gw.shape, gw.device)
    return torch.where(keep, gw * (1.0 / (1.0 - rate)), 0.0).to(x_dtype)


def _check(what: str, x_dtype: torch.dtype, *tensors: torch.Tensor) -> None:
    """Raise on what the kernels do not take: a dtype other than f32/bf16,
    an operand that is not 2-D, nonempty, contiguous and on the first
    operand's device (``seed_tensor`` checks the seed)."""
    if x_dtype not in _DTYPE_CODE:
        raise TypeError(f"{what}: the kernel takes float32 or bfloat16 x, got {x_dtype}")
    for t in tensors:
        if t.dim() != 2 or 0 in t.shape:
            raise ValueError(f"{what}: operands must be 2-D and nonempty, got "
                             f"{tuple(t.shape)}")
        if t.device != tensors[0].device or not t.is_contiguous():
            raise ValueError(f"{what}: operands must be contiguous, on one device")


def _stream(dev: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)


def _on_cpu(t: torch.Tensor, what: str) -> bool:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {t.device}")
    return t.device.type == "cpu"


def _fwd(x: torch.Tensor, w: torch.Tensor, seed: Seed, rate: float) -> torch.Tensor:
    if _on_cpu(x, "dropout_matmul"):
        return dropout_matmul_plain(x, w, seed, rate)
    _check("dropout_matmul", x.dtype, x, w)
    n, k = x.shape
    m = w.shape[1]
    if w.dtype != x.dtype or w.shape[0] != k:
        raise ValueError(f"dropout_matmul: w must be [{k}, M] in x's dtype {x.dtype}, "
                         f"got {tuple(w.shape)} {w.dtype}")
    slot = seed_tensor(seed, x.device)
    out = torch.empty((n, m), dtype=torch.float32, device=x.device)
    lib = _build.load_library()
    with torch.cuda.device(x.device):
        rc = lib.pgcn_dropout_matmul_fwd(
            x.data_ptr(), w.data_ptr(), out.data_ptr(), _DTYPE_CODE[x.dtype], n, k, m,
            slot.data_ptr(), cuda_dropout.keep_threshold(rate),
            cuda_dropout._inv_keep(rate, x.dtype), _stream(x.device))
    _build.check(rc, "dropout_matmul forward kernel")
    launches["fused_fwd"] += 1
    return out


def dw_slab(k: int) -> int:
    """x columns a bf16 dW block owns: k in the fewest slabs of at most 320
    columns, each rounded up to a multiple of 64 (g is read once a slab)."""
    cols = -(-k // -(-k // _DW_MAX_SLAB))
    return -(-cols // 64) * 64


def dw_splits(n: int, k: int, m: int, blocks: int,
              dtype: torch.dtype = torch.bfloat16) -> tuple[int, int]:
    """(splits, rows_per_split) of the dW kernel: row ranges of a multiple
    of 64 rows, enough of them that the blocks of one pass (slabs × column
    blocks × splits) fill ``blocks``, the blocks the card holds at once."""
    if dtype == torch.bfloat16:
        slabs = -(-k // dw_slab(k)) * -(-m // _DW_NB)
    else:
        slabs = -(-k // 64) * -(-m // 48)
    want = max(1, min(-(-n // _DW_CHUNK), -(-blocks // slabs)))
    rows = -(-n // want)
    rows = -(-rows // _DW_CHUNK) * _DW_CHUNK
    return -(-n // rows), rows


@functools.lru_cache(maxsize=64)
def _dw_blocks(device: int, dtype: torch.dtype, slab: int) -> int:
    """The dW kernel's blocks that card ``device`` holds at once."""
    blocks = ctypes.c_int(0)
    with torch.cuda.device(device):
        rc = _build.load_library().pgcn_dropout_matmul_dw_blocks(
            _DTYPE_CODE[dtype], slab, ctypes.byref(blocks))
    _build.check(rc, "dropout_matmul dW occupancy")
    return blocks.value


def _dw(x: torch.Tensor, g: torch.Tensor, seed: Seed, rate: float,
        w_dtype: torch.dtype) -> torch.Tensor:
    if _on_cpu(x, "dropout_matmul dW"):
        return dropout_matmul_dw_plain(x, g, seed, rate, w_dtype)
    _check("dropout_matmul dW", x.dtype, x, g)
    n, k = x.shape
    m = g.shape[1]
    if g.dtype != torch.float32 or g.shape[0] != n or w_dtype != x.dtype:
        raise ValueError(f"dropout_matmul dW: g must be float32 [{n}, M] and w of "
                         f"x's dtype, got g {tuple(g.shape)} {g.dtype}, w {w_dtype}")
    slot = seed_tensor(seed, x.device)
    lib = _build.load_library()
    slab = dw_slab(k)
    with torch.cuda.device(x.device):
        splits, rows = dw_splits(n, k, m, _dw_blocks(x.device.index, x.dtype, slab), x.dtype)
        ws = torch.empty((splits, k, m), dtype=torch.float32, device=x.device)
        dw = torch.empty((k, m), dtype=w_dtype, device=x.device)
        rc = lib.pgcn_dropout_matmul_dw(
            x.data_ptr(), g.data_ptr(), ws.data_ptr(), dw.data_ptr(),
            _DTYPE_CODE[x.dtype], n, k, m, slab, splits, rows, slot.data_ptr(),
            cuda_dropout.keep_threshold(rate), cuda_dropout._inv_keep(rate, x.dtype),
            _stream(x.device))
    _build.check(rc, "dropout_matmul dW kernel")
    launches["fused_dw"] += 1
    return dw


def _dx(g: torch.Tensor, w: torch.Tensor, seed: Seed, rate: float,
        x_dtype: torch.dtype) -> torch.Tensor:
    if _on_cpu(g, "dropout_matmul dX"):
        return dropout_matmul_dx_plain(g, w, seed, rate, x_dtype)
    _check("dropout_matmul dX", x_dtype, g, w)
    n, m = g.shape
    k = w.shape[0]
    if g.dtype != torch.float32 or w.dtype != x_dtype or w.shape[1] != m:
        raise ValueError(f"dropout_matmul dX: g must be float32 [N, {w.shape[1]}] and w "
                         f"of x's dtype, got g {tuple(g.shape)} {g.dtype}, w {w.dtype}")
    if g.data_ptr() % 16:  # the bf16 kernel copies g's rows in 16-byte pieces
        g = g.clone()
    slot = seed_tensor(seed, g.device)
    dx = torch.empty((n, k), dtype=x_dtype, device=g.device)
    lib = _build.load_library()
    with torch.cuda.device(g.device):
        rc = lib.pgcn_dropout_matmul_dx(
            g.data_ptr(), w.data_ptr(), dx.data_ptr(), _DTYPE_CODE[x_dtype], n, k, m,
            slot.data_ptr(), cuda_dropout.keep_threshold(rate), 1.0 / (1.0 - rate),
            _stream(g.device))
    _build.check(rc, "dropout_matmul dX kernel")
    launches["fused_dx"] += 1
    return dx


class _DropoutMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, seed, rate, need_dx):
        ctx.save_for_backward(x, w)
        ctx.seed, ctx.rate, ctx.need_dx = seed, rate, need_dx
        return _fwd(x, w, seed, rate)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.float().contiguous()
        dw = _dw(x, g, ctx.seed, ctx.rate, w.dtype) if ctx.needs_input_grad[1] else None
        dx = None
        if ctx.needs_input_grad[0]:
            dx = (_dx(g, w, ctx.seed, ctx.rate, x.dtype) if ctx.need_dx
                  else torch.zeros_like(x))
        return dx, dw, None, None, None


def dropout_matmul(x: torch.Tensor, w: torch.Tensor, seed: Seed, rate: float,
                   need_dx: bool = True) -> torch.Tensor:
    """``dropout(x, seed, rate) @ w`` as float32 [N, M], with the mask made
    inside the kernels. ``rate`` in (0, 1): rate-0 callers take a plain
    matmul. ``need_dx=False`` (an input layer, whose x is data) returns a
    zero gradient for x without running the dX kernel."""
    if not 0.0 < rate < 1.0:
        raise ValueError(f"dropout_matmul needs a rate in (0, 1), got {rate}")
    return _DropoutMatmul.apply(x, w, seed, rate, need_dx)
