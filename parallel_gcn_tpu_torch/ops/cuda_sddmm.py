"""SDDMM on BCSR tiles: CUDA kernel and plain version.

Port of ``parallel_gcn_tpu/ops/pallas_sddmm.py`` (K8 ``_sddmm_kernel``):
``out[t] = a[rows_t·R:(rows_t+1)·R] @ b[cols_t·C:(cols_t+1)·C]ᵀ`` for every
tile position of a pack, f32 [T, R, C] in pack order. Only the pack's tile
geometry is used, not its values; masking to the exact edges is the caller's
product with a pattern pack's tiles. The kernel is ``csrc/sddmm.cu``.

The backward reuses the SpMM (K3, ``ops/cuda_bcsr.bcsr_matmul_impl`` with
``dense_tiles``: every entry of G is live) on the score cotangent G as value
tiles at the pack's positions:
``dA = G·B`` over the pack, and ``dB = Gᵀ·A`` over the mirror-transposed
tiles (``mirror_perm``), which needs square tiles and a symmetric position
set, as the JAX op asserts.

``sddmm_bcsr`` runs the kernel for CUDA tensors and ``sddmm_plain`` for CPU
ones; ``launches`` counts kernel launches. For bf16 the kernel reads a and
b with K padded to a multiple of 16 (zeros; ``cuda_bcsr.pad_features``).
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from parallel_gcn_tpu_torch.ops import _build
from parallel_gcn_tpu_torch.ops.cuda_bcsr import BCSR, bcsr_matmul_impl, pad_features

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

launches = {"sddmm": 0}


def sddmm_plain(pack: BCSR, a: torch.Tensor, b: torch.Tensor,
                batch: int = 64) -> torch.Tensor:
    """Plain PyTorch version: the gathered row and column blocks of a and b
    multiplied as a batched f32 product, ``batch`` tiles at a time."""
    R, C, K = pack.tile_r, pack.tile_c, a.shape[1]
    a3 = a.float().view(-1, R, K)
    b3 = b.float().view(-1, C, K)
    out = torch.empty((pack.n_tiles, R, C), dtype=torch.float32, device=a.device)
    rows, cols = pack.tile_rows.long(), pack.tile_cols.long()
    for b0 in range(0, pack.n_tiles, batch):
        sl = slice(b0, b0 + batch)
        torch.bmm(a3[rows[sl]], b3[cols[sl]].transpose(1, 2), out=out[sl])
    return out


def _sddmm_impl(pack: BCSR, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if a.device.type == "cpu":
        return sddmm_plain(pack, a, b)
    if a.device.type != "cuda":
        raise ValueError(f"sddmm_bcsr: unsupported device {a.device}")
    if a.dtype not in _DTYPE_CODE or b.dtype != a.dtype:
        raise TypeError(f"sddmm kernel takes float32 or bfloat16 a and b of one dtype, "
                        f"got {a.dtype} and {b.dtype}")
    if pack.tile_r % 128 or pack.tile_c % 128:
        raise ValueError(f"sddmm kernel needs tile sides that are multiples of 128, got "
                         f"({pack.tile_r}, {pack.tile_c})")
    index = (pack.tile_rows, pack.tile_cols)
    if any(t.dtype != torch.int32 or t.device != a.device for t in index):
        raise TypeError("the pack's tile_rows and tile_cols must be int32 on a's device")
    if b.device != a.device:
        raise ValueError("a and b must be on one device")
    out = torch.empty((pack.n_tiles, pack.tile_r, pack.tile_c), dtype=torch.float32,
                      device=a.device)
    if pack.n_tiles == 0 or a.shape[1] == 0:
        return out.zero_()
    if a.dtype == torch.bfloat16:
        # whole k16 steps, 16-byte aligned rows for the kernel's copies
        a, b = pad_features(a), pad_features(b)
    else:
        a, b = a.contiguous(), b.contiguous()
    lib = _build.load_library()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.pgcn_sddmm(
            pack.tile_rows.data_ptr(), pack.tile_cols.data_ptr(), pack.n_tiles,
            a.data_ptr(), b.data_ptr(), _DTYPE_CODE[a.dtype], a.shape[1], out.data_ptr(),
            pack.tile_r, pack.tile_c, ctypes.c_void_p(stream),
        )
    _build.check(rc, "sddmm kernel")
    launches["sddmm"] += 1
    return out


class _Sddmm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, pack):
        ctx.pack = pack
        ctx.save_for_backward(a, b)
        return _sddmm_impl(pack, a, b)

    @staticmethod
    def backward(ctx, g):
        # pallas_sddmm.py:82-95: G's tiles are value tiles at the pack's
        # positions, so dA = G·B is the SpMM; dB = Gᵀ·A is the SpMM over the
        # transposed tiles, each moved to its mirror's slot
        a, b = ctx.saved_tensors
        pack = dataclasses.replace(ctx.pack, sym_scale=None)
        g = g.float()
        da = bcsr_matmul_impl(dataclasses.replace(pack, tiles=g.to(b.dtype).contiguous()), b,
                              dense_tiles=True)
        gt = torch.index_select(g.transpose(1, 2), 0, pack.mirror_perm)
        db = bcsr_matmul_impl(dataclasses.replace(pack, tiles=gt.to(a.dtype).contiguous()), a,
                              dense_tiles=True)
        return da.to(a.dtype), db.to(b.dtype), None


def sddmm_bcsr(pack: BCSR, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-tile score blocks ``out[t] = a[rows_t·R:(rows_t+1)·R] @ b[...]ᵀ``
    for every tile position of ``pack``, f32 [T, tile_r, tile_c] in pack
    order. a, b: [pack.n_nodes, K] f32 or bf16. Differentiable in a and b;
    the backward needs square tiles and ``mirror_perm`` (a symmetric
    position set), which the JAX op asserts and this one raises on."""
    if a.dim() != 2 or b.dim() != 2:
        raise ValueError(f"a and b must be [n, K], got {tuple(a.shape)} and {tuple(b.shape)}")
    if a.shape[0] != pack.n_nodes or b.shape[0] != pack.n_nodes:
        raise ValueError(f"a and b need {pack.n_nodes} rows, got {a.shape[0]} and {b.shape[0]}")
    if a.shape[1] != b.shape[1]:
        raise ValueError(f"a and b differ in K: {a.shape[1]} and {b.shape[1]}")
    if pack.tile_r != pack.tile_c:
        raise ValueError("sddmm backward needs square tiles (symmetric transpose shortcut), "
                         f"got ({pack.tile_r}, {pack.tile_c})")
    if pack.mirror_perm is None:
        raise ValueError("sddmm backward needs a symmetric tile-position set (mirror_perm "
                         "is computed by build_bcsr when the pattern is symmetric)")
    return _Sddmm.apply(a, b, pack)
