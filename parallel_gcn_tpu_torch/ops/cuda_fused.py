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

Seed lanes (``dropout_matmul_lanes``): one launch runs a layer of S training
runs (``seeds.fit_seeds``), as JAX's ``vmap`` of the K10 ``pallas_call``
adds a batch grid axis. x is joined [N, S·K] (lane s in columns s·K …
s·K+K−1) or shared [N, K] (every lane's input, layer 0 of a seed batch);
W is [S, K, M], one weight a lane; the seeds are S (a slot of S integers on
the device, or S ints); the output is [N, S·M] f32, lane s in columns s·M …;
the gradient g is joined [N, S·M] f32 and read in place; dW is [S, K, M]
and dX joined [N, S·K]. Lane s's mask is the solo mask of its own [N, K]
(Philox of its seed at r·K + c), and every output is summed in the solo
launch's order (its dW split plan, ``dw_splits`` as for one lane, and split
order), so lane s is the unlaned kernel on its own operands bit for bit.
The f32 forward over a shared x takes a tile across lanes and reads x's
piece once for the block's lanes; the bf16 dX takes a row tile for every
lane and writes whole joined rows, W's fragments prepared once a launch in
a scratch buffer; the rest run the unlaned body once a lane
(``csrc/dropout_matmul.cu``). The plain versions
(``dropout_matmul_lanes_plain`` and its dW and dX) are the unlaned plain
versions lane by lane.
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

# kernel launches by kernel: "fused_fwd", "fused_dw", "fused_dx", and the
# same over seed lanes
launches = {"fused_fwd": 0, "fused_dw": 0, "fused_dx": 0,
            "fused_fwd_lanes": 0, "fused_dw_lanes": 0, "fused_dx_lanes": 0}


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


def _lane_operands(x: torch.Tensor, w: torch.Tensor, seed: Seed) -> tuple[int, int, int, bool]:
    """(lanes, K, M, shared) of a laned call: W [S, K, M], x joined [N, S·K]
    or shared [N, K], S seeds."""
    if w.dim() != 3 or 0 in w.shape:
        raise ValueError(f"dropout_matmul lanes: w must be [S, K, M], got {tuple(w.shape)}")
    lanes, k, m = w.shape
    if x.dim() != 2 or x.shape[1] not in (k, lanes * k):
        raise ValueError(f"dropout_matmul lanes: x must be [N, {lanes}·{k}] (joined) or "
                         f"[N, {k}] (shared), got {tuple(x.shape)}")
    if cuda_dropout.n_lanes(seed) != lanes:
        raise ValueError(f"dropout_matmul lanes: {lanes} lanes need {lanes} seeds, got "
                         f"{cuda_dropout.n_lanes(seed)}")
    return lanes, k, m, lanes > 1 and x.shape[1] == k


def _lane_cols(t: torch.Tensor, s: int, width: int) -> torch.Tensor:
    """Lane s's columns of a joined [N, S·width] tensor, contiguous."""
    return t[:, s * width:(s + 1) * width].contiguous()


def _lane_x(x: torch.Tensor, s: int, k: int, shared: bool) -> torch.Tensor:
    return x if shared else _lane_cols(x, s, k)


def dropout_matmul_lanes_plain(x: torch.Tensor, w: torch.Tensor, seed: Seed,
                               rate: float) -> torch.Tensor:
    """Plain laned forward: lane s's ``dropout_matmul_plain`` on its own x
    and W[s] with its seed, side by side as [N, S·M] float32."""
    lanes, k, _, shared = _lane_operands(x, w, seed)
    return torch.cat([dropout_matmul_plain(_lane_x(x, s, k, shared), w[s],
                                           cuda_dropout._lane(seed, s), rate)
                      for s in range(lanes)], dim=1)


def dropout_matmul_lanes_dw_plain(x: torch.Tensor, g: torch.Tensor, seed: Seed, rate: float,
                                  w_dtype: torch.dtype, shared: bool = False) -> torch.Tensor:
    """Plain laned dW [S, K, M]: lane s's ``dropout_matmul_dw_plain`` on its
    x (``shared``: every lane's) and its columns of g [N, S·M]."""
    lanes = cuda_dropout.n_lanes(seed)
    k = x.shape[1] if shared else x.shape[1] // lanes
    m = g.shape[1] // lanes
    return torch.stack([dropout_matmul_dw_plain(_lane_x(x, s, k, shared), _lane_cols(g, s, m),
                                                cuda_dropout._lane(seed, s), rate, w_dtype)
                        for s in range(lanes)])


def dropout_matmul_lanes_dx_plain(g: torch.Tensor, w: torch.Tensor, seed: Seed, rate: float,
                                  x_dtype: torch.dtype) -> torch.Tensor:
    """Plain laned dX, joined [N, S·K]: lane s's ``dropout_matmul_dx_plain``
    on its columns of g [N, S·M] and W[s]."""
    lanes, _, m = w.shape
    return torch.cat([dropout_matmul_dx_plain(_lane_cols(g, s, m), w[s],
                                              cuda_dropout._lane(seed, s), rate, x_dtype)
                      for s in range(lanes)], dim=1)


def lane_strides(k: int, m: int, lanes: int, shared: bool) -> tuple[int, int, int]:
    """(x_lane, ldx, ldo) of the laned kernels (``csrc/dropout_matmul.cu``,
    ``LaneArgs``): lane s reads x from element s·x_lane with rows ldx apart
    and writes its output at column s·m of rows ldo apart (its dX at column
    s·k of rows ldx apart)."""
    return (0 if shared else k), (k if shared else lanes * k), lanes * m


def dw_lane_plan(n: int, k: int, m: int, lanes: int, blocks: int,
                 dtype: torch.dtype = torch.bfloat16) -> tuple[int, int, int]:
    """(splits, rows_per_split, grid z) of the laned dW launch: every lane
    takes one solo launch's split plan (``dw_splits``), and the grid's z
    extent covers (lane, split) as lane·splits + split."""
    splits, rows = dw_splits(n, k, m, blocks, dtype)
    if splits * lanes > 65535:
        raise ValueError(f"dropout_matmul lanes dW: {lanes} lanes × {splits} splits exceed the "
                         "grid's z extent")
    return splits, rows, splits * lanes


def _lane_slots(seed: Seed, lanes: int, device) -> torch.Tensor:
    slots = cuda_dropout.lane_seeds(seed, device)
    if slots.numel() != lanes:
        raise ValueError(f"dropout_matmul lanes: {lanes} lanes need {lanes} seeds, got "
                         f"{slots.numel()}")
    return slots


def dx_wfrag_bytes(k: int, m: int, lanes: int) -> int:
    """Scratch bytes of the laned bf16 dX (m <= 64): each lane's W in the
    mma fragment order, ceil(k/16) pairs × ceil(m/16) k16 steps × 512."""
    return lanes * -(-k // 16) * -(-m // 16) * 512


def _fwd_lanes(x: torch.Tensor, w: torch.Tensor, seed: Seed, rate: float) -> torch.Tensor:
    if _on_cpu(x, "dropout_matmul lanes"):
        return dropout_matmul_lanes_plain(x, w, seed, rate)
    lanes, k, m, shared = _lane_operands(x, w, seed)
    _check("dropout_matmul lanes", x.dtype, x)
    if w.dtype != x.dtype or w.device != x.device or not w.is_contiguous():
        raise ValueError(f"dropout_matmul lanes: w must be contiguous on x's device in x's "
                         f"dtype {x.dtype}, got {w.dtype} on {w.device}")
    slots = _lane_slots(seed, lanes, x.device)
    n = x.shape[0]
    x_lane, ldx, _ = lane_strides(k, m, lanes, shared)
    out = torch.empty((n, lanes * m), dtype=torch.float32, device=x.device)
    lib = _build.load_library()
    with torch.cuda.device(x.device):
        rc = lib.pgcn_dropout_matmul_fwd_lanes(
            x.data_ptr(), w.data_ptr(), out.data_ptr(), _DTYPE_CODE[x.dtype], n, k, m, lanes,
            x_lane, ldx, slots.data_ptr(), cuda_dropout.keep_threshold(rate),
            cuda_dropout._inv_keep(rate, x.dtype), _stream(x.device))
    _build.check(rc, "dropout_matmul lanes forward kernel")
    launches["fused_fwd_lanes"] += 1
    return out


def _dw_lanes(x: torch.Tensor, g: torch.Tensor, seed: Seed, rate: float, w_dtype: torch.dtype,
              shared: bool = False) -> torch.Tensor:
    """Laned dW [S, K, M] from the joined g, read in place."""
    if _on_cpu(x, "dropout_matmul lanes dW"):
        return dropout_matmul_lanes_dw_plain(x, g, seed, rate, w_dtype, shared)
    lanes = cuda_dropout.n_lanes(seed)
    _check("dropout_matmul lanes dW", x.dtype, x, g)
    n = x.shape[0]
    k = x.shape[1] if shared else x.shape[1] // lanes
    m = g.shape[1] // lanes
    if (g.dtype != torch.float32 or g.shape[0] != n or g.shape[1] != lanes * m
            or x.shape[1] != (k if shared else lanes * k) or w_dtype != x.dtype):
        raise ValueError(f"dropout_matmul lanes dW: g must be float32 [{n}, {lanes}·M], x "
                         f"[{n}, {lanes}·K] or shared, w of x's dtype; got x {tuple(x.shape)}, "
                         f"g {tuple(g.shape)} {g.dtype}, w {w_dtype}")
    slots = _lane_slots(seed, lanes, x.device)
    lib = _build.load_library()
    slab = dw_slab(k)
    x_lane, ldx, _ = lane_strides(k, m, lanes, shared)
    with torch.cuda.device(x.device):
        splits, rows, _ = dw_lane_plan(n, k, m, lanes,
                                       _dw_blocks(x.device.index, x.dtype, slab), x.dtype)
        ws = torch.empty((lanes, splits, k, m), dtype=torch.float32, device=x.device)
        dw = torch.empty((lanes, k, m), dtype=w_dtype, device=x.device)
        rc = lib.pgcn_dropout_matmul_dw_lanes(
            x.data_ptr(), g.data_ptr(), ws.data_ptr(), dw.data_ptr(),
            _DTYPE_CODE[x.dtype], n, k, m, lanes, x_lane, ldx, slab, splits,
            rows, slots.data_ptr(), cuda_dropout.keep_threshold(rate),
            cuda_dropout._inv_keep(rate, x.dtype), _stream(x.device))
    _build.check(rc, "dropout_matmul lanes dW kernel")
    launches["fused_dw_lanes"] += 1
    return dw


def _dx_lanes(g: torch.Tensor, w: torch.Tensor, seed: Seed, rate: float,
              x_dtype: torch.dtype) -> torch.Tensor:
    """Laned dX, joined [N, S·K] in ``x_dtype``, from the joined g read in
    place."""
    if _on_cpu(g, "dropout_matmul lanes dX"):
        return dropout_matmul_lanes_dx_plain(g, w, seed, rate, x_dtype)
    _check("dropout_matmul lanes dX", x_dtype, g)
    if w.dim() != 3 or w.dtype != x_dtype or not w.is_contiguous() or w.device != g.device:
        raise ValueError(f"dropout_matmul lanes dX: w must be a contiguous [S, K, M] in x's "
                         f"dtype, got {tuple(w.shape)} {w.dtype}")
    lanes, k, m = w.shape
    n = g.shape[0]
    if g.dtype != torch.float32 or g.shape[1] != lanes * m:
        raise ValueError(f"dropout_matmul lanes dX: g must be float32 [N, {lanes}·{m}], got "
                         f"{tuple(g.shape)} {g.dtype}")
    if g.data_ptr() % 16:  # the bf16 kernel copies g's rows in 16-byte pieces
        g = g.clone()
    slots = _lane_slots(seed, lanes, g.device)
    frag = x_dtype == torch.bfloat16 and m <= 64
    wfrag = torch.empty(dx_wfrag_bytes(k, m, lanes) if frag else 0, dtype=torch.uint8,
                        device=g.device)
    dx = torch.empty((n, lanes * k), dtype=x_dtype, device=g.device)
    lib = _build.load_library()
    with torch.cuda.device(g.device):
        rc = lib.pgcn_dropout_matmul_dx_lanes(
            g.data_ptr(), w.data_ptr(), wfrag.data_ptr(), dx.data_ptr(), _DTYPE_CODE[x_dtype],
            n, k, m, lanes, slots.data_ptr(), cuda_dropout.keep_threshold(rate),
            1.0 / (1.0 - rate), _stream(g.device))
    _build.check(rc, "dropout_matmul lanes dX kernel")
    launches["fused_dx_lanes"] += 1
    return dx


class _DropoutMatmulLanes(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, seed, rate, need_dx):
        ctx.save_for_backward(x, w)
        ctx.seed, ctx.rate, ctx.need_dx = seed, rate, need_dx
        ctx.shared = _lane_operands(x, w, seed)[3]
        return _fwd_lanes(x, w, seed, rate)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.float().contiguous()
        dw = (_dw_lanes(x, g, ctx.seed, ctx.rate, w.dtype, ctx.shared)
              if ctx.needs_input_grad[1] else None)
        dx = None
        if ctx.needs_input_grad[0]:
            dx = (_dx_lanes(g, w, ctx.seed, ctx.rate, x.dtype) if ctx.need_dx
                  else torch.zeros_like(x))
        return dx, dw, None, None, None


def dropout_matmul_lanes(x: torch.Tensor, w: torch.Tensor, seed: Seed, rate: float,
                         need_dx: bool = True) -> torch.Tensor:
    """``dropout_matmul`` of S seed lanes in one launch each way (module
    docstring): x joined [N, S·K] or shared [N, K], ``w`` [S, K, M], S seeds;
    returns [N, S·M] float32. A shared x is data (a seed batch's input
    layer): it takes ``need_dx=False``."""
    if not 0.0 < rate < 1.0:
        raise ValueError(f"dropout_matmul needs a rate in (0, 1), got {rate}")
    if need_dx and _lane_operands(x, w, seed)[3]:
        raise ValueError("dropout_matmul lanes: a shared x (every lane's input) has no dX; "
                         "pass need_dx=False")
    return _DropoutMatmulLanes.apply(x, w, seed, rate, need_dx)
