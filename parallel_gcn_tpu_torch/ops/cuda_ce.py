"""Fused masked softmax cross-entropy: CUDA kernel and plain version.

Port of ``parallel_gcn_tpu/ops/pallas_ce.py`` (K9 ``_ce_kernel_eval`` and
``_ce_kernel_train``, behind ``masked_softmax_xent_fused``); the kernel is
``csrc/fused_ce.cu``. One pass over the logits gives the masked mean loss,
the accuracy and, when training, the gradient ``(softmax − onehot)·mask/num``
written beside them; the backward is that saved gradient times the loss's
cotangent.

Accuracy is the TPU kernel's truth-equals-row-max test: an exact tie
between the true class and another counts as correct. ``ops/loss.py`` (the
default ``ce_impl``) takes the first argmax and does not; the two differ on
exact ties only.

``masked_softmax_xent_fused`` runs the kernel for a CUDA tensor and
``masked_softmax_xent_fused_plain`` for a CPU one. Under ``torch.no_grad()``
(or for logits that need no gradient) it runs the eval variant, which
writes no gradient. ``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from parallel_gcn_tpu_torch.ops import _build

_ROWS_PER_BLOCK = 128  # kRowsPerBlock in csrc/fused_ce.cu
_LABEL_CODE = {torch.int32: 0, torch.int64: 1}

# kernel launches by variant: "ce_eval", "ce_train"
launches = {"ce_eval": 0, "ce_train": 0}


def masked_softmax_xent_fused_plain(
    logits: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor,
    num_samples: int, write_grad: bool = False,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor | None]:
    """Plain PyTorch version of the kernel: (mean loss, accuracy, gradient
    of the mean loss or None), the same f32 steps as pallas_ce.py:41-84."""
    logits = logits.detach().float()
    c = logits.shape[-1]
    lmax = logits.amax(dim=-1, keepdim=True)
    shifted = logits - lmax
    ex = torch.exp(shifted)
    sumexp = ex.sum(dim=-1, keepdim=True)
    lse = torch.log(sumexp)
    safe = labels.long().clamp(0, c - 1)[:, None]
    truth = shifted.gather(1, safe)
    maskf = mask.float()[:, None]
    # a device tensor: PyTorch divides a CUDA tensor by a host scalar as a
    # product with its rounded reciprocal; the kernel and JAX divide
    denom = torch.tensor(float(num_samples), device=logits.device)
    loss = (maskf * (lse - truth)).sum() / denom
    acc = (maskf * (truth >= 0).float()).sum() / denom
    grad = None
    if write_grad:
        onehot = torch.zeros_like(logits).scatter_(1, safe, 1.0)
        grad = (ex / sumexp - onehot) * (maskf * (1.0 / float(num_samples)))
    return loss, acc, grad


def _run(logits, labels, mask, num_samples: int, write_grad: bool):
    if logits.device.type == "cpu":
        return masked_softmax_xent_fused_plain(logits, labels, mask, num_samples,
                                               write_grad)
    if logits.device.type != "cuda":
        raise ValueError(f"masked_softmax_xent_fused: unsupported device {logits.device}")
    if logits.dtype != torch.float32 or logits.dim() != 2:
        raise TypeError(f"CE kernel takes [N, C] float32 logits, got "
                        f"{tuple(logits.shape)} {logits.dtype}")
    n, c = logits.shape
    if labels.dtype not in _LABEL_CODE or mask.dtype != torch.bool:
        raise TypeError(f"CE kernel takes int32/int64 labels and a bool mask, got "
                        f"{labels.dtype} and {mask.dtype}")
    if labels.shape != (n,) or mask.shape != (n,):
        raise ValueError(f"labels and mask must be [{n}], got {tuple(labels.shape)} "
                         f"and {tuple(mask.shape)}")
    for t in (logits, labels, mask):
        if t.device != logits.device or not t.is_contiguous():
            raise ValueError("logits, labels and mask must be contiguous, on one device")
    if n == 0 or c == 0:
        raise ValueError(f"CE kernel needs nonempty logits, got {tuple(logits.shape)}")
    n_parts = (n + _ROWS_PER_BLOCK - 1) // _ROWS_PER_BLOCK
    dev = logits.device
    partials = torch.empty((n_parts, 2), dtype=torch.float32, device=dev)
    loss = torch.empty((), dtype=torch.float32, device=dev)
    acc = torch.empty((), dtype=torch.float32, device=dev)
    grad = torch.empty_like(logits) if write_grad else None
    lib = _build.load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.pgcn_masked_ce(
            logits.data_ptr(), labels.data_ptr(), _LABEL_CODE[labels.dtype],
            mask.data_ptr(), n, c, 1.0 / float(num_samples), float(num_samples),
            partials.data_ptr(), n_parts, grad.data_ptr() if write_grad else None,
            loss.data_ptr(), acc.data_ptr(), ctypes.c_void_p(stream),
        )
    _build.check(rc, "CE kernel")
    launches["ce_train" if write_grad else "ce_eval"] += 1
    return loss, acc, grad


class _FusedCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, labels, mask, num_samples):
        loss, acc, grad = _run(logits, labels, mask, num_samples, write_grad=True)
        ctx.save_for_backward(grad)
        ctx.mark_non_differentiable(acc)
        return loss, acc

    @staticmethod
    def backward(ctx, g_loss, g_acc):
        (grad,) = ctx.saved_tensors
        return grad * g_loss, None, None, None


def masked_softmax_xent_fused(logits: torch.Tensor, labels: torch.Tensor,
                              mask: torch.Tensor, num_samples: int):
    """(mean CE loss, accuracy) over the rows where ``mask`` is set, as
    ``ops.loss.masked_softmax_xent`` but with the tie rule above;
    ``num_samples`` is the split's size. Differentiable in ``logits``; rows
    outside the mask (label −1 on padding) contribute nothing."""
    if torch.is_grad_enabled() and logits.requires_grad:
        return _FusedCE.apply(logits, labels, mask, num_samples)
    loss, acc, _ = _run(logits, labels, mask, num_samples, write_grad=False)
    return loss, acc
