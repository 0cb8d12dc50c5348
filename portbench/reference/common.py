"""What every model family's plain reference shares: the graph and data in
the program's node order, the masked softmax cross-entropy, Adam with L2 on
leaf 0, the dropout of the program's mask, the precision of the products,
and the loop that follows the first epochs of a training run.

The reference semantics are the reference trainer's (the GCN trainer of
Kipf & Welling as the repo's ``parameters/`` files configure it): each epoch
runs the training forward with that epoch's dropout masks, the masked mean
CE over the training nodes plus wd·Σw₀²/2 of the pre-update leaf 0, the
gradient of the CE alone, Adam with the decay folded into leaf 0's
gradient, then the validation forward (no dropout) on the updated weights.
"""

from __future__ import annotations

import importlib

import numpy as np
import torch

from portbench.reference.philox import epoch_seeds, keep_mask

TRAIN, VAL, TEST = 1, 2, 3


def plain_precision() -> None:
    """float32 products in full float32: no TF32 anywhere."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


class RefData:
    """The dataset in the program's node order (``order[i]`` is the
    generated node placed at position i), on ``device``, float32: Â =
    D^-1/2 (A+I) D^-1/2 as a CSR tensor, the dense features, labels, split
    and sqrt(deg)."""

    def __init__(self, arrays: dict, device):
        order = arrays["order"].astype(np.int64)
        indptr = arrays["indptr"].astype(np.int64)
        n = len(indptr) - 1
        deg = np.diff(indptr)
        inv = np.empty(n, dtype=np.int64)
        inv[order] = np.arange(n)
        rows_old = np.repeat(np.arange(n), deg)
        cols_old = arrays["indices"].astype(np.int64)
        vals = (1.0 / np.sqrt(deg[rows_old].astype(np.float64)
                              * deg[cols_old].astype(np.float64))).astype(np.float32)
        dev = torch.device(device)
        idx = torch.from_numpy(np.stack([inv[rows_old], inv[cols_old]])).to(dev)
        with torch.sparse.check_sparse_tensor_invariants(False):
            self.adj = torch.sparse_coo_tensor(idx, torch.from_numpy(vals).to(dev), (n, n)) \
                .coalesce().to_sparse_csr()
        fc, fv = arrays["feat_cols"], arrays["feat_vals"]
        x = torch.zeros(n, int(fc.max()) + 1, device=dev)  # the loader's width: max index + 1
        r = torch.from_numpy(np.repeat(inv, fc.shape[1])).to(dev)
        x[r, torch.from_numpy(fc.reshape(-1).astype(np.int64)).to(dev)] = \
            torch.from_numpy(fv.reshape(-1)).to(dev)
        self.x = x
        self.labels = torch.from_numpy(arrays["labels"][order].astype(np.int64)).to(dev)
        self.split = torch.from_numpy(arrays["split"][order]).to(dev)
        self.sqrt_deg = torch.from_numpy(np.sqrt(deg[order].astype(np.float64))
                                         .astype(np.float32)).to(dev)[:, None]
        self.n = n
        self.nnz = len(cols_old)
        self.n_classes = int(arrays["labels"].max()) + 1
        self._ax = None

    def aggregate(self, h: torch.Tensor) -> torch.Tensor:
        """Â·h."""
        return torch.sparse.mm(self.adj, h)

    @property
    def ax(self) -> torch.Tensor:
        """Â·X, computed once."""
        if self._ax is None:
            self._ax = self.aggregate(self.x)
        return self._ax


class Precision:
    """The rounding of the reference's arithmetic: none in ``float32``; in
    ``fp8`` (the control: the precision below the configurations' bfloat16)
    each operand of a product scaled by its largest magnitude onto float8
    e4m3 and back, the gradient passed straight through, and the constants
    the program rounds to its compute dtype (the dropout's 1/keep) rounded
    to e4m3."""

    def __init__(self, name: str):
        if name not in ("float32", "fp8"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name

    def __call__(self, t: torch.Tensor) -> torch.Tensor:
        if self.name == "float32":
            return t
        scale = t.detach().abs().amax().clamp(min=1e-30) / 448.0
        r = (t.detach() / scale).to(torch.float8_e4m3fn).float() * scale
        return t + (r - t).detach()

    def scalar(self, v: float) -> float:
        if self.name == "float32":
            return v
        return float(torch.tensor(v).to(torch.float8_e4m3fn).float())


def dropout(h: torch.Tensor, seed: int, rate: float, q: Precision) -> torch.Tensor:
    """Inverted dropout with the program's mask."""
    keep = keep_mask(seed, rate, h.shape[0], h.shape[1], h.device)
    return torch.where(keep, h * q.scalar(1.0 / (1.0 - rate)),
                       torch.zeros((), device=h.device))


def masked_ce(logits: torch.Tensor, data: RefData, split: int, half: bool = False):
    """(mean CE, accuracy) over the nodes of ``split``; ``half`` (a fault:
    half of the batch left out) keeps every other one of them and takes the
    mean over the rest."""
    mask = data.split == split
    if half:
        idx = torch.nonzero(mask)[:, 0]
        mask = torch.zeros_like(mask)
        mask[idx[::2]] = True
    n = mask.sum()
    lse = torch.logsumexp(logits, dim=1)
    truth = logits.gather(1, data.labels[:, None])[:, 0]
    ce = ((lse - truth) * mask).sum() / n
    acc = ((logits.argmax(dim=1) == data.labels) & mask).sum() / n
    return ce, acc


def family(name: str):
    """The plain model of family ``name`` (``portbench/reference/<name>.py``)."""
    return importlib.import_module(f"portbench.reference.{name}")


def follow(fam_name: str, data: RefData, params: dict, weights: list[torch.Tensor],
           run_seed: int, epochs: int = 3, precision: str = "float32",
           fault: str | None = None) -> np.ndarray:
    """The first ``epochs`` epochs of a run from ``weights`` (float32, the
    family's leaves in order) with the dropout seeds of ``run_seed``:
    [epochs, 4] float64 rows of (train loss, train accuracy, val loss, val
    accuracy), the val pair on the weights after the epoch's update.
    ``fault``: ``half`` (half of the batch in the loss) or ``frozen`` (the
    update left out)."""
    plain_precision()
    fam = family(fam_name)
    q = Precision(precision)
    w = [t.detach().clone().float().requires_grad_(True) for t in weights]
    m = [torch.zeros_like(t) for t in w]
    v = [torch.zeros_like(t) for t in w]
    lr, wd = float(params["learning_rate"]), float(params["weight_decay"])
    b1, b2, eps = float(params["beta1"]), float(params["beta2"]), float(params["eps"])
    seeds = epoch_seeds(run_seed, epochs, fam.n_layers(params))
    rows = []
    for e in range(epochs):
        logits = fam.forward(data, w, params, training=True, seeds=seeds[e], q=q)
        ce, acc = masked_ce(logits, data, TRAIN, half=fault == "half")
        with torch.no_grad():
            tl = ce + wd * (w[0] * w[0]).sum() / 2
        grads = torch.autograd.grad(ce, w)
        if fault != "frozen":
            with torch.no_grad():
                t = e + 1
                step = lr * (1 - b2 ** t) ** 0.5 / (1 - b1 ** t)
                for i, (p, g) in enumerate(zip(w, grads)):
                    if i == 0:
                        g = g + wd * p
                    m[i].mul_(b1).add_((1 - b1) * g)
                    v[i].mul_(b2).add_((1 - b2) * g * g)
                    p.sub_(step * m[i] / (v[i].sqrt() + eps))
        with torch.no_grad():
            vlog = fam.forward(data, w, params, training=False, seeds=None, q=q)
            vce, vacc = masked_ce(vlog, data, VAL)
            vl = vce + wd * (w[0] * w[0]).sum() / 2
        rows.append([float(tl), float(acc), float(vl), float(vacc)])
    return np.asarray(rows, dtype=np.float64)
