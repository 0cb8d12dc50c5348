"""Dense against sparse input-layer chain — the JAX package's
``harness/feature_impl_bench.py`` over the port: one training step of the
input layer, ``Y = dropout(X)·W`` and ``dW = dropout(X)ᵀ·g``, with the
features dense or as their nonzeros, at the reference's citation widths.

  dense chain:  X' = K1(X) (``ops.cuda_dropout.dropout``); Y = X'·W (cuBLAS);
                dW by autograd (cuBLAS on X'ᵀ)
  fused chain:  K10 (``ops.cuda_fused.dropout_matmul``): the mask drawn inside
                the product, forward and dW
  sparse chain: v' = v·keep/(1 − p) over the nonzeros only (the mask of K1's
                Philox stream at the nonzeros' flat indices); Y = the
                ordered gather-sum of W's rows (kernel (a),
                ``ops.sparse_matmul.sparse_feature_transform``'s product with
                the index built once); dW by its adjoint, the ordered sum by
                feature

with ablations that time each indexed stage of the sparse chain alone:
the mask, the gather (Σ v·W[c] as one reduction), the forward gather-sum,
the dW sum. The dense chain masks every cell with K1's mask, the sparse
chain only the nonzeros, with K1's mask drawn at their flat indices (a
dropped zero is a zero): the two chains compute the same Y and dW at every
rate, within the rounding of their orders of summation (f32).

cora and citeseer are read from ``PGCN_DATA_DIR`` where present; otherwise
the run takes generated graphs at their sizes (nodes, features, classes,
nonzeros a row), and the output file says so.

Usage:
    python -m parallel_gcn_tpu_torch.harness.feature_impl_bench [cora citeseer]
        [--steps K] [--reps R] [--device cuda|cpu] [--out-dir D]

Writes ``<out-dir>/feature_impl_<dataset>_h100.txt``.
"""

from __future__ import annotations

import argparse
import dataclasses

import torch

from parallel_gcn_tpu_torch.device import resolve_device
from parallel_gcn_tpu_torch.harness import common

# dataset: (hidden, input dropout, compute dtype, binarize) — the JAX harness's
CONFIGS = {
    "cora": (72, 0.4, "float32", True),
    "citeseer": (16, 0.6, "bfloat16", False),
}
# generated stand-ins at the datasets' sizes (report p.10 Table 2; feature
# nonzeros a row as in the real files: cora 49,216 / 2,708, citeseer
# 105,165 / 3,327)
SIZES = {
    "cora": dict(n_nodes=2708, n_edges=10_858, input_dim=1433, n_classes=7, n_train=140,
                 n_val=500, feature_nnz_per_row=18, n_communities=7),
    "citeseer": dict(n_nodes=3327, n_edges=9_464, input_dim=3703, n_classes=6, n_train=120,
                     n_val=500, feature_nnz_per_row=32, n_communities=6),
}


def dataset(name: str):
    """(host dataset, whether it is generated at the dataset's size)."""
    from parallel_gcn_tpu_torch.data.parser import load_dataset
    from parallel_gcn_tpu_torch.data.synthetic import make_synthetic_dataset

    binarize = CONFIGS[name][3]
    try:
        return load_dataset(name, binarize_features=binarize), False
    except FileNotFoundError:
        ds = make_synthetic_dataset(f"{name}-sized", **SIZES[name])
        if binarize:
            fc = dataclasses.replace(ds.feature_csr, values=ds.feature_csr.values * 0 + 1)
            ds = dataclasses.replace(ds, feature_csr=fc, features=fc.to_dense())
        return ds, True


class Chains:
    """The chains' operands on ``device`` and one step of each."""

    def __init__(self, ds, hidden: int, p: float, dtype: torch.dtype, device, seed: int = 7):
        from parallel_gcn_tpu_torch.ops.cuda_segment import segments

        gen = torch.Generator().manual_seed(0)
        fc = ds.feature_csr
        self.n, self.f, self.p, self.dtype, self.seed = fc.n_rows, fc.n_cols, p, dtype, seed
        self.w = (torch.randn((self.f, hidden), generator=gen) * 0.05).to(device)
        self.g = torch.randn((self.n, hidden), generator=gen).to(device)
        self.x = torch.from_numpy(fc.to_dense()).to(dtype).to(device)
        rows = torch.from_numpy(fc.row_ids()).long().to(device)
        self.cols = torch.from_numpy(fc.indices).long().to(device)
        self.vals = torch.from_numpy(fc.values).float().to(device)
        # the nonzeros' flat indices in the dense matrix: K1's mask there
        self.flat = rows * self.f + self.cols
        self.seg = segments(rows, self.n, self.cols, self.vals)
        self.seg_t = segments(self.cols, self.f, rows, self.vals)
        self.nnz = int(self.vals.numel())

    def masked_vals(self) -> torch.Tensor:
        """The nonzeros under K1's mask (Philox words at their flat indices
        only) and its scale."""
        from parallel_gcn_tpu_torch.ops import cuda_dropout as cd

        if self.p == 0.0:
            return self.vals
        ctr, zero = self.flat >> 2, torch.zeros_like(self.flat)
        words = torch.stack(cd.philox4x32_10(ctr & 0xFFFFFFFF, ctr >> 32, zero, zero,
                                             *cd._seed_halves(self.seed, ctr.device)), 1)
        keep = words.gather(1, (self.flat & 3)[:, None])[:, 0] < cd.keep_threshold(self.p)
        scale = cd._inv_keep(self.p, torch.float32)
        return torch.where(keep, self.vals * scale, torch.zeros_like(self.vals))

    def _sparse_y(self, v: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        from parallel_gcn_tpu_torch.ops.cuda_segment import _pack_items, gather_sum_t

        seg = dataclasses.replace(self.seg, val=v, items=_pack_items(self.seg, self.seg.src, v))
        seg_t = dataclasses.replace(self.seg_t, val=v,
                                    items=_pack_items(self.seg_t, self.seg_t.src, v))
        return gather_sum_t(w, seg, seg_t)

    def dense(self):
        """(Y, dW) of the dense chain: K1, then cuBLAS."""
        from parallel_gcn_tpu_torch.ops.cuda_dropout import dropout
        from parallel_gcn_tpu_torch.ops.sparse_matmul import feature_transform

        w = self.w.clone().requires_grad_(True)
        xp = dropout(self.x, self.seed, self.p) if self.p else self.x
        y = feature_transform(xp, w)
        (dw,) = torch.autograd.grad((y * self.g).sum(), w)
        return y.detach(), dw

    def fused(self):
        """(Y, dW) of K10's chain (a rate in (0, 1))."""
        from parallel_gcn_tpu_torch.ops.cuda_fused import dropout_matmul

        w = self.w.clone().requires_grad_(True)
        y = dropout_matmul(self.x, w.to(self.x.dtype), self.seed, self.p)
        (dw,) = torch.autograd.grad((y.float() * self.g).sum(), w)
        return y.detach(), dw

    def sparse(self):
        """(Y, dW) of the sparse chain: the nonzeros' mask, kernel (a) and
        its adjoint."""
        w = self.w.clone().requires_grad_(True)
        y = self._sparse_y(self.masked_vals(), w)
        (dw,) = torch.autograd.grad((y * self.g).sum(), w)
        return y.detach(), dw

    # ablations: each indexed stage of the sparse chain alone
    def abl_mask(self):
        return self.masked_vals()

    def abl_gather(self):
        return (self.vals[:, None] * self.w[self.cols]).sum()

    def abl_fwd(self):
        from parallel_gcn_tpu_torch.ops.cuda_segment import gather_sum

        return gather_sum(self.w, self.seg)

    def abl_dw(self):
        from parallel_gcn_tpu_torch.ops.cuda_segment import gather_sum

        return gather_sum(self.g, self.seg_t)


# each row's label and the ``Chains`` method it times
VARIANTS = {"dense-chain": "dense", "fused-chain": "fused", "sparse-chain": "sparse",
            "abl-mask": "abl_mask", "abl-gather": "abl_gather", "abl-fwd-segsum": "abl_fwd",
            "abl-dw-scatter": "abl_dw"}


def _ms(fn, steps: int, dev: torch.device) -> float:
    """Milliseconds a call: ``utils.timer.events_ms`` on the card, the host
    clock's mean over ``steps`` calls on the CPU."""
    import time

    from parallel_gcn_tpu_torch.utils.timer import events_ms

    if dev.type == "cuda":
        return events_ms(fn, steps)
    fn()
    t0 = time.perf_counter()
    for _ in range(steps):
        fn()
    return (time.perf_counter() - t0) * 1e3 / steps


def bench(name: str, steps: int, reps: int, device: str, out_dir: str) -> list[str]:
    """Every variant's best time a step over ``reps`` runs of ``steps``
    steps (CUDA events on the card, the host clock on the CPU); writes the
    dataset's file."""
    dev = resolve_device(device)
    ds, generated = dataset(name)
    hidden, p, cdtype, _ = CONFIGS[name]
    chains = Chains(ds, hidden, p, getattr(torch, cdtype), dev)
    lines = []
    for label, method in VARIANTS.items():
        fn = getattr(chains, method)
        best = min(_ms(fn, steps, dev) for _ in range(reps))
        lines.append(f"{name} {label} us_per_step={best * 1e3:.2f} nnz={chains.nnz} "
                     f"cells={chains.n * chains.f} H={hidden} p={p} dtype={cdtype}")
        print(lines[-1], flush=True)
    source = (f"a generated graph at {name}'s size ({name}'s files are absent)" if generated
              else f"{name}'s files")
    common.write(out_dir, f"feature_impl_{name}_h100.txt",
                 [f"# device={dev.type} card={common.card(dev)} steps={steps}; {source}"]
                 + lines)
    return lines


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("datasets", nargs="*", default=None)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--reps", type=int, default=5)
    common.add_common(ap)
    args = ap.parse_args(argv)
    for name in args.datasets or list(CONFIGS):
        bench(name, args.steps, args.reps, args.device, args.out_dir)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
