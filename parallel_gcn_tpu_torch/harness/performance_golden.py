"""Sequential golden-model timing — the JAX package's
``harness/performance_golden.py`` over the port (the analog of the
reference's performance_cpu harness, test/performance_cpu.cpp: the
single-threaded CPU baseline, the denominator of the published speedups).

Times the numpy golden model (``parallel_gcn_tpu_torch.golden``) for one
full training epoch (forward, hand-written backward, Adam, with the
dataset's dropouts and residual) on the host, then the port's epoch on the
device (``harness.performance.bench``), and reports the port's speedup over
the golden epoch beside the reference's published CPU baseline. The golden
model is the correctness oracle, not an optimized CPU implementation.

Usage:
    python -m parallel_gcn_tpu_torch.harness.performance_golden [dataset ...]
        [--epochs N] [--port-epochs N] [--device cuda|cpu] [--out-dir D]

Writes ``<out-dir>/performance_golden_h100.txt``.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from parallel_gcn_tpu_torch.data.parser import load_dataset
from parallel_gcn_tpu_torch.golden import (GoldenAdamState, glorot_range, golden_adam_step,
                                           golden_grads)
from parallel_gcn_tpu_torch.harness import common
from parallel_gcn_tpu_torch.harness.performance import bench

REFERENCE_CPU_MS = {
    "cora": 5.002, "citeseer": 7.291, "pubmed": 49.827, "reddit": 9826.111,
    "synth-pubmed": 49.827, "synth-reddit": 9826.111,
}


def bench_golden(dataset: str, epochs: int) -> dict:
    """The golden model's mean epoch ms over ``epochs`` after one warm-up."""
    cfg = common.config(dataset)
    ds = load_dataset(dataset, binarize_features=cfg.data.binarize_features)
    rng = np.random.default_rng(0)
    dims = [ds.input_dim, *cfg.gcn.hidden_dims, ds.output_dim]
    weights = [rng.uniform(-glorot_range(a, b), glorot_range(a, b), (a, b)).astype(np.float32)
               for a, b in zip(dims[:-1], dims[1:])]
    state = GoldenAdamState(m=[np.zeros_like(w) for w in weights],
                            v=[np.zeros_like(w) for w in weights])
    mask = ds.split == 1
    decay_flags = [True] + [False] * (len(weights) - 1)
    a = cfg.adam
    # the dropout multiplies and residual adds the dataset's config trains
    # with (the sequential reference applies dropout per layer too)
    dropouts = list(cfg.gcn.dropouts)
    keep_probs = [1.0 - d for d in dropouts]

    def epoch():
        nonlocal weights
        masks = [(rng.random((ds.n_nodes, dims[i])) < keep_probs[i]).astype(np.float32)
                 if dropouts[i] > 0 else None for i in range(len(weights))]
        grads, _ = golden_grads(weights, ds.features, ds.graph, ds.labels, mask,
                                dropout_masks=masks, keep_probs=keep_probs,
                                residual=cfg.gcn.residual)
        weights = golden_adam_step(weights, grads, state, a.learning_rate, a.weight_decay,
                                   a.beta1, a.beta2, a.eps, decay_flags)

    epoch()  # warm numpy's caches
    times = []
    for _ in range(epochs):
        t0 = time.perf_counter()
        epoch()
        times.append(time.perf_counter() - t0)
    return {"dataset": dataset, "golden_epoch_ms": float(np.mean(times) * 1e3)}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("datasets", nargs="*", default=None)
    ap.add_argument("--epochs", type=int, default=20, help="golden epochs timed")
    ap.add_argument("--port-epochs", type=int, default=200,
                    help="epochs of each of the port's 3 timed runs")
    common.add_common(ap)
    args = ap.parse_args(argv)
    lines = []
    for name in args.datasets or ["cora", "citeseer", "synth-pubmed"]:
        try:
            r = bench_golden(name, args.epochs)
            port = bench(name, args.port_epochs, 3, args.device)
        except FileNotFoundError:
            common.unavailable(name)
            continue
        ref = REFERENCE_CPU_MS.get(name)
        line = (f"{name:14s} golden-oracle epoch {r['golden_epoch_ms']:.2f} ms (numpy, host); "
                f"port {port['epoch_ms_min']:.4f} ms on {port['card']}: "
                f"{r['golden_epoch_ms'] / port['epoch_ms_min']:.1f}x")
        if ref:
            line += f" (the reference's optimized CPU baseline: {ref} ms)"
        print(line)
        lines.append(line)
    common.write(args.out_dir, "performance_golden_h100.txt", lines)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
