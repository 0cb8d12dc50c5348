"""Epoch time per dataset — the JAX package's ``harness/performance.py`` over
the port (the reference's performance_gpu methodology,
test/performance_gpu.cpp): fixed hyperparameters, several repetitions,
against the published baselines (BASELINE.md).

Each repetition is one ``train.fit`` in ``mode=scan`` with early stopping
off; its epoch time is the scan's: the host clock over epochs 2..N (on the
card the replays of the captured epoch), ended by one sync, per epoch. Each
row gives the min, median and sd over the repetitions, edges/s at the min,
the published T4 and CPU baselines (the reference's numbers, copied) and
the speedup over each, the backend, and the device with the card's name and
power limit.

Usage:
    python -m parallel_gcn_tpu_torch.harness.performance [dataset ...] [--epochs N]
        [--reps N] [--allow-downgrade] [--device cuda|cpu] [--out-dir D]

Writes ``<out-dir>/performance_h100.txt`` (one JSON row a dataset). A CPU run
refuses to overwrite a file measured on the card unless ``--allow-downgrade``
is given.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from parallel_gcn_tpu_torch.data.parser import prepare_device_dataset
from parallel_gcn_tpu_torch.device import resolve_device
from parallel_gcn_tpu_torch.harness import common
from parallel_gcn_tpu_torch.ops.graphsum import resolve_backend
from parallel_gcn_tpu_torch.train import fit

# the reference's published epoch times (ms), T4 GPU and CPU (BASELINE.md)
BASELINE_GPU_MS = {"cora": 0.277, "citeseer": 0.325, "pubmed": 1.418, "reddit": 231.518}
BASELINE_CPU_MS = {"cora": 5.002, "citeseer": 7.291, "pubmed": 49.827, "reddit": 9826.111}
# synth-reddit matches reddit's published size statistics; synth-pubmed runs
# the real pubmed graph with synthetic features: like for like in edges and
# FLOPs, not the same data
BASELINE_GPU_MS["synth-reddit"] = BASELINE_GPU_MS["reddit"]
BASELINE_CPU_MS["synth-reddit"] = BASELINE_CPU_MS["reddit"]
BASELINE_GPU_MS["synth-pubmed"] = BASELINE_GPU_MS["pubmed"]
BASELINE_CPU_MS["synth-pubmed"] = BASELINE_CPU_MS["pubmed"]

OUT = "performance_h100.txt"


def bench(dataset: str, epochs: int, reps: int, device: str = "cuda") -> dict:
    dev = resolve_device(device)
    cfg = common.config(dataset, dict(epochs=epochs, early_stopping=0, verbose=False,
                                      matmul_precision="default", mode="scan"))
    ds, dds = prepare_device_dataset(cfg, dataset, dev)
    fit(cfg, dds)  # warm: builds the kernels and the packs' cached indexes
    times = [fit(cfg, dds).avg_epoch_time_s * 1e3 for _ in range(reps)]
    best = min(times)
    return {
        "dataset": dataset,
        "backend": resolve_backend(dds.graph, cfg.tpu.backend, cfg.tpu.dense_threshold),
        **common.stamp(dev),
        "epochs": epochs,
        "epoch_ms_min": best,
        "epoch_ms_median": float(np.median(times)),
        "epoch_ms_sd": float(np.std(times)),
        "reps_ms": [round(t, 4) for t in times],
        "edges_per_s": ds.graph.nnz / (best / 1e3),
        "baseline_t4_ms": BASELINE_GPU_MS.get(dataset),
        "baseline_cpu_ms": BASELINE_CPU_MS.get(dataset),
        "vs_gpu_baseline": BASELINE_GPU_MS[dataset] / best if dataset in BASELINE_GPU_MS else None,
        "vs_cpu_baseline": BASELINE_CPU_MS[dataset] / best if dataset in BASELINE_CPU_MS else None,
    }


def card_measured(path: str) -> bool:
    """Whether the results file at ``path`` was measured on the card."""
    if not os.path.exists(path):
        return False
    with open(path) as f:
        head = f.readline()
    try:
        return json.loads(head).get("device") == "cuda"
    except json.JSONDecodeError:
        return False


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("datasets", nargs="*", default=None)
    ap.add_argument("--epochs", type=int, default=1000)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--allow-downgrade", action="store_true",
                    help="let a CPU run overwrite results measured on the card")
    common.add_common(ap)
    args = ap.parse_args(argv)
    path = os.path.join(args.out_dir, OUT)
    if resolve_device(args.device).type != "cuda" and card_measured(path) \
            and not args.allow_downgrade:
        print(f"refusing to overwrite the card-measured {path} with {args.device} numbers — "
              "pass --allow-downgrade to force")
        return 2
    datasets = args.datasets or ["cora", "citeseer", "pubmed", "reddit", "synth-pubmed",
                                 "synth-reddit"]
    rows = []
    for name in datasets:
        try:
            r = bench(name, args.epochs, args.reps, args.device)
        except FileNotFoundError:
            common.unavailable(name)
            continue
        print(f"{name:12s} backend={r['backend']:8s} epoch {r['epoch_ms_min']:.4f} ms (median "
              f"{r['epoch_ms_median']:.4f}±{r['epoch_ms_sd']:.4f}) "
              f"{r['edges_per_s'] / 1e6:.1f} Medge/s "
              + (f"| {r['vs_gpu_baseline']:.2f}x T4, {r['vs_cpu_baseline']:.0f}x CPU baseline"
                 if r["vs_gpu_baseline"] is not None else "| (no published baseline)")
              + f" on {r['card']}")
        rows.append(json.dumps(r))
    common.write(args.out_dir, OUT, rows)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
