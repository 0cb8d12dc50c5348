"""Accuracy statistics over seeds — the JAX package's ``harness/accuracy.py``
over the port (the reference's tuning_accuracy methodology,
test/tuning_accuracy.cpp:156-185): each dataset trains N seeds and the
harness reports the mean, max and sd of the final validation accuracy and
the test accuracy.

All N seeds train at once as one seed batch (``seeds.fit_seeds``), lane s
being ``fit`` with ``seed=s``; the row also gives the wall time of one lane
alone, so the batch's cost stands beside a single run's.

Usage:
    python -m parallel_gcn_tpu_torch.harness.accuracy [dataset ...] [--seeds N]
        [--epochs N] [--set key=value ...] [--tag T] [--device cuda|cpu] [--out-dir D]

Writes ``<out-dir>/accuracy_h100[_<tag>].txt`` and prints each row against the
published numbers (BASELINE.md).
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from parallel_gcn_tpu_torch.data.parser import prepare_device_dataset
from parallel_gcn_tpu_torch.device import resolve_device
from parallel_gcn_tpu_torch.harness import common
from parallel_gcn_tpu_torch.seeds import fit_seeds

# published val-accuracy mean±sd with tuned params (report p.13 Table 4)
PUBLISHED_VAL = {"citeseer": (81.46, 0.495), "cora": (88.42, 0.297), "pubmed": (90.01, 0.314)}
PUBLISHED_TEST = {"citeseer": 80.0, "cora": 87.9, "pubmed": 89.6, "reddit": 26.4}


def run_seeds(dataset: str, n_seeds: int, epochs: int | None, base_seed: int = 0,
              overrides: dict | None = None, device: str = "cuda") -> dict:
    """Seeds ``base_seed .. base_seed + n_seeds − 1`` of ``dataset`` in one
    batch, then the first of them alone: the statistics over the lanes and
    both wall times."""
    dev = resolve_device(device)
    cfg = common.config(dataset, overrides)
    if epochs:
        cfg.gcn.epochs = epochs
    cfg.train.verbose = False
    cfg.tpu.matmul_precision = "default"
    _, dds = prepare_device_dataset(cfg, dataset, dev)
    seeds = list(range(base_seed, base_seed + n_seeds))
    t0 = time.perf_counter()
    r = fit_seeds(cfg, dds, seeds)
    elapsed = time.perf_counter() - t0
    t0 = time.perf_counter()
    one = fit_seeds(cfg, dds, seeds[:1])
    one_s = time.perf_counter() - t0
    val, test = np.asarray(r.val_acc), np.asarray(r.test_acc)
    return {
        "dataset": dataset,
        "n_seeds": n_seeds,
        "val_mean": float(val.mean() * 100),
        "val_max": float(val.max() * 100),
        "val_sd": float(val.std(ddof=1) * 100) if n_seeds > 1 else 0.0,
        "test_mean": float(test.mean() * 100),
        "test_max": float(test.max() * 100),
        "epochs_mean": float(np.mean(r.epochs_run)),
        "elapsed_s": elapsed,
        "epoch_ms": r.avg_epoch_time_s * 1e3,
        "one_lane_s": one_s,
        "one_lane_epoch_ms": one.avg_epoch_time_s * 1e3,
        "lane0_equal_alone": bool(np.array_equal(r.history[0], one.history[0])),
        **common.stamp(dev),
    }


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("datasets", nargs="*", default=None)
    ap.add_argument("--seeds", type=int, default=20)
    ap.add_argument("--epochs", type=int, default=None)
    ap.add_argument("--set", nargs="*", default=[], metavar="KEY=VALUE",
                    help="config overrides applied to every dataset")
    ap.add_argument("--tag", default="", help="suffix for the output file name")
    common.add_common(ap)
    args = ap.parse_args(argv)
    over = common.overrides(args.set)
    # accuracy statistics mean most on real data: cora and citeseer
    datasets = args.datasets or ["cora", "citeseer"]
    rows = []
    for name in datasets:
        try:
            r = run_seeds(name, args.seeds, args.epochs, overrides=over, device=args.device)
        except FileNotFoundError:
            common.unavailable(name)
            continue
        line = (
            f"{name:10s} val {r['val_mean']:.2f}±{r['val_sd']:.3f} (max {r['val_max']:.2f}) "
            f"test {r['test_mean']:.2f} (max {r['test_max']:.2f}) "
            f"epochs~{r['epochs_mean']:.0f} [{r['n_seeds']} seeds, {r['elapsed_s']:.1f}s, "
            f"{r['epoch_ms']:.3f} ms/epoch; one lane {r['one_lane_s']:.1f}s, "
            f"{r['one_lane_epoch_ms']:.3f} ms/epoch] on {r['card']}"
        )
        pub_v, pub_t = PUBLISHED_VAL.get(name), PUBLISHED_TEST.get(name)
        if pub_v:
            line += f"  | published val {pub_v[0]}±{pub_v[1]}"
        if pub_t:
            line += f", test {pub_t}"
        print(line)
        rows.append(line)
    common.write(args.out_dir, f"accuracy_h100{('_' + args.tag) if args.tag else ''}.txt", rows)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
