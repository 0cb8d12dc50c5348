"""Hyperparameter sweep — the JAX package's ``harness/tuning.py`` over the port
(the reference's tuning_accuracy sweep, test/tuning_accuracy.cpp): a grid
over layers × hidden width × dropout × weight decay, each configuration
scored as the mean val accuracy over N seeds trained as one seed batch
(``seeds.fit_seeds``, which trains the parameters file's model of any
family).

The reference's coarse grid (:56-60) and refined -DSECOND grid (:63-83) are
the presets, as the JAX package trims them. Each configuration computes its
own Â·X (one aggregation; the JAX sweep shares it across configurations).

Usage:
    python -m parallel_gcn_tpu_torch.harness.tuning <dataset> [--preset coarse|fine]
        [--seeds N] [--epochs N] [--device cuda|cpu] [--out-dir D]

Writes ``<out-dir>/tuning_<dataset>_h100.txt``, best first.
"""

from __future__ import annotations

import argparse
import itertools

import numpy as np

from parallel_gcn_tpu_torch.data.parser import prepare_device_dataset
from parallel_gcn_tpu_torch.device import resolve_device
from parallel_gcn_tpu_torch.harness import common
from parallel_gcn_tpu_torch.seeds import fit_seeds

# reference grids (test/tuning_accuracy.cpp:56-83), trimmed as the JAX package's
PRESETS = {
    "coarse": {
        "n_layers": [2, 3],
        "hidden": [8, 16, 32, 64],
        "dropout": [0.2, 0.5],
        "wd": [5e-3, 5e-4, 5e-5],
    },
    "fine": {
        "n_layers": [2],
        "hidden": [16, 32, 48, 72, 96],
        "dropout": [0.0, 0.2, 0.4, 0.6],
        "wd": [5e-4, 1e-4, 5e-5],
    },
}


def sweep(dataset: str, preset: str, seeds: int, epochs: int, device: str = "cuda"):
    dev = resolve_device(device)
    base = common.config(dataset)
    base.tpu.matmul_precision = "default"
    _, dds = prepare_device_dataset(base, dataset, dev)
    grid = PRESETS[preset]
    results = []
    for n_layers, hidden, dropout, wd in itertools.product(
            grid["n_layers"], grid["hidden"], grid["dropout"], grid["wd"]):
        cfg = common.config(dataset, dict(n_layers=n_layers, hidden_dims=(hidden,) * (n_layers - 1),
                                          dropouts=(dropout,) * n_layers, epochs=epochs,
                                          weight_decay=wd, matmul_precision="default",
                                          verbose=False))
        val = np.asarray(fit_seeds(cfg, dds, range(seeds)).val_acc)
        row = {"n_layers": n_layers, "hidden": hidden, "dropout": dropout, "wd": wd,
               "val_mean": float(val.mean() * 100), "val_max": float(val.max() * 100),
               "val_sd": float(val.std(ddof=1) * 100) if seeds > 1 else 0.0}
        print(f"L={n_layers} H={hidden:3d} D={dropout} wd={wd:g}: "
              f"val {row['val_mean']:.2f}±{row['val_sd']:.3f} (max {row['val_max']:.2f})",
              flush=True)
        results.append(row)
    results.sort(key=lambda r: -r["val_mean"])
    return results, common.card(dev)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("dataset")
    ap.add_argument("--preset", choices=list(PRESETS), default="coarse")
    ap.add_argument("--seeds", type=int, default=5)
    ap.add_argument("--epochs", type=int, default=400)
    common.add_common(ap)
    args = ap.parse_args(argv)
    try:
        results, card = sweep(args.dataset, args.preset, args.seeds, args.epochs, args.device)
    except FileNotFoundError:
        common.unavailable(args.dataset)
        return 0
    common.write(args.out_dir, f"tuning_{args.dataset}_h100.txt", [
        f"{r['val_mean']:.3f} {r['val_sd']:.3f} {r['val_max']:.3f} L={r['n_layers']} "
        f"H={r['hidden']} D={r['dropout']} wd={r['wd']:g} [{args.seeds} seeds on {card}]"
        for r in results])
    best = results[0]
    print(f"\nbest: L={best['n_layers']} H={best['hidden']} D={best['dropout']} "
          f"wd={best['wd']:g} → val {best['val_mean']:.2f}±{best['val_sd']:.3f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
