"""The mesh path on one card — the JAX package's ``harness/mesh_onechip.py``
over the port: the node-partitioned trainer (``fit_parallel``) in a world of
one rank, against the single-card ``fit`` of the same configuration. The
ratio is the sharding tax: what the mesh machinery (the rank's slab, its
halo, the collectives of a world of one) costs before a second card pays.

Routes: the GCN over hybrid tile slabs and the GAT over the
``gat_mesh_pack`` slabs, both with the boundary halo (at one rank it falls
back to all_gather with ``halo_fallback``), on cora and synth-reddit, as the
JAX package builds them (``build_route``). Both trainers run ``mode=scan``
with early stopping off; each time is the min over ``--reps`` runs of the
scan's epoch time, after one warm-up run.

Usage:
    python -m parallel_gcn_tpu_torch.harness.mesh_onechip [--epochs N]
        [--reddit-epochs N] [--reps N] [--routes r1,r2] [--device cuda|cpu] [--out-dir D]

Writes ``<out-dir>/mesh_onechip_h100.txt`` (one JSON row a route).
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from parallel_gcn_tpu_torch.data.parser import prepare_device_dataset, prepare_host_dataset
from parallel_gcn_tpu_torch.device import resolve_device
from parallel_gcn_tpu_torch.harness import common
from parallel_gcn_tpu_torch.parallel.train_parallel import fit_parallel
from parallel_gcn_tpu_torch.train import fit

ROUTES = {
    # route -> (dataset, overrides applied to the dataset's tuned config)
    "cora-gcn": ("cora", dict(backend="hybrid")),
    "cora-gat": ("cora", dict(backend="hybrid", model="gat", heads=2, hidden_dims=(8,),
                              dropouts=(0.1, 0.1))),
    "reddit-gcn": ("synth-reddit", dict()),
    "reddit-gat": ("synth-reddit", dict(model="gat", heads=2, hidden_dims=(32,),
                                        dropouts=(0.0, 0.1))),
}


def build_route(name: str, epochs: int):
    """(config, host dataset) of ``name``: the dataset's tuned config with the
    route's overrides, the boundary halo, ``mode=scan`` without early
    stopping, and the host dataset in the dataset's reordering, as the CLI
    feeds ``fit_parallel``."""
    dataset, over = ROUTES[name]
    cfg = common.config(dataset, dict(over, epochs=epochs, early_stopping=0, verbose=False,
                                      matmul_precision="default", mode="scan",
                                      halo="boundary"))
    if cfg.gcn.model == "gat":
        cfg.tpu.edge_chunk = 0  # the tile backend bounds memory at O(N·heads)
    return cfg, prepare_host_dataset(cfg, dataset)


def time_route(name: str, epochs: int, reps: int, device: str) -> dict:
    dev = resolve_device(device)
    cfg, ds = build_route(name, epochs)

    def mesh():
        res = fit_parallel(cfg, ds, n_devices=1, device=dev)
        if not np.isfinite(res.history).all():
            raise RuntimeError(f"{name}: non-finite metrics on the mesh")
        return res.avg_epoch_time_s * 1e3

    _, dds = prepare_device_dataset(cfg, ROUTES[name][0], dev, ds)

    def single():
        return fit(cfg, dds).avg_epoch_time_s * 1e3

    mesh(), single()  # warm: the kernels, the packs' cached indexes
    mesh_ms = [mesh() for _ in range(reps)]
    fit_ms = [single() for _ in range(reps)]
    return {"route": name, **common.stamp(dev), "n_devices": 1, "halo": "boundary",
            "epoch_ms_min": min(mesh_ms), "epoch_ms_median": float(np.median(mesh_ms)),
            "reps_ms": [round(t, 4) for t in mesh_ms], "fit_epoch_ms_min": min(fit_ms),
            "fit_reps_ms": [round(t, 4) for t in fit_ms], "tax": min(mesh_ms) / min(fit_ms)}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--epochs", type=int, default=200)
    ap.add_argument("--reddit-epochs", type=int, default=30)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--routes", default=",".join(ROUTES))
    common.add_common(ap)
    args = ap.parse_args(argv)
    rows = []
    for name in args.routes.split(","):
        epochs = args.reddit_epochs if "reddit" in ROUTES[name][0] else args.epochs
        try:
            row = time_route(name, epochs, args.reps, args.device)
        except FileNotFoundError:
            common.unavailable(ROUTES[name][0])
            continue
        print(f"{name:12s} mesh epoch {row['epoch_ms_min']:9.4f} ms (median "
              f"{row['epoch_ms_median']:.4f}), fit {row['fit_epoch_ms_min']:.4f} ms: tax "
              f"{row['tax']:.3f}x on {row['card']}", flush=True)
        rows.append(json.dumps(row))
    common.write(args.out_dir, "mesh_onechip_h100.txt", rows)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
