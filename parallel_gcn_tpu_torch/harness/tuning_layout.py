"""Execution-layout sweep — the JAX package's ``harness/tuning_layout.py``
over the port (the analog of the reference's tuning_cuda sweep,
test/tuning_cuda.cpp).

The knobs are the aggregation backend, the node reordering, the tile shape
and dtype, ``min_tile_nnz`` (the tile/residual break-even) and the dense
backend's Â dtype. Each layout is timed as ``harness.performance`` times an
epoch (``train.fit`` in ``mode=scan``; the min over ``--reps``), and the file
lists them fastest first: the numbers behind a parameter file's layout,
measured on this device. The host dataset is loaded and reordered once a
reordering. The tile SpMM's segment length (``ops/cuda_bcsr.py``
``SPMM_SEGMENT_TILES``) is a module constant, not a sweep knob.

Usage:
    python -m parallel_gcn_tpu_torch.harness.tuning_layout <dataset> [--epochs N]
        [--reps N] [--backends b,...] [--reorders r,...] [--tiles t,...]
        [--mults m,...] [--tile-dtypes d,...] [--adj-dtypes d,...] [--min-nnz n,...]
        [--device cuda|cpu] [--out-dir D]

Writes ``<out-dir>/tuning_layout_<dataset>_h100.txt``.
"""

from __future__ import annotations

import argparse
import itertools
import sys

import torch

from parallel_gcn_tpu_torch.data.parser import prepare_device_dataset, prepare_host_dataset
from parallel_gcn_tpu_torch.device import resolve_device
from parallel_gcn_tpu_torch.harness import common
from parallel_gcn_tpu_torch.train import fit

# (backend, reorder, tile_size, tile_cols multiplier); tile knobs are ignored
# outside bcsr/hybrid
GRID = {
    "backend": ["dense", "segment", "hybrid"],
    "reorder": ["none", "rcm", "community"],
    "tile_size": [128, 256, 512],
    "cols_mult": [1, 2, 4],  # tile_cols = tile_size * mult (wide tiles)
}


def time_layout(dataset: str, backend: str, reorder: str, tile: int, epochs: int, reps: int,
                tile_cols: int = 0, tile_dtype: str = "auto", min_tile_nnz: int | None = None,
                adj_dtype: str = "auto", device: str = "cuda", hosts: dict | None = None):
    """The min ms/epoch over ``reps`` runs of one layout, or None when it
    fails (out of memory, an unsupported combination); ``hosts`` caches the
    host dataset by reordering."""
    over = dict(epochs=epochs, early_stopping=0, verbose=False, matmul_precision="default",
                mode="scan", backend=backend, reorder=reorder, tile_size=tile,
                tile_cols=tile_cols, tile_dtype=tile_dtype, adj_dtype=adj_dtype)
    if min_tile_nnz is not None:
        over["min_tile_nnz"] = min_tile_nnz
    cfg = common.config(dataset, over)
    hosts = {} if hosts is None else hosts
    try:
        if reorder not in hosts:
            hosts[reorder] = prepare_host_dataset(cfg, dataset)
        _, dds = prepare_device_dataset(cfg, dataset, resolve_device(device), hosts[reorder])
        fit(cfg, dds)
        return min(fit(cfg, dds).avg_epoch_time_s * 1e3 for _ in range(reps))
    except (torch.cuda.OutOfMemoryError, ValueError) as e:  # an unsupported combination
        print(f"  {backend}/{reorder}/t{tile}: failed ({type(e).__name__}: {e})",
              file=sys.stderr, flush=True)
        return None


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("dataset")
    ap.add_argument("--epochs", type=int, default=500)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--backends", default="", help="comma filter, e.g. hybrid")
    ap.add_argument("--reorders", default="", help="comma filter, e.g. rcm")
    ap.add_argument("--tiles", default="", help="comma list of tile sizes, e.g. 512")
    ap.add_argument("--mults", default="", help="comma list of tile_cols multipliers, e.g. 1,2")
    ap.add_argument("--tile-dtypes", default="auto", help="comma list, e.g. auto,int8")
    ap.add_argument("--adj-dtypes", default="auto",
                    help="comma list for the dense backend, e.g. auto,int8")
    ap.add_argument("--min-nnz", default="",
                    help="comma list of min_tile_nnz (empty: the dataset config's)")
    common.add_common(ap)
    args = ap.parse_args(argv)
    nnz_list = [int(v) for v in args.min_nnz.split(",")] if args.min_nnz else [None]
    grid = dict(GRID)
    if args.backends:
        known = ("dense", "segment", "bcsr", "hybrid")
        requested = args.backends.split(",")
        unknown = [b for b in requested if b not in known]
        if unknown:
            print(f"unknown backend(s) {unknown}; choose from {known}", file=sys.stderr)
            return 2
        grid["backend"] = requested
    if args.reorders:
        grid["reorder"] = [r for r in grid["reorder"] if r in args.reorders.split(",")]
    if args.tiles:
        grid["tile_size"] = [int(t) for t in args.tiles.split(",")]
    if args.mults:
        grid["cols_mult"] = [int(m) for m in args.mults.split(",")]
    dev = resolve_device(args.device)
    rows, seen, hosts = [], set(), {}
    try:
        for backend, reorder, tile, mult, tdt, nnz, adt in itertools.product(
                grid["backend"], grid["reorder"], grid["tile_size"], grid["cols_mult"],
                args.tile_dtypes.split(","), nnz_list, args.adj_dtypes.split(",")):
            tile_cols = tile * mult
            # tile knobs only matter for tile backends, adj_dtype only for dense
            tiled, dense = backend in ("bcsr", "hybrid"), backend == "dense"
            key = (backend, reorder, tile if tiled else 0, tile_cols if tiled else 0,
                   tdt if tiled else "auto", nnz if tiled else None, adt if dense else "auto")
            if key in seen:
                continue
            seen.add(key)
            ms = time_layout(args.dataset, backend, reorder, tile, args.epochs, args.reps,
                             tile_cols=tile_cols, tile_dtype=tdt if tiled else "auto",
                             min_tile_nnz=nnz if tiled else None,
                             adj_dtype=adt if dense else "auto", device=args.device,
                             hosts=hosts)
            if ms is None:
                continue
            label = (f"{backend}/{reorder}" + (f"/t{tile}x{tile_cols}/{tdt}" if tiled else "")
                     + (f"/nnz{nnz}" if tiled and nnz is not None else "")
                     + (f"/adj-{adt}" if dense and adt != "auto" else ""))
            print(f"{args.dataset} {label:24s} epoch {ms:.4f} ms", flush=True)
            rows.append((ms, label))
    except FileNotFoundError:
        common.unavailable(args.dataset)
        return 0
    rows.sort()
    card = common.card(dev)
    common.write(args.out_dir, f"tuning_layout_{args.dataset}_h100.txt",
                 [f"{ms:.4f} {args.dataset} {label} [{card}]" for ms, label in rows])
    if rows:
        print(f"\nbest: {rows[0][1]} at {rows[0][0]:.4f} ms/epoch on {card}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
