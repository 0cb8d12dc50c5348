"""Sharded-memory scale demonstration — the JAX package's
``harness/scale_demo.py`` over the port: synth-products node-partitioned
over a mesh with the adaptive push/pull halo.

Two parts, each its own command:

- the accounting (host, numpy; ``parallel/partition.py``): for each D of
  ``--devices`` the adaptive partition (``partition_graph_hybrid(adaptive=
  True)``, per rank pair pull raw rows or push partial sums, whichever ships
  fewer) and the pure-pull boundary partition, over fine ``--mesh-tile``
  int8 tiles with slab balancing off (the JAX harness's choices: the
  community order stays intact and the pull halo stays row-granular), and
  the rows and bytes a device holds: local, pulled and pushed rows, the
  buffer against the boundary layout and the all_gather layout, the edge
  slab and the send index, the bf16 buffers at the input width F and the
  hidden width H. On synth-products the adaptive buffer must be under half
  of all_gather's at every D run (the JAX harness's criterion; D = 8, its
  default, is this one's): the file is written, then a miss fails the run
  (at D = 4 the buffer is 0.61 of all_gather's); other datasets get a note;
- the executed step (``--step``, in a torchrun world of N processes, one
  per GPU): rank 0 generates and caches the dataset while the others wait on
  a barrier, then read the cache; every rank reorders and partitions (the
  adaptive halo over hybrid int8 tile slabs, the config's H), runs one full
  training step (train forward + backward + Adam + val eval) eagerly and
  then ``--epochs`` epochs of the whole-run scan (``mode=scan``); rank 0
  prints the step's metrics, the scan's ms/epoch and, for every rank, its
  peak device memory (``max_memory_allocated``) and peak host RSS.

Usage:
    python -m parallel_gcn_tpu_torch.harness.scale_demo [dataset] [--devices 8]
    torchrun --standalone --nproc_per_node=4 -m parallel_gcn_tpu_torch.harness.scale_demo \\
        [dataset] --step [--epochs 30]
    [--spec key=value ...] (the synthetic spec's sizes, e.g. a downsized graph)
    [--set key=value ...] [--mesh-tile 128] [--mesh-min-nnz 32] [--device cuda|cpu]
    [--out-dir D]

Writes ``<out-dir>/scale_demo_<dataset>_h100.txt``: the accounting writes
the file, a ``--step`` run replaces its executed-step section.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from datetime import timedelta

import numpy as np
import torch

from parallel_gcn_tpu_torch.data.parser import peak_rss_bytes, prepare_host_dataset
from parallel_gcn_tpu_torch.harness import common
from parallel_gcn_tpu_torch.parallel.partition import partition_graph_hybrid

GB = 1024**3
STEP_MARK = "# executed step"


def mesh_kwargs(cfg, mesh_tile: int, mesh_min_nnz: int) -> dict:
    """``partition_graph_hybrid``'s arguments: the config's int8 tiles cut to
    ``mesh_tile`` square with ``mesh_min_nnz`` (0 keeps the config's shape
    and floor), the config's tile budget, slab balancing off."""
    tile_dtype = cfg.tpu.tile_dtype
    if tile_dtype == "auto":
        tile_dtype = "float32" if cfg.tpu.matmul_precision == "highest" else "bfloat16"
    return dict(node_pad=cfg.tpu.node_pad, tile_r=mesh_tile or cfg.tpu.tile_size,
                tile_c=mesh_tile or cfg.tpu.tile_cols, tile_dtype=tile_dtype,
                tile_budget_bytes=cfg.tpu.tile_budget_mb * 1024 * 1024,
                min_tile_nnz=(mesh_min_nnz if mesh_tile else cfg.tpu.min_tile_nnz) or None,
                balance=False)


def accounting(ds, n_dev: int, kw: dict) -> dict:
    """The rows and bytes a device holds at ``n_dev`` ranks (the JAX
    harness's arithmetic over the port's partitions)."""
    sgb = partition_graph_hybrid(ds.graph, n_dev, boundary=True, **kw)
    bnd_rows = sgb.n_local + n_dev * sgb.halo_size
    del sgb
    sg = partition_graph_hybrid(ds.graph, n_dev, adaptive=True, **kw)
    slab = (sg.tiles.nbytes + sg.res_row.nbytes + sg.res_col.nbytes + sg.res_val.nbytes) // n_dev
    if sg.push_slab:
        slab += (sg.ptiles.nbytes + sg.prow.nbytes + sg.pcol.nbytes + sg.pval.nbytes) // n_dev
    return dict(n_dev=n_dev, local=sg.n_local, halo_size=sg.halo_size, push_slab=sg.push_slab,
                buf_rows=sg.n_local + n_dev * (sg.halo_size + sg.push_slab),
                bnd_rows=bnd_rows, full_rows=sg.n_nodes_pad, slab_bytes=slab,
                send_bytes=sg.send_idx.nbytes // n_dev if sg.send_idx is not None else 0)


def accounting_lines(dataset: str, ds, acc: dict, widths: dict, tile: str) -> list[str]:
    """JAX's lines for one partition's accounting (bf16 buffers)."""
    d, buf, full, bnd = acc["n_dev"], acc["buf_rows"], acc["full_rows"], acc["bnd_rows"]
    lines = [
        f"# {dataset}: {ds.n_nodes:,} nodes / {ds.graph.nnz:,} edges, D={d} node shards, "
        f"backend=hybrid ({tile} int8 tiles), adaptive (push/pull) halo",
        f"rows/device: local={acc['local']:,}  pulled={d * acc['halo_size']:,} "
        f"({d}x{acc['halo_size']:,})  pushed-partials={d * acc['push_slab']:,} "
        f"({d}x{acc['push_slab']:,})  buffer={buf:,}",
        f"vs pure-pull boundary={bnd:,} (adaptive {bnd / buf:.1f}x smaller)  "
        f"vs all_gather={full:,} (buffer/full = {buf / full:.2f})",
        f"edge slab/device: {acc['slab_bytes'] / GB:.2f} GB (int8 tiles + COO residual)  "
        f"send-index: {acc['send_bytes'] / GB:.3f} GB",
        "",
        "# per-device aggregation feature buffer (bf16), adaptive vs all_gather",
    ]
    for name, w in widths.items():
        b, f = buf * w * 2, full * w * 2
        lines.append(f"{name:36s} {b / GB:6.2f} GB   vs {f / GB:6.2f} GB all_gather   "
                     f"({f / b:.1f}x smaller)")
    return lines


def _world_barrier(timeout_s: float) -> None:
    import torch.distributed as dist

    group = dist.new_group(backend="gloo", timeout=timedelta(seconds=timeout_s))
    dist.barrier(group=group)


def executed_step(rank: int, world: int, dataset: str, spec: dict, over: dict, epochs: int,
                  device: str, mesh_tile: int, mesh_min_nnz: int) -> dict:
    """One rank's executed step in an initialized world of ``world`` node
    ranks (the adaptive halo over hybrid int8 slabs): the dataset (rank 0
    first, caching it; the others after a barrier), the partition, one
    eager training step and ``epochs`` epochs of the scan. Returns the
    rank's numbers (metrics on every rank are the world's)."""
    from parallel_gcn_tpu_torch.data.parser import load_dataset
    from parallel_gcn_tpu_torch.optim import init_adam
    from parallel_gcn_tpu_torch.parallel.collectives import local_device
    from parallel_gcn_tpu_torch.parallel.train_parallel import (build_rank,
                                                                make_parallel_epoch_step,
                                                                make_parallel_scan_loop,
                                                                preagg_inputs)
    from parallel_gcn_tpu_torch.train import _sync, epoch_seeds

    dev = local_device(torch.device(device))
    tiles = dict(tile_size=mesh_tile, tile_cols=mesh_tile, min_tile_nnz=mesh_min_nnz)
    cfg = common.config(dataset, dict(
        over, halo="adaptive", backend="hybrid", n_devices=world, epochs=epochs,
        early_stopping=0, mode="scan", verbose=False, balance_slabs=False,
        **(tiles if mesh_tile else {})))
    t0 = time.perf_counter()
    if rank == 0 and not spec:
        load_dataset(dataset)  # generate and cache once
    _world_barrier(3600.0)
    ds = prepare_host_dataset(cfg, dataset, spec)
    t_data = time.perf_counter() - t0
    t0 = time.perf_counter()
    run = build_rank(cfg, ds, rank, world, "adaptive", dev)
    t_part = time.perf_counter() - t0
    sg = run.sgraph
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    x_train, x_eval = preagg_inputs(cfg, run)
    opt = init_adam(list(run.model.weights))
    gen = torch.Generator().manual_seed(cfg.tpu.seed)
    step = make_parallel_epoch_step(cfg, run.model, run.graph, run.data, run.split_counts,
                                    x_train, x_eval)
    _sync(dev)
    t0 = time.perf_counter()
    metrics = step(opt, run.seeds(epoch_seeds(gen, run.model.n_layers))).tolist()
    step_s = time.perf_counter() - t0
    scan = make_parallel_scan_loop(cfg, run, opt, gen, x_train, x_eval).run()
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    return dict(rank=rank, metrics=metrics, step_s=step_s, data_s=t_data, partition_s=t_part,
                scan_ms=scan.epoch_s * 1e3, setup_s=scan.setup_s, replays=scan.replays,
                history=scan.history.tolist(), peak_device=peak, peak_rss=peak_rss_bytes(),
                halo_size=sg.halo_size, push_slab=sg.push_slab, n_local=sg.n_local,
                n_buf=sg.n_buf, H=cfg.gcn.hidden_dims[0], world=world,
                card=common.card(dev))


def step_lines(rows: list[dict]) -> list[str]:
    """The executed step's section from every rank's ``executed_step``."""
    r0 = rows[0]
    m = r0["metrics"]
    ok = bool(np.isfinite(m).all()) and bool(np.isfinite(r0["history"]).all())
    lines = [
        f"{STEP_MARK} on {r0['world']} x {r0['card']}: backend=hybrid, halo=adaptive, "
        f"H={r0['H']}",
        f"1 full sharded training step (train fwd + bwd + Adam + val eval, eager) in "
        f"{r0['step_s']:.3f} s: train_loss={m[0]:.4f} train_acc={m[1]:.4f} "
        f"val_loss={m[2]:.4f} val_acc={m[3]:.4f} finite={ok}",
        f"then mode=scan: {len(r0['history'])} epochs, epoch 1 and the capture "
        f"{r0['setup_s']:.3f} s, {r0['scan_ms']:.3f} ms/epoch over {r0['replays']} replays; "
        f"train loss {r0['history'][0][0]:.4f} -> {r0['history'][-1][0]:.4f}",
    ]
    for r in rows:
        lines.append(
            f"rank {r['rank']}: rows local {r['n_local']:,} buffer {r['n_buf']:,} (pulled "
            f"{r['world']}x{r['halo_size']:,}, pushed {r['world']}x{r['push_slab']:,}); "
            f"peak device memory {r['peak_device'] / GB:.2f} GB; peak host RSS "
            f"{r['peak_rss'] / GB:.2f} GB; data {r['data_s']:.1f} s, partition "
            f"{r['partition_s']:.1f} s")
    return lines


def _sections(path: str) -> tuple[list[str], list[str]]:
    """The file's accounting lines and its executed-step section."""
    if not os.path.exists(path):
        return [], []
    with open(path) as f:
        lines = f.read().splitlines()
    i = next((i for i, ln in enumerate(lines) if ln.startswith(STEP_MARK)), len(lines))
    acc = lines[:i]
    while acc and not acc[-1]:
        acc.pop()
    return acc, lines[i:]


def _write(out_dir: str, path: str, acc: list[str], step: list[str]) -> None:
    common.write(out_dir, os.path.basename(path), acc + ([""] if acc and step else []) + step)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("dataset", nargs="?", default="synth-products")
    ap.add_argument("--devices", default="8", help="the accounting's D values (comma list)")
    ap.add_argument("--step", action="store_true",
                    help="the executed step, in a torchrun world (one process per GPU)")
    ap.add_argument("--epochs", type=int, default=30, help="the scan's epochs after the step")
    ap.add_argument("--mesh-tile", type=int, default=128,
                    help="square tile side of the mesh partition (0: the config's tiles)")
    ap.add_argument("--mesh-min-nnz", type=int, default=32)
    ap.add_argument("--spec", nargs="*", default=[], metavar="KEY=VALUE",
                    help="synthetic spec sizes (a downsized graph, never cached)")
    ap.add_argument("--set", nargs="*", default=[], metavar="KEY=VALUE")
    common.add_common(ap)
    args = ap.parse_args(argv)
    spec, over = common.overrides(args.spec), common.overrides(args.set)
    path = os.path.join(args.out_dir, f"scale_demo_{args.dataset}_h100.txt")
    if args.step:
        return _step_main(args, spec, over, path)
    from parallel_gcn_tpu_torch.device import resolve_device

    cfg = common.config(args.dataset, over)
    t0 = time.perf_counter()
    try:
        ds = prepare_host_dataset(cfg, args.dataset, spec)
    except FileNotFoundError:
        common.unavailable(args.dataset)
        return 0
    print(f"[{args.dataset}] {ds.n_nodes:,} nodes / {ds.graph.nnz:,} edges (+self-loops), "
          f"{ds.input_dim} features, loaded and reordered in {time.perf_counter() - t0:.0f} s",
          flush=True)
    kw = mesh_kwargs(cfg, args.mesh_tile, args.mesh_min_nnz)
    widths = {"input features (F)": ds.input_dim,
              f"hidden activations (H={cfg.gcn.hidden_dims[0]})": cfg.gcn.hidden_dims[0]}
    lines = [f"# accounting: host partitions (parallel/partition.py) on the host of "
             f"{common.card(resolve_device(args.device))}, peak host RSS at the end of each D in "
             f"the line after it"]
    misses = []
    for n_dev in (int(d) for d in args.devices.split(",")):
        t0 = time.perf_counter()
        acc = accounting(ds, n_dev, kw)
        block = accounting_lines(args.dataset, ds, acc, widths,
                                 f"{kw['tile_r']}x{kw['tile_c']}")
        block.append(f"partitioned D={n_dev} boundary + adaptive in "
                     f"{time.perf_counter() - t0:.0f} s, peak host RSS "
                     f"{peak_rss_bytes() / GB:.1f} GB")
        ratio = acc["buf_rows"] / acc["full_rows"]
        if ratio >= 0.5 and args.dataset == "synth-products":
            misses.append(f"D={n_dev}: adaptive halo buffer {acc['buf_rows']:,} rows is not "
                          f"under half of all_gather's {acc['full_rows']:,} ({ratio:.2f})")
            block.append(f"criterion missed at {misses[-1]}")
        elif ratio >= 0.5:
            block.append(f"note: halo not compact on {args.dataset} (ratio {ratio:.2f}) - "
                         "expected for small dense graphs; the scaling claim is about "
                         "products-scale locality")
        for ln in block:
            print(ln, flush=True)
        lines += [""] + block
    _write(args.out_dir, path, lines, _sections(path)[1])
    print(f"wrote {path}")
    # the JAX harness's memory criterion on synth-products, at every D run:
    # checked after the file is written, so a miss leaves its numbers
    assert not misses, "; ".join(misses)
    return 0


def _step_main(args, spec: dict, over: dict, path: str) -> int:
    import torch.distributed as dist

    from parallel_gcn_tpu_torch.device import resolve_device
    from parallel_gcn_tpu_torch.parallel.collectives import local_device

    if "WORLD_SIZE" not in os.environ:
        print("--step runs in a torchrun world, one process per GPU: torchrun --standalone "
              "--nproc_per_node=N -m parallel_gcn_tpu_torch.harness.scale_demo ... --step",
              file=sys.stderr)
        return 2
    dev = local_device(resolve_device(args.device))
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            timeout=timedelta(hours=1))
    try:
        rank, world = dist.get_rank(), dist.get_world_size()
        row = executed_step(rank, world, args.dataset, spec, over, args.epochs, str(dev),
                            args.mesh_tile, args.mesh_min_nnz)
        rows = [None] * world
        group = dist.new_group(backend="gloo")
        dist.all_gather_object(rows, row, group=group)
        if rank == 0:
            section = step_lines(rows)
            for ln in section:
                print(ln, flush=True)
            _write(args.out_dir, path, _sections(path)[0], section)
            print(f"wrote {path}")
            assert "finite=True" in section[1], "non-finite metrics from the sharded step"
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
