"""Residual-structure census — the JAX package's ``harness/residual_stats.py``
over the port: what the hybrid layout leaves to the ordered gather-sum
(``ops/cuda_segment.py``, kernel (a)), and what a kernel for its structure
could win.

The statistics are the JAX harness's, computed as it computes them: the
live residual entries, their clustering into 8x128 mini-blocks, the rows'
and columns' degree spread, and the cost of an aggregation over the
residual at ``--item-ns`` a gathered index with ``--indices-per-item``
indices an item, beside the bound if every mini-block of 2 or more entries
were absorbed. The JAX harness priced the TPU's gather and scatter (17 ns an
index, 2 an item); the port's default is kernel (a)'s measured cost an item
on the card (``pack_census.H100``; one packed index an item). ``--time``
(on the card) times kernel (a) over the residual at each of ``--widths``
and over its parts: the hub rows (``cuda_segment.HUB_ITEMS`` items or
more), the other rows and the longest row alone, as a call of each.

Usage:
    python -m parallel_gcn_tpu_torch.harness.residual_stats <dataset> [--item-ns ns]
        [--indices-per-item k] [--time] [--widths 47,94] [--set key=value ...]
        [--device cuda|cpu] [--out-dir D]

Writes ``<out-dir>/residual_stats_<dataset>_h100.txt``.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from parallel_gcn_tpu_torch.data.parser import prepare_device_dataset
from parallel_gcn_tpu_torch.device import resolve_device
from parallel_gcn_tpu_torch.harness import common, pack_census


def stats_lines(dataset: str, graph, ns_per_index: float, indices_per_item: int) -> list[str]:
    """The JAX harness's lines for a device graph's residual."""
    row, col = graph.row.cpu().numpy(), graph.col.cpu().numpy()
    live = graph.val.cpu().numpy() != 0
    row, col = row[live], col[live]
    n_pad = graph.n_nodes
    lines = [f"{dataset}: residual nnz = {len(row):,} (tiles hold the rest of the edges)"]
    key = (row.astype(np.int64) // 8) * (n_pad // 128 + 1) + col // 128
    _, counts = np.unique(key, return_counts=True)
    lines.append(f"8x128 blocks touched: {len(counts):,} (1024 slots each)")
    for t in (2, 4, 8, 16):
        m = counts >= t
        edges = int(counts[m].sum())
        lines.append(f"  blocks with >= {t:2d} nnz: {m.sum():8,} covering "
                     f"{edges:10,} edges ({edges / len(row) * 100:5.1f}% of residual)")
    rdeg = np.bincount(row, minlength=n_pad)
    nz = rdeg[rdeg > 0]
    lines.append(f"residual rows: {len(nz):,} | degree mean {nz.mean():.1f} "
                 f"p50 {np.percentile(nz, 50):.0f} p90 {np.percentile(nz, 90):.0f} "
                 f"p99 {np.percentile(nz, 99):.0f} max {nz.max()}")
    cdeg = np.bincount(col, minlength=n_pad)
    nzc = cdeg[cdeg > 0]
    lines.append(f"residual cols: {len(nzc):,} | fan-in mean {nzc.mean():.1f} "
                 f"p99 {np.percentile(nzc, 99):.0f} max {nzc.max()}")
    absorbable = int(counts[counts >= 2].sum())
    current_s = indices_per_item * len(row) * ns_per_index
    bound_s = indices_per_item * (len(row) - absorbable) * ns_per_index
    lines.append(f"segment-path cost at the {ns_per_index * 1e9:.3g} ns/index "
                 f"descriptor rate: ~{current_s * 1e3:.2f} ms/aggregation; "
                 f"absorbing every >=2-nnz block bounds it at "
                 f"~{bound_s * 1e3:.2f} ms — max win {100 * (1 - bound_s / current_s):.1f}%")
    return lines


def time_parts(graph, widths: list[int]) -> list[str]:
    """Kernel (a) over the residual and over its hub rows, its other rows
    and its longest row alone, at each width (bf16; CUDA events over 10
    calls, ``utils.timer.events_ms``)."""
    from parallel_gcn_tpu_torch.ops import cuda_segment as cs
    from parallel_gcn_tpu_torch.utils.timer import events_ms

    n, seg = graph.n_nodes, graph.row_seg
    ptr = seg.ptr.cpu().numpy()
    lens = np.diff(ptr)
    rows = {"hub rows": np.flatnonzero(lens >= cs.HUB_ITEMS),
            "other rows": np.flatnonzero((lens < cs.HUB_ITEMS) & (lens > 0)),
            "longest row": np.argsort(-lens, kind="stable")[:1]}
    parts = {"all": seg}
    item_row = np.repeat(np.arange(len(lens)), lens)  # each sorted item's row
    perm = None if seg.perm is None else seg.perm.cpu().numpy()
    for name, r in rows.items():
        if len(r) == 0:
            continue
        keep = np.zeros(len(lens), dtype=bool)
        keep[r] = True
        items = np.flatnonzero(keep[item_row])
        items = torch.from_numpy(items if perm is None else np.sort(perm[items]))
        items = items.to(graph.row.device)
        parts[name] = cs.segments(graph.row[items], n, graph.col[items], graph.val[items])
    hubs, other = rows["hub rows"], rows["other rows"]
    longest = ", ".join(str(v) for v in sorted(lens[hubs].tolist(), reverse=True)[:3])
    lines = [f"kernel (a) parts: {len(hubs)} hub rows of {cs.HUB_ITEMS} items or more "
             f"({int(lens[hubs].sum()):,} items; the longest {longest or 'none'}), "
             f"{len(other):,} other rows ({int(lens[other].sum()):,} items)"]
    gen = torch.Generator(device=graph.row.device).manual_seed(9)
    for F in widths:
        x = torch.randn((n, F), generator=gen, device=graph.row.device).to(torch.bfloat16)
        ms = {name: events_ms(lambda s=s: cs.gather_sum(x, s), 10) for name, s in parts.items()}
        lines.append(f"kernel (a) [E, {F}] bf16, ms a call: "
                     + "; ".join(f"{k} {v:.4f}" for k, v in ms.items()))
    return lines


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("dataset", nargs="?", default="synth-reddit")
    ap.add_argument("--item-ns", type=float, default=0.0,
                    help="cost an index, ns (default: kernel (a)'s on the card)")
    ap.add_argument("--indices-per-item", type=int, default=1)
    ap.add_argument("--time", action="store_true", help="time kernel (a)'s parts on the card")
    ap.add_argument("--widths", default="", help="--time's widths (default: C and 2C)")
    ap.add_argument("--set", nargs="*", default=[], metavar="KEY=VALUE")
    common.add_common(ap)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = common.config(args.dataset, common.overrides(args.set))
    try:
        ds, dds = prepare_device_dataset(cfg, args.dataset, dev)
    except FileNotFoundError:
        common.unavailable(args.dataset)
        return 0
    g = dds.graph
    if g.bcsr is None:
        print(f"{args.dataset}: config backend={cfg.tpu.backend} builds no tiles — "
              "nothing is on the residual path")
        return 0
    ns = args.item_ns * 1e-9 or pack_census.constants(ds.output_dim)[2]
    lines = stats_lines(args.dataset, g, ns, args.indices_per_item)
    if args.time:
        if dev.type != "cuda":
            ap.error("--time times kernel (a) on the card")
        widths = ([int(w) for w in args.widths.split(",")] if args.widths
                  else [ds.output_dim, 2 * ds.output_dim])
        lines += time_parts(g, widths)
    for ln in lines:
        print(ln, flush=True)
    card = common.card(dev)
    common.write(args.out_dir, f"residual_stats_{args.dataset}_h100.txt",
                 [f"# {args.dataset} ({cfg.tpu.backend}, t{cfg.tpu.tile_size}x"
                  f"{cfg.tpu.tile_cols or cfg.tpu.tile_size} {cfg.tpu.tile_dtype}) on {card}; "
                  f"cost at {ns * 1e9:.3f} ns an index, {args.indices_per_item} an item"]
                 + lines)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
