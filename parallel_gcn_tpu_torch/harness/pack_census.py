"""Pack-geometry census — the JAX package's ``harness/pack_census.py`` over
the port: predict each candidate hybrid layout's aggregation-pass cost from
measured constants before timing it (``harness.tuning_layout``).

Each candidate pack is built host-side and scored with the cost model

    pass_cost = max(tile_bytes / RATE, n_tiles * TILE_S)   # K4's tile part
              + residual_entries * ITEM_S                   # the ordered gather-sum

the census's statistics computed exactly as the JAX harness computes them.
The constants are arguments (``--rate``, ``--tile-us``, ``--item-ns``); by
default the card's own at the aggregation width ``--width`` (the nearest
measured of ``H100``): K4's int8 tile stream (RATE, from 512x512 tiles),
its cost a tile where bytes are few (TILE_S, from 128x128 tiles) and the
ordered gather-sum's cost an item over a residual without hubs (ITEM_S),
each the slope of a timed sweep (``--measure``, CUDA events over K4 and
kernel (a) at two sizes). ``V5E`` are the JAX harness's TPU constants, for
comparison with its numbers only.

Usage:
    python -m parallel_gcn_tpu_torch.harness.pack_census <dataset> [--tiles 128,256,512]
        [--mults 1,2,4] [--reorders rcm,community] [--min-nnz auto,...]
        [--tile-dtype int8] [--width F] [--rate B/s] [--tile-us us] [--item-ns ns]
        [--device cuda|cpu] [--out-dir D]
    python -m parallel_gcn_tpu_torch.harness.pack_census --measure [--widths 47,96,256]

Writes ``<out-dir>/pack_census_<dataset>_h100.txt`` (``--measure``:
``pack_constants_h100.txt``).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from parallel_gcn_tpu_torch.device import resolve_device
from parallel_gcn_tpu_torch.harness import common

# (bytes/s, s a tile, s an item) at each aggregation width, measured by
# ``--measure`` on NVIDIA H100 80GB HBM3, 700.00 W (output/pack_constants_h100.txt)
H100 = {
    47: (1.87227e12, 7.00868e-09, 6.71048e-11),
    96: (9.55011e11, 1.67261e-08, 6.21575e-11),
    256: (4.50654e11, 3.14049e-08, 1.46288e-10),
}
# the JAX harness's TPU v5e constants (harness/pack_census.py:32-34)
V5E = (819e9, 0.36e-6, 14e-9)


def nearest_width(width: int) -> int:
    """The width of ``H100`` nearest ``width``."""
    return min(H100, key=lambda w: (abs(w - width), w))


def constants(width: int) -> tuple[float, float, float]:
    """``H100``'s constants at the measured width nearest ``width``."""
    return H100[nearest_width(width)]


def census_row(dds, consts: tuple[float, float, float], **label) -> dict | None:
    """The census of one built layout (``DeviceDataset``; None without a
    tile pack): tiles, their bytes and fill, the live residual entries and
    the predicted pass (the JAX harness's ``census``)."""
    rate, tile_s, item_s = consts
    g = dds.graph
    if g.bcsr is None:
        return None
    pack = g.bcsr
    tiles = pack.tiles
    n_tiles = int(pack.n_tiles_real)
    tile_bytes = n_tiles * tiles.shape[1] * tiles.shape[2] * tiles.element_size()
    resid = int((g.val != 0).sum()) if g.is_hybrid else 0
    # the nonzero entries, 1024 tiles at a time (a multi-GB pack's count in
    # one call would allocate several times its size)
    covered = sum(int(torch.count_nonzero(tiles[t:t + 1024])) for t in range(0, n_tiles, 1024))
    tile_cost = max(tile_bytes / rate, n_tiles * tile_s)
    return dict(**label, dtype=str(tiles.dtype).removeprefix("torch."), n_tiles=n_tiles,
                tile_bytes=tile_bytes, covered=covered, resid=resid,
                fill=covered / max(n_tiles * tiles.shape[1] * tiles.shape[2], 1),
                pred_us=(tile_cost + resid * item_s) * 1e6,
                bound="grid" if n_tiles * tile_s > tile_bytes / rate else "bytes")


def census(dataset: str, reorder: str, tile: int, cols: int, min_nnz, tile_dtype: str,
           consts, device: str = "cpu", hosts: dict | None = None) -> dict | None:
    """Build one layout of ``dataset`` (the host dataset loaded and
    reordered once a reordering, ``hosts``) and take its census."""
    from parallel_gcn_tpu_torch.data.parser import prepare_device_dataset, prepare_host_dataset

    over = dict(backend="hybrid", reorder=reorder, tile_size=tile, tile_cols=cols,
                tile_dtype=tile_dtype)
    if min_nnz is not None:
        over["min_tile_nnz"] = min_nnz
    cfg = common.config(dataset, over)
    hosts = {} if hosts is None else hosts
    try:
        if reorder not in hosts:
            hosts[reorder] = prepare_host_dataset(cfg, dataset)
        _, dds = prepare_device_dataset(cfg, dataset, resolve_device(device), hosts[reorder])
    except (ValueError, torch.cuda.OutOfMemoryError) as e:
        print(f"  {reorder}/t{tile}x{cols}/nnz{min_nnz}: build failed "
              f"({type(e).__name__}: {e})", file=sys.stderr)
        return None
    return census_row(dds, consts, reorder=reorder, tile=tile, cols=cols, min_nnz=min_nnz)


def row_line(dataset: str, r: dict) -> str:
    return (f"{dataset} {r['reorder']:9s} t{r['tile']}x{r['cols']:<5d}"
            f" nnz={str(r['min_nnz']):>4s} {r['dtype']:5s} tiles={r['n_tiles']:5d}"
            f" bytes={r['tile_bytes'] / 1e6:8.2f}MB"
            f" fill={r['fill']:6.2%} resid={r['resid']:7d}"
            f" pred={r['pred_us']:7.1f}us/pass [{r['bound']}]")


def _random_pack(n_rows: int, tile: int, per_row: int, gen: np.random.Generator):
    """An int8 pattern pack of ``n_rows`` tile rows with ``per_row`` tiles
    each (distinct random block columns) of 96 entries, d = 1."""
    from parallel_gcn_tpu_torch.ops.cuda_bcsr import build_bcsr

    n = n_rows * tile
    trow = np.repeat(np.arange(n_rows), per_row)
    tcol = np.stack([gen.permutation(n_rows)[:per_row] for _ in range(n_rows)]).reshape(-1)
    k = 96
    rows = (trow[:, None] * tile + gen.integers(0, tile, (len(trow), k))).reshape(-1)
    cols = (tcol[:, None] * tile + gen.integers(0, tile, (len(tcol), k))).reshape(-1)
    key = np.unique(rows * n + cols)
    return build_bcsr(key // n, key % n, np.ones(len(key), np.float32), n,
                      dtype=torch.int8, tile=tile, sym_scale=np.ones(n, np.float32))


def measure(widths: list[int], device: torch.device) -> dict:
    """The cost model's constants at each width, each the slope between two
    sizes of a timed sweep (CUDA events, ``utils.timer.events_ms``): K4 over
    512x512 int8 tiles at 1 and 4 tiles a tile row (RATE = a tile's bytes
    over its time), over 128x128 tiles the same way (TILE_S), and kernel (a)
    over 2M and 8M residual items at random over 1M rows (no hub rows)
    (ITEM_S). Returns {width: (RATE, TILE_S, ITEM_S)}."""
    from parallel_gcn_tpu_torch.ops import cuda_bcsr as cb
    from parallel_gcn_tpu_torch.ops import cuda_segment as cs
    from parallel_gcn_tpu_torch.utils.timer import events_ms

    gen = np.random.default_rng(16)
    n = 1 << 20
    packs = {t: [_random_pack(n // t, t, k, gen).to(device) for k in (1, 4)] for t in (512, 128)}
    res = []
    for e in (2 << 20, 8 << 20):
        rows = np.sort(gen.integers(0, n, e))
        idx = torch.from_numpy(rows).to(device)
        src = torch.from_numpy(gen.integers(0, n, e)).to(device)
        res.append(cs.segments(idx, n, src, torch.ones(e, device=device)))
    out = {}
    for w in widths:
        x = torch.randn((n, w), device=device).to(torch.bfloat16)
        t = {}
        for tile, (one, four) in packs.items():
            ms = [events_ms(lambda p=p: cb.bcsr_matmul_impl(p, x), 10) for p in (one, four)]
            t[tile] = (ms[1] - ms[0]) * 1e-3 / (four.n_tiles - one.n_tiles)
        ms = [events_ms(lambda s=s: cs.gather_sum(x, s), 10) for s in res]
        item = (ms[1] - ms[0]) * 1e-3 / (res[1].index.numel() - res[0].index.numel())
        out[w] = (512 * 512 / t[512], t[128], item)
        print(f"width {w}: K4 512x512 int8 {t[512] * 1e6:.3f} us a tile "
              f"({out[w][0] / 1e12:.3f} TB/s), 128x128 {t[128] * 1e6:.3f} us a tile; "
              f"kernel (a) {item * 1e9:.3f} ns an item", flush=True)
    return out


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("dataset", nargs="?", default="")
    ap.add_argument("--tiles", default="128,256,512")
    ap.add_argument("--mults", default="1,2,4")
    ap.add_argument("--reorders", default="rcm,community")
    ap.add_argument("--min-nnz", default="auto",
                    help="comma list; 'auto' = the dataset config's")
    ap.add_argument("--tile-dtype", default="int8")
    ap.add_argument("--width", type=int, default=0,
                    help="aggregation width for the constants (0: the dataset's classes)")
    ap.add_argument("--rate", type=float, default=0.0, help="tile stream, bytes/s")
    ap.add_argument("--tile-us", type=float, default=0.0, help="cost a tile, us")
    ap.add_argument("--item-ns", type=float, default=0.0, help="cost a residual item, ns")
    ap.add_argument("--measure", action="store_true", help="measure the constants on the card")
    ap.add_argument("--widths", default="47,96,256", help="--measure's widths")
    common.add_common(ap)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    card = common.card(dev)
    if args.measure:
        table = measure([int(w) for w in args.widths.split(",")], dev)
        common.write(args.out_dir, "pack_constants_h100.txt",
                     [f"width {w} rate_bytes_s {c[0]:.6g} tile_s {c[1]:.6g} item_s {c[2]:.6g} "
                      f"[{card}]" for w, c in table.items()])
        return 0
    if not args.dataset:
        ap.error("a dataset, or --measure")
    from parallel_gcn_tpu_torch.data.parser import prepare_host_dataset

    reorders = args.reorders.split(",")
    try:
        first = prepare_host_dataset(common.config(args.dataset, {"reorder": reorders[0]}),
                                     args.dataset)
    except FileNotFoundError:
        common.unavailable(args.dataset)
        return 0
    width = args.width or first.output_dim
    rate, tile_s, item_s = constants(width)
    consts = (args.rate or rate, args.tile_us * 1e-6 or tile_s, args.item_ns * 1e-9 or item_s)
    nnz_list = [None if v == "auto" else int(v) for v in args.min_nnz.split(",")]
    rows, hosts = [], {reorders[0]: first}
    for reorder in reorders:
        for tile in (int(t) for t in args.tiles.split(",")):
            for mult in (int(m) for m in args.mults.split(",")):
                for nnz in nnz_list:
                    r = census(args.dataset, reorder, tile, tile * mult, nnz,
                               args.tile_dtype, consts, args.device, hosts)
                    if r is None:
                        continue
                    rows.append(r)
                    print(row_line(args.dataset, r), flush=True)
    rows.sort(key=lambda r: r["pred_us"])
    print("\npredicted frontier (confirm the top few on the card):")
    for r in rows[:6]:
        print(f"  {r['reorder']}/t{r['tile']}x{r['cols']}/nnz{r['min_nnz']}"
              f" -> {r['pred_us']:.1f} us/pass")
    source = ("the constants given" if (args.rate or args.tile_us or args.item_ns)
              else f"the constants measured at width {nearest_width(width)} on NVIDIA H100 "
                   f"80GB HBM3, 700.00 W, output/pack_constants_h100.txt")
    common.write(args.out_dir, f"pack_census_{args.dataset}_h100.txt",
                 [f"# {args.dataset}: predicted aggregation pass, fastest first; "
                  f"rate {consts[0]:.4g} B/s, {consts[1] * 1e6:.4g} us a tile, "
                  f"{consts[2] * 1e9:.4g} ns an item ({source}); packs built on {card}"]
                 + [row_line(args.dataset, r) for r in rows])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
