#!/usr/bin/env python3
"""The mesh trainer's halos side by side, one process per GPU.

    torchrun --standalone --nproc_per_node=4 mesh_halos.py
    torchrun --standalone --nproc_per_node=4 mesh_halos.py --small --device cpu   # a rehearsal

Trains ``fit_parallel`` for 10 epochs (``mode=scan``) on synth-reddit
(``parameters/parameters_synth-reddit.txt``) with:
- the GCN over flat COO slabs (``backend=segment``) with the all_gather,
  ring and adaptive halos;
- the GCN over int8 tile slabs with the all_gather halo and with the
  boundary halo kept where it does not pay off (``halo_fallback=false``);
- the GCN over int8 tile slabs of the hub graph (the JAX package's
  ``tests/test_parallel.py`` power-law fixture at synth-reddit's padded
  node count, 233,472, with random features, labels and split from a seed)
  with the all_gather and the adaptive halos.

Each run prints, per rank, the halo it ran, its rows and source-buffer rows,
its ms/epoch (the scan's replays) and the peak ``max_memory_allocated`` of
the run above what the rank held before it. For the ring and adaptive runs
the rank's aggregation of a bf16 [n_local, 41] input, captured in a CUDA
graph (its NCCL send/receive or all_to_all inside) and replayed, must equal
the eager call bit for bit. (A scan and an eager run of the whole training
differ in the last bits at more than one rank: the deferred-eval epoch
all-reduces the gradients with four sums, the eager one with two, and the
reduction splits vectors of other lengths otherwise.) Rank 0 prints the
card's name and power limit and writes every number to
``chiprun_out/mesh_halos.json``.
``--small`` swaps the datasets for small generated ones (a rehearsal on the
CPU with gloo).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import warnings

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from chip_smoke import hub_csr  # noqa: E402
from parallel_gcn_tpu_torch.config import (default_params_path, load_config,  # noqa: E402
                                           parse_override)
from parallel_gcn_tpu_torch.data.parser import Dataset, prepare_host_dataset  # noqa: E402
from parallel_gcn_tpu_torch.parallel import train_parallel as tpl  # noqa: E402
from parallel_gcn_tpu_torch.parallel.collectives import local_device  # noqa: E402

EPOCHS = 10
# name -> (dataset, key=value overrides of the params file)
RUNS = {
    "GCN flat all_gather": ("reddit", ["backend=segment", "halo=all_gather"]),
    "GCN flat ring": ("reddit", ["backend=segment", "halo=ring"]),
    "GCN flat adaptive": ("reddit", ["backend=segment", "halo=adaptive"]),
    "GCN int8 tiles all_gather": ("reddit", ["halo=all_gather"]),
    "GCN int8 tiles boundary (no fallback)": ("reddit", ["halo=boundary",
                                                         "halo_fallback=false"]),
    "GCN int8 tiles all_gather, hub graph": ("hub", ["halo=all_gather"]),
    "GCN int8 tiles adaptive, hub graph": ("hub", ["halo=adaptive"]),
}


def hub_dataset(n: int, features: int, classes: int, seed: int = 0) -> Dataset:
    """The hub graph with normal features, labels and a 66/10/24 split,
    all from ``seed``."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, classes, n).astype(np.int32)
    x = rng.standard_normal((n, features), dtype=np.float32)
    split = rng.choice([1, 2, 3], size=n, p=[0.66, 0.10, 0.24]).astype(np.int32)
    return Dataset(name="hub", graph=hub_csr(n), feature_csr=None, features=x,
                   labels=labels, split=split, n_nodes=n, input_dim=features,
                   output_dim=classes)


def small_datasets() -> dict:
    from parallel_gcn_tpu_torch.data.synthetic import make_synthetic_dataset

    reddit = make_synthetic_dataset(
        "small", n_nodes=3000, n_edges=60_000, input_dim=32, n_classes=8, n_train=1800,
        n_val=300, feature_nnz_per_row=8, n_communities=12)
    return {"reddit": reddit, "hub": hub_dataset(4096, 32, 8)}


def config(overrides: list[str], small: bool, mode: str = "scan"):
    pairs = dict(a.split("=", 1) for a in overrides)
    if small:  # tiles the small graphs can fill
        pairs.update(tile_size="128", tile_cols="256", min_tile_nnz="40", hidden_dims="16")
    cfg = load_config(default_params_path("synth-reddit"),
                      {k: parse_override(v) for k, v in pairs.items()})
    cfg.gcn.epochs, cfg.train.verbose, cfg.train.mode = EPOCHS, False, mode
    return cfg


def captured_equals_eager(graph, device) -> bool:
    """The rank's aggregation of a seeded bf16 [n_local, 41] input, eagerly
    and as a captured CUDA graph's replay (every rank captures together:
    the halo's collectives are in the graph): bit-equal."""
    gen = torch.Generator().manual_seed(1 + graph.rank)
    x = torch.randn((graph.n_local, 41), generator=gen).to(torch.bfloat16).to(device)
    with torch.no_grad():
        eager = graph.aggregate(x)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):  # a warm-up call off the capture
            graph.aggregate(x)
        torch.cuda.current_stream().wait_stream(side)
        captured = torch.cuda.CUDAGraph()
        with torch.cuda.graph(captured):
            out = graph.aggregate(x)
        captured.replay()
        torch.cuda.synchronize()
    return bool(torch.equal(out, eager))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--small", action="store_true", help="small generated datasets")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()
    if args.device == "cuda" and not torch.cuda.is_available():
        print("error: no CUDA device", file=sys.stderr)
        return 1
    device = local_device(torch.device(args.device))
    if device.type == "cuda":
        torch.cuda.set_device(device)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo")
    rank, world = dist.get_rank(), dist.get_world_size()
    try:
        if rank == 0 and device.type == "cuda":
            smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                  "--format=csv,noheader"], capture_output=True, text=True,
                                 timeout=60, check=True)
            for line in smi.stdout.strip().splitlines():
                print(f"[mesh-halos] nvidia-smi: {line.strip()}", flush=True)
        t0 = time.perf_counter()
        if args.small:
            data = small_datasets()
        else:
            cfg = config([], False)
            if rank == 0:  # generates synth-reddit's cache; the other ranks read it
                data = {"reddit": prepare_host_dataset(cfg, "synth-reddit")}
            dist.barrier()
            if rank:
                data = {"reddit": prepare_host_dataset(cfg, "synth-reddit")}
            r = data["reddit"]
            data["hub"] = hub_dataset(232_965 + 507, r.input_dim, r.output_dim)
        if rank == 0:
            print(f"[mesh-halos] {world} ranks on {device}; datasets ready in "
                  f"{time.perf_counter() - t0:.1f} s: "
                  + ", ".join(f"{k} {d.n_nodes} nodes {d.graph.nnz} entries"
                              for k, d in data.items()), flush=True)
        out = {}
        for name, (data_name, overrides) in RUNS.items():
            cfg = config(overrides, args.small)
            ds = data[data_name]
            if device.type == "cuda":
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                held = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            seen = []  # the rank's share of the run fit_parallel trains
            build_rank = tpl.build_rank
            tpl.build_rank = lambda *a, **k: seen.append(build_rank(*a, **k)) or seen[-1]
            try:
                with warnings.catch_warnings():
                    warnings.simplefilter("ignore", UserWarning)
                    res = tpl.fit_parallel(cfg, ds, device=device)
            finally:
                tpl.build_rank = build_rank
            sg = seen[0].sgraph
            mine = dict(halo=tpl.halo_of(sg), n_local=sg.n_local,
                        n_buf=sg.n_local if getattr(sg, "ring", False) else sg.n_buf,
                        push_slab=getattr(sg, "push_slab", 0),
                        ms=res.avg_epoch_time_s * 1e3, seconds=time.perf_counter() - t0,
                        peak=(torch.cuda.max_memory_allocated() - held
                              if device.type == "cuda" else None),
                        loss=[float(res.history[0, 0]), float(res.history[-1, 0])],
                        test_acc=res.test_acc)
            if mine["halo"] in ("ring", "adaptive") and device.type == "cuda":
                mine["captured_bit_equal"] = captured_equals_eager(seen[0].graph, device)
            del seen
            ranks = [None] * world
            dist.all_gather_object(ranks, mine)
            out[name] = ranks
            if rank == 0:
                print(f"[mesh-halos] {name}: " + json.dumps(ranks), flush=True)
        if rank == 0:
            os.makedirs("chiprun_out", exist_ok=True)
            with open(os.path.join("chiprun_out", "mesh_halos.json"), "w") as f:
                json.dump(out, f, indent=1)
            for name, ranks in out.items():
                r0 = ranks[0]
                print(f"[mesh-halos] {name}: halo {r0['halo']}, {r0['ms']:.3f} ms/epoch (rank "
                      f"0), buffer rows {[r['n_buf'] for r in ranks]}, peak bytes "
                      f"{[r['peak'] for r in ranks]}, loss {r0['loss'][0]:.5f} -> "
                      f"{r0['loss'][1]:.5f}"
                      + (f", the aggregation captured and replayed bit-equal to the eager "
                         f"call on every rank: {all(r['captured_bit_equal'] for r in ranks)}"
                         if "captured_bit_equal" in r0 else ""), flush=True)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
