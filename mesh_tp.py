#!/usr/bin/env python3
"""Tensor parallelism on the mesh trainer, one process per GPU.

    torchrun --standalone --nproc_per_node=4 mesh_tp.py
    torchrun --standalone --nproc_per_node=4 mesh_tp.py --small --device cpu   # a rehearsal

Trains ``fit_parallel`` for 10 epochs (``mode=scan``) on synth-reddit
(``parameters/parameters_synth-reddit.txt``: int8 tile slabs, the all_gather
halo, 602 -> 600 -> 41, bf16) as the GCN, SAGE and GIN (``gin_eps=0``) in
the (n_devices, tp) layouts (4, 1), (2, 2) and (1, 4) of the world's 4
processes. Each run prints, per rank, its node and feat index, its ms/epoch
(the scan's replays), the peak ``max_memory_allocated`` of the run above
what the rank held before it, its weight shards' shapes and the collectives
a replay calls by kind. Per layout the same configuration runs twice in
``mode=scan`` (history, test metrics and weights bit-equal) and once in
``mode=eager`` (train losses within 1e-4 of the scan's: the eager step
all-reduces the gradients with two sums, the deferred scan epoch with four,
so the reductions split other vectors). Each family also runs once per
layout in float32 (matmul precision ``highest``, dropouts 0, so every layout
draws the same nothing, learning rate 0.001, see ``F32``): its train and
val losses, every epoch, within
1e-4·max(1, |loss|) of the (4, 1) layout's, which holds the feat
collectives and their transposes on the card to the node split alone. The
accuracies are printed as nodes that changed class (an argmax between
near-tied logits flips under any reordering of an f32 sum). Every run of one layout reads the
same partition (built once per layout). Rank 0 prints the card's name and
power limit (again after the summary) and writes them and every number to
``chiprun_out/mesh_tp.json``.
``--small`` swaps synth-reddit for a small generated graph at the same
layer widths (a rehearsal on the CPU with gloo).
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

from parallel_gcn_tpu_torch.config import (default_params_path, load_config,  # noqa: E402
                                           parse_override)
from parallel_gcn_tpu_torch.data.parser import prepare_host_dataset  # noqa: E402
from parallel_gcn_tpu_torch.parallel import train_parallel as tpl  # noqa: E402
from parallel_gcn_tpu_torch.parallel.collectives import local_device  # noqa: E402

EPOCHS = 10
FAMILIES = {"GCN": [], "SAGE": ["model=sage"], "GIN": ["model=gin", "gin_eps=0"]}
TPS = (1, 2, 4)
# the float32 runs held across layouts: no rounding to bf16, no TF32, no
# dropout, and a learning rate of 0.001: at the file's 0.01 GIN-0's Adam
# steps part f32 runs that differ only in the order of their sums (1e-7 at
# epoch 1, 5e-4 by epoch 9 on the --small graph); at 0.001 they stay within 1e-6
F32 = ["compute_dtype=float32", "matmul_precision=highest", "dropouts=0.0,0.0",
       "learning_rate=0.001"]
F32_RTOL = 1e-4


def small_dataset():
    from parallel_gcn_tpu_torch.data.synthetic import make_synthetic_dataset

    return make_synthetic_dataset(
        "small", n_nodes=3000, n_edges=60_000, input_dim=602, n_classes=41, n_train=1800,
        n_val=300, feature_nnz_per_row=8, n_communities=12)


def config(overrides: list[str], small: bool, mode: str):
    pairs = dict(a.split("=", 1) for a in overrides)
    if small:  # tiles the small graph can fill
        pairs.update(tile_size="128", tile_cols="256", min_tile_nnz="40")
    cfg = load_config(default_params_path("synth-reddit"),
                      {k: parse_override(v) for k, v in pairs.items()})
    cfg.gcn.epochs, cfg.train.verbose, cfg.train.mode = EPOCHS, False, mode
    return cfg


def run(cfg, ds, device, partitions: dict) -> tuple:
    """``fit_parallel`` of ``cfg`` on this rank: (result, the rank's
    ``RankRun``, its numbers). The partition of this layout is built once
    (``partitions``) and read by every run of it."""
    n_dev = dist.get_world_size() // cfg.tpu.tp
    key = (n_dev, cfg.tpu.halo)
    partition_for, build_rank = tpl.partition_for, tpl.build_rank
    if key not in partitions:
        partitions[key] = partition_for(cfg, ds, n_dev, cfg.tpu.halo)
    seen = []
    tpl.partition_for = lambda *a, **k: partitions[key]
    tpl.build_rank = lambda *a, **k: seen.append(build_rank(*a, **k)) or seen[-1]
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            res = tpl.fit_parallel(cfg, ds, device=device)
    finally:
        tpl.partition_for, tpl.build_rank = partition_for, build_rank
    rr = seen[0]
    mine = dict(node=rr.grid.node_rank, feat=rr.grid.feat_rank,
                ms=res.avg_epoch_time_s * 1e3, seconds=time.perf_counter() - t0,
                peak=(torch.cuda.max_memory_allocated() - held
                      if device.type == "cuda" else None),
                shards=[list(w.shape) for w in rr.model.weights],
                collectives_a_replay={k: v for k, v in res.graph_launches.items()
                                      if k in tpl.collectives.counts},
                launches_a_replay={k: v for k, v in res.graph_launches.items()
                                   if k not in tpl.collectives.counts},
                loss=[float(res.history[0, 0]), float(res.history[-1, 0])],
                test_acc=res.test_acc)
    return res, mine


def rel_loss_diff(hist: np.ndarray, ref: np.ndarray) -> float:
    """The largest |Δ|/max(1, |ref|) over the train and val losses (history
    columns 0 and 2) of every epoch."""
    a, b = hist[:, [0, 2]], ref[:, [0, 2]]
    return float((np.abs(a - b) / np.maximum(1.0, np.abs(b))).max())


def acc_nodes(hist: np.ndarray, ref: np.ndarray, splits: tuple) -> list:
    """The most train and val nodes whose class changed in any epoch: the
    accuracy columns' differences times the split sizes."""
    return [int(round(float(np.abs(hist[:, c] - ref[:, c]).max()) * n))
            for c, n in zip((1, 3), splits)]


def same_run(a, b) -> bool:
    return (np.array_equal(a.history, b.history) and a.test_loss == b.test_loss
            and a.test_acc == b.test_acc
            and all(torch.equal(x, y) for x, y in zip(a.weights, b.weights)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--small", action="store_true", help="a small generated dataset")
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
        card = []
        if rank == 0 and device.type == "cuda":
            smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                  "--format=csv,noheader"], capture_output=True, text=True,
                                 timeout=60, check=True)
            card = [line.strip() for line in smi.stdout.strip().splitlines()]
            print(f"[mesh-tp] nvidia-smi: {card}", flush=True)
        t0 = time.perf_counter()
        if args.small:
            ds = small_dataset()
        else:
            cfg = config([], False, "scan")
            if rank == 0:  # generates synth-reddit's cache; the other ranks read it
                ds = prepare_host_dataset(cfg, "synth-reddit")
            dist.barrier()
            if rank:
                ds = prepare_host_dataset(cfg, "synth-reddit")
        if rank == 0:
            print(f"[mesh-tp] {world} ranks on {device}; {ds.n_nodes} nodes, {ds.graph.nnz} "
                  f"entries, ready in {time.perf_counter() - t0:.1f} s", flush=True)
        splits = (ds.train_dim, ds.val_dim)
        out, partitions, tp1 = {}, {}, {}
        for tp in TPS:
            layout = f"({world // tp}, {tp})"
            for fam, overrides in FAMILIES.items():
                over = [*overrides, f"tp={tp}"]
                name = f"{fam} {layout}"
                scan, mine = run(config(over, args.small, "scan"), ds, device, partitions)
                again, _ = run(config(over, args.small, "scan"), ds, device, partitions)
                eager, eager_mine = run(config(over, args.small, "eager"), ds, device,
                                        partitions)
                f32, _ = run(config([*over, *F32], args.small, "scan"), ds, device,
                             partitions)
                # the first layout, (world, 1), is every later one's reference
                ref_f32, ref_bf16 = tp1.setdefault(fam, (f32.history, scan.history))
                mine.update(
                    scans_bit_equal=same_run(scan, again),
                    eager_ms=eager_mine["ms"],
                    eager_max_train_loss_diff=float(
                        np.abs(eager.history[:, 0] - scan.history[:, 0]).max()),
                    f32_loss=[float(f32.history[0, 0]), float(f32.history[-1, 0])],
                    f32_max_rel_diff_to_tp1=rel_loss_diff(f32.history, ref_f32),
                    f32_acc_nodes_changed=acc_nodes(f32.history, ref_f32, splits),
                    bf16_max_rel_diff_to_tp1=rel_loss_diff(scan.history, ref_bf16),
                    bf16_acc_nodes_changed=acc_nodes(scan.history, ref_bf16, splits))
                ranks = [None] * world
                dist.all_gather_object(ranks, mine)
                out[name] = ranks
                if rank == 0:
                    print(f"[mesh-tp] {name}: " + json.dumps(ranks), flush=True)
                del scan, again, eager, f32
            partitions.clear()
        if rank == 0:
            os.makedirs("chiprun_out", exist_ok=True)
            with open(os.path.join("chiprun_out", "mesh_tp.json"), "w") as f:
                json.dump({"card": card, "runs": out}, f, indent=1)
            for name, ranks in out.items():
                r0 = ranks[0]
                ok = all(r["scans_bit_equal"] for r in ranks)
                worst = max(r["eager_max_train_loss_diff"] for r in ranks)
                print(f"[mesh-tp] {name}: {r0['ms']:.3f} ms/epoch (rank 0; ranks "
                      f"{[round(r['ms'], 3) for r in ranks]}), eager {r0['eager_ms']:.3f}, "
                      f"peak bytes {[r['peak'] for r in ranks]}, shards {r0['shards']}, "
                      f"collectives a replay {r0['collectives_a_replay']}, loss "
                      f"{r0['loss'][0]:.5f} -> {r0['loss'][1]:.5f}, two scans bit-equal on "
                      f"every rank: {ok}, eager within {worst:.3e} of the scan; float32 "
                      f"losses within {r0['f32_max_rel_diff_to_tp1']:.3e} of ({world}, 1)'s "
                      f"(relative; train, val nodes that changed class "
                      f"{r0['f32_acc_nodes_changed']}), bf16 "
                      f"{r0['bf16_max_rel_diff_to_tp1']:.3e} ({r0['bf16_acc_nodes_changed']})",
                      flush=True)
            print(f"[mesh-tp] nvidia-smi: {card}", flush=True)
            bad = [n for n, ranks in out.items()
                   if not all(r["scans_bit_equal"] for r in ranks)
                   or max(r["eager_max_train_loss_diff"] for r in ranks) > 1e-4
                   or max(r["f32_max_rel_diff_to_tp1"] for r in ranks) > F32_RTOL]
            if bad:
                print(f"[mesh-tp] FAILED: {bad}", flush=True)
                return 1
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
