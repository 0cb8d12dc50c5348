"""Mesh scaling — the JAX package's ``harness/scaling.py`` over the port: the
epoch time of node-parallel training (``parallel.train_parallel.fit_parallel``)
at 1, 2, 4, ... ranks for each halo, and the scaling efficiency
(time at the first size × that size / (time × ranks)).

Each size runs as one ``torchrun`` world of that many processes, one per
GPU (NCCL) or, with ``--device cpu``, gloo processes on the CPU, which
validate the function and not the speed. In the world each halo trains
``--epochs`` epochs in ``mode=scan``; its epoch time is the scan's. The halos
are the flat COO all_gather (``backend=segment``), the ring
(``backend=segment halo=ring``) and the tile slabs (``backend=hybrid``
with the all_gather halo). The dataset is loaded once before the worlds
start, so that its cache is written once.

Usage:
    python -m parallel_gcn_tpu_torch.harness.scaling [dataset] [--epochs N]
        [--devices 1,2,4] [--device cuda|cpu] [--out-dir D]

Writes ``<out-dir>/scaling_h100.txt``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch

from parallel_gcn_tpu_torch.data.parser import load_dataset, prepare_host_dataset
from parallel_gcn_tpu_torch.device import resolve_device
from parallel_gcn_tpu_torch.harness import common

# halo -> the config overrides its runs take
HALOS = {
    "all_gather": dict(backend="segment", halo="all_gather"),
    "ring": dict(backend="segment", halo="ring"),
    "hybrid": dict(backend="hybrid", halo="all_gather"),
}
_ROW = "scaling-row "


def _worker(dataset: str, epochs: int, device: str) -> int:
    """One rank of a torchrun world: every halo's run, rank 0 printing one
    row a halo."""
    import torch.distributed as dist

    from parallel_gcn_tpu_torch.parallel.collectives import local_device
    from parallel_gcn_tpu_torch.parallel.train_parallel import fit_parallel

    dev = local_device(resolve_device(device))
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo")
    try:
        n = dist.get_world_size()
        base = common.config(dataset)
        ds = prepare_host_dataset(base, dataset)
        for halo, over in HALOS.items():
            cfg = common.config(dataset, dict(over, epochs=epochs, early_stopping=0,
                                              verbose=False, matmul_precision="default",
                                              mode="scan"))
            res = fit_parallel(cfg, ds, n_devices=n, device=dev)
            if dist.get_rank() == 0:
                print(_ROW + json.dumps({"halo": halo, "n": n,
                                         "epoch_ms": res.avg_epoch_time_s * 1e3,
                                         "test_acc": res.test_acc, **common.stamp(dev)}),
                      flush=True)
    finally:
        dist.destroy_process_group()
    return 0


def run_world(dataset: str, n: int, epochs: int, device: str, timeout: float) -> list[dict]:
    """The rows of one torchrun world of ``n`` processes."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc_per_node={n}", "-m", "parallel_gcn_tpu_torch.harness.scaling", dataset,
           "--worker", f"--epochs={epochs}", f"--device={device}"]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout,
                          env=dict(os.environ, OMP_NUM_THREADS=os.environ.get(
                              "OMP_NUM_THREADS", "1")))
    if proc.returncode != 0:
        raise RuntimeError(f"torchrun world of {n} failed ({proc.returncode}):\n"
                           f"{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
    return [json.loads(line[len(_ROW):]) for line in proc.stdout.splitlines()
            if line.startswith(_ROW)]


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("dataset", nargs="?", default="synth-medium")
    ap.add_argument("--epochs", type=int, default=20)
    ap.add_argument("--devices", default="1,2,4")
    ap.add_argument("--timeout", type=float, default=1800, help="seconds a world may take")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    common.add_common(ap)
    args = ap.parse_args(argv)
    if args.worker:
        return _worker(args.dataset, args.epochs, args.device)
    sizes = [int(s) for s in args.devices.split(",") if s]
    dev = resolve_device(args.device)
    if dev.type == "cuda" and max(sizes) > torch.cuda.device_count():
        print(f"{max(sizes)} ranks need {max(sizes)} GPUs; this machine has "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    try:
        load_dataset(args.dataset)  # generate (and cache) once, before the worlds
    except FileNotFoundError:
        common.unavailable(args.dataset)
        return 0
    rows = [r for n in sizes for r in run_world(args.dataset, n, args.epochs, args.device,
                                                 args.timeout)]
    card = common.card(dev)
    lines = [f"# {args.dataset} on {card} ({args.device}), {args.epochs} epochs a point, "
             f"mode=scan"]
    for halo in HALOS:
        base = None
        for r in (r for r in rows if r["halo"] == halo):
            base = base or r["epoch_ms"] * r["n"]
            eff = base / (r["epoch_ms"] * r["n"]) * 100
            lines.append(f"{halo:10s} n={r['n']:2d} epoch {r['epoch_ms']:8.3f} ms  "
                         f"efficiency {eff:5.1f}%  test_acc {r['test_acc']:.5f}")
            print(lines[-1])
    common.write(args.out_dir, "scaling_h100.txt", lines)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
