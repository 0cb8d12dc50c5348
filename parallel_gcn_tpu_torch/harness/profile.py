"""Profile one training epoch — the JAX package's ``harness/profile.py`` over
the port (the analog of the reference's ``nsys profile`` workflow): the
device time by op of an eager epoch or of the whole-run path's replayed
epoch (``utils.profiling``), by category and op, with the device's idle
share and the check that the trace holds every launch.

Usage:
    python -m parallel_gcn_tpu_torch.harness.profile <dataset> [--mode eager|scan]
        [--top N] [--scan-epochs N] [--set key=value ...] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import time

import torch

from parallel_gcn_tpu_torch.data.parser import prepare_device_dataset
from parallel_gcn_tpu_torch.device import resolve_device
from parallel_gcn_tpu_torch.harness import common
from parallel_gcn_tpu_torch.models.gat import GATModel
from parallel_gcn_tpu_torch.models.gcn import GCNModel
from parallel_gcn_tpu_torch.optim import init_adam
from parallel_gcn_tpu_torch.train import (build_model, epoch_seeds, make_epoch_step,
                                          make_scan_loop, preaggregate_input)
from parallel_gcn_tpu_torch.utils.profiling import print_trace_summary, profile_fn, report

REPS = 3


def profile(dataset: str, mode: str, scan_epochs: int, over: dict, device: str, top: int):
    dev = resolve_device(device)
    cfg = common.config(dataset, {"verbose": False, "matmul_precision": "default", **over})
    cfg.gcn.epochs, cfg.gcn.early_stopping = scan_epochs, 0
    _, dds = prepare_device_dataset(cfg, dataset, dev)
    model = build_model(cfg, dds)
    if cfg.tpu.input_preagg and isinstance(model, GCNModel):
        dds = preaggregate_input(model, dds)
    opt = init_adam(list(model.weights))
    gen = torch.Generator().manual_seed(cfg.tpu.seed)
    label = f"{dataset} {cfg.gcn.model} (backend={model.backend}), mode={mode}, {REPS} epochs"
    if mode == "scan":
        # epoch 1 and the capture, 2 warm-up replays, REPS timed, the
        # profiler's warm-up and REPS traced
        if scan_epochs < 4 + 2 * REPS:
            raise ValueError(f"--scan-epochs must be at least {4 + 2 * REPS}")
        loop = make_scan_loop(model, cfg, dds, opt, gen)
        loop.prepare()
        for _ in range(2):
            loop.epoch()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(REPS):
            loop.epoch()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3 / REPS
        _, prof = profile_fn(loop.epoch, reps=REPS, device=dev,
                             per_step=loop.graph_launches if loop.graph is not None else None)
        label += " (replays; host clock of unprofiled replays)"
    else:
        step = make_epoch_step(model, cfg, dds)
        attention = isinstance(model, GATModel)
        _, prof = profile_fn(
            lambda: step(opt, epoch_seeds(gen, model.n_layers, attention)).tolist(),
            reps=REPS, warmup=2, device=dev)
        host_ms = None
    report(label, prof, host_ms, top=top)
    print(f"# the {top} longest ops over the {REPS} epochs:")
    print_trace_summary(prof, top)
    return prof


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("dataset")
    ap.add_argument("--mode", choices=["eager", "scan"], default="eager")
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--scan-epochs", type=int, default=10)
    ap.add_argument("--set", nargs="*", default=[], metavar="KEY=VALUE")
    common.add_common(ap)
    args = ap.parse_args(argv)
    try:
        profile(args.dataset, args.mode, args.scan_epochs, common.overrides(args.set),
                args.device, args.top)
    except FileNotFoundError:
        common.unavailable(args.dataset)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
