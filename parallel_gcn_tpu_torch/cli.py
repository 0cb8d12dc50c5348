"""CLI entry point.

Usage (mirrors the reference binary ``./exec/gcn-par <dataset> [file=...]``,
src/main.cpp:24-32, plus key=value overrides):

    python -m parallel_gcn_tpu_torch <dataset> [file=<params.txt>] [device=cuda|cpu] [resume_from=<ckpt.npz>] [key=value ...]

e.g.  python -m parallel_gcn_tpu_torch synth-reddit epochs=10
      python -m parallel_gcn_tpu_torch synth-reddit model=gat heads=2 hidden_dims=32 dropouts=0.0,0.1 epochs=10
      python -m parallel_gcn_tpu_torch synth-reddit model=sage epochs=10
      python -m parallel_gcn_tpu_torch synth-reddit model=gin gin_eps=0 epochs=10
      python -m parallel_gcn_tpu_torch synth-reddit remat=true epochs=10
      python -m parallel_gcn_tpu_torch synth-reddit model=gat backend=segment heads=2 hidden_dims=32 edge_chunk=1048576 epochs=10
      python -m parallel_gcn_tpu_torch cora device=cpu epochs=5
      python -m parallel_gcn_tpu_torch synth-reddit epochs=10 checkpoint_dir=ck checkpoint_every=5
      python -m parallel_gcn_tpu_torch synth-reddit epochs=10 resume_from=ck/ckpt_000005.npz

``checkpoint_dir=`` / ``checkpoint_every=`` write checkpoints in the JAX
package's format (``ckpt_{epoch:06d}.npz``, ``ckpt_final.npz``);
``resume_from=`` continues a run from one written by either package.

Under torchrun the CLI trains node-partitioned over the world's processes,
one per GPU (``parallel.train_parallel.fit_parallel``); ``n_devices=N``,
when given, must equal the world's size over ``tp`` (default 1), and a
mesh of more than one process needs such a world. ``tp=T`` > 1 (tensor
parallelism: the GCN, SAGE and GIN) runs N node ranks of T feat ranks each,
N·T processes (``n_devices`` defaults to the world's size over T):

      torchrun --standalone --nproc_per_node=N -m parallel_gcn_tpu_torch synth-reddit n_devices=N halo=boundary
      torchrun --standalone --nproc_per_node=2 -m parallel_gcn_tpu_torch synth-medium device=cpu n_devices=2
      torchrun --standalone --nproc_per_node=N -m parallel_gcn_tpu_torch synth-reddit n_devices=N model=sage halo=boundary
      torchrun --standalone --nproc_per_node=N -m parallel_gcn_tpu_torch synth-reddit n_devices=N backend=segment halo=ring
      torchrun --standalone --nproc_per_node=N -m parallel_gcn_tpu_torch synth-reddit n_devices=N halo=adaptive
      torchrun --standalone --nproc_per_node=4 -m parallel_gcn_tpu_torch synth-reddit n_devices=2 tp=2
      torchrun --standalone --nproc_per_node=4 -m parallel_gcn_tpu_torch synth-medium device=cpu n_devices=2 tp=2

The device defaults to cuda; the CPU runs only when asked for. Returns 2 on a
bad argument, a missing dataset or checkpoint, or ``n_devices`` / ``tp``
without their world, 1 when the device is unavailable.
"""

from __future__ import annotations

import os
import sys

import torch

from parallel_gcn_tpu_torch.config import default_params_path, load_config, parse_override
from parallel_gcn_tpu_torch.device import device_name, resolve_device


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print(__doc__)
        return 2

    dataset = argv[0]
    overrides = {}
    params_file = None
    device_arg = "cuda"
    resume_from = None
    for arg in argv[1:]:
        if "=" not in arg:
            print(f"error: malformed argument {arg!r} (expected key=value)")
            return 2
        key, val = arg.split("=", 1)
        if key == "file":
            params_file = val
        elif key == "device":
            device_arg = val
        elif key == "resume_from":
            resume_from = val
        else:
            overrides[key] = parse_override(val)

    try:
        cfg = load_config(params_file or default_params_path(dataset), overrides)
    except (KeyError, ValueError, FileNotFoundError) as e:
        print(f"error: {e}")
        return 2
    if resume_from and not os.path.isfile(resume_from):
        print(f"error: no checkpoint at {resume_from!r}")
        return 2
    world = os.environ.get("WORLD_SIZE")  # set by torchrun
    tp = cfg.tpu.tp
    mesh = cfg.tpu.n_devices > 1 or tp > 1 or world is not None
    if mesh:
        from parallel_gcn_tpu_torch.parallel.collectives import mesh_command

        size = int(world or 1)
        n = cfg.tpu.n_devices or max(size // tp, 1)
        if size != n * tp:
            grid = f"n_devices={n}" + (f" × tp={tp}" if tp > 1 else "")
            print(f"error: {grid} needs a torch.distributed world of {n * tp} "
                  f"processes, one per GPU: {mesh_command(n, tp)}")
            return 2
    try:
        device = resolve_device(device_arg)
    except ValueError as e:
        print(f"error: {e}")
        return 2
    except RuntimeError as e:
        print(f"error: {e}")
        return 1

    if mesh:
        return _main_mesh(cfg, dataset, device, resume_from)

    from parallel_gcn_tpu_torch.data.parser import prepare_device_dataset
    from parallel_gcn_tpu_torch.train import fit

    print(f"torch {torch.__version__} — device {device}: {device_name(device)}")
    print()
    print(f"PARSING {dataset} ...")
    try:
        ds, dds = prepare_device_dataset(cfg, dataset, device)
    except FileNotFoundError as e:
        print(f"error: {e}")
        return 2
    print(
        f"nodes={ds.n_nodes} edges(nnz incl self-loops)={ds.graph.nnz} "
        f"features={ds.input_dim} classes={ds.output_dim} "
        f"train/val/test={ds.train_dim}/{ds.val_dim}/{ds.test_dim}"
    )
    print("TRAINING AND EVALUATION OF GCN:")
    print(_summary(fit(cfg, dds, resume_from=resume_from)))
    return 0


def _summary(result) -> str:
    """The run's last line: epochs, the mean epoch (in scan mode on CUDA the
    replays of epochs 2..N) and the scan's set-up seconds."""
    line = (f"epochs_run={result.epochs_run} "
            f"avg_epoch_time={result.avg_epoch_time_s * 1e3:.3f} ms")
    if result.replays:
        line += f" setup={result.setup_time_s:.3f} s"
    return line


def _main_mesh(cfg, dataset: str, device: torch.device, resume_from: str | None) -> int:
    """One rank of ``n_devices``: join the torchrun world (NCCL for CUDA,
    gloo for the CPU), train with ``fit_parallel``, leave the world."""
    import torch.distributed as dist

    from parallel_gcn_tpu_torch.data.parser import prepare_host_dataset
    from parallel_gcn_tpu_torch.parallel.collectives import local_device
    from parallel_gcn_tpu_torch.parallel.train_parallel import fit_parallel

    device = local_device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo")
    try:
        rank0 = dist.get_rank() == 0
        if rank0:
            print(f"torch {torch.__version__} — {dist.get_world_size()} ranks, rank 0 on "
                  f"{device}: {device_name(device)}")
            print()
            print(f"PARSING {dataset} ...")
        try:
            ds = prepare_host_dataset(cfg, dataset)
        except FileNotFoundError as e:
            print(f"error: {e}")
            return 2
        if rank0:
            print(f"nodes={ds.n_nodes} edges(nnz incl self-loops)={ds.graph.nnz} "
                  f"features={ds.input_dim} classes={ds.output_dim} "
                  f"train/val/test={ds.train_dim}/{ds.val_dim}/{ds.test_dim}")
            print("TRAINING AND EVALUATION OF GCN:")
        result = fit_parallel(cfg, ds, device=device, resume_from=resume_from)
        if rank0:
            print(_summary(result))
        return 0
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    raise SystemExit(main())
