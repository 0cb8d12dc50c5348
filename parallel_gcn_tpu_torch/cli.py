"""CLI entry point.

Usage (mirrors the reference binary ``./exec/gcn-par <dataset> [file=...]``,
src/main.cpp:24-32, plus key=value overrides):

    python -m parallel_gcn_tpu_torch <dataset> [file=<params.txt>] [device=cuda|cpu] [key=value ...]

e.g.  python -m parallel_gcn_tpu_torch synth-reddit epochs=10
      python -m parallel_gcn_tpu_torch synth-reddit model=gat heads=2 hidden_dims=32 dropouts=0.0,0.1 epochs=10
      python -m parallel_gcn_tpu_torch cora device=cpu epochs=5

The device defaults to cuda; the CPU runs only when asked for. Returns 2 on a
bad argument or a missing dataset, 1 when the device is unavailable.
"""

from __future__ import annotations

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
    for arg in argv[1:]:
        if "=" not in arg:
            print(f"error: malformed argument {arg!r} (expected key=value)")
            return 2
        key, val = arg.split("=", 1)
        if key == "file":
            params_file = val
        elif key == "device":
            device_arg = val
        else:
            overrides[key] = parse_override(val)

    try:
        cfg = load_config(params_file or default_params_path(dataset), overrides)
    except (KeyError, ValueError, FileNotFoundError) as e:
        print(f"error: {e}")
        return 2
    try:
        device = resolve_device(device_arg)
    except ValueError as e:
        print(f"error: {e}")
        return 2
    except RuntimeError as e:
        print(f"error: {e}")
        return 1

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
    result = fit(cfg, dds)
    print(
        f"epochs_run={result.epochs_run} "
        f"avg_epoch_time={result.avg_epoch_time_s * 1e3:.3f} ms"
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
