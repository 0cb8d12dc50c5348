"""What the entries share: one CUDA device, the program's one-device data
path, and the records an entry hands back."""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class Prepared:
    """The program's set-up of a cell: what ``call`` needs (``state``), the
    set-up seconds by stage, and n, nnz, input_dim and n_classes."""

    state: object
    stages: dict
    graph: dict


@dataclass
class Called:
    """What one call of the program returned, a lane each for the lists."""

    histories: list  # a lane's [epochs_run, 4] history
    epochs_run: list
    replays: int
    epoch_s: float  # the program's host time a replay
    graph_launches: dict


def one_device(cell, require_cuda: bool) -> list:
    """CUDA device 0 where the machine has the chips the cell asks for
    (else ``SystemExit``); the CPU for tests."""
    import torch

    if not require_cuda:
        return [torch.device("cpu")]
    chips = int(cell.workload["chips"])
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < chips:
        raise SystemExit(f"portbench: {cell.name} needs {chips} CUDA device(s); this machine "
                         f"has {have}")
    return [torch.device("cuda", 0)]


def device_dataset(cell, cfg, devices) -> Prepared:
    """``data.parser.prepare_device_dataset`` on the first device: load,
    reorder, permute, pack, copy. Keeps the ``DeviceDataset`` only."""
    import gc

    from parallel_gcn_tpu_torch.data.parser import prepare_device_dataset

    ds, dds = prepare_device_dataset(cfg, cell.config["data"]["name"], devices[0])
    stages = {k: v for k, v in {**ds.setup, **dds.setup}.items() if k.endswith("_s")}
    graph = dict(n=ds.n_nodes, nnz=int(ds.graph.nnz), input_dim=ds.input_dim,
                 n_classes=ds.output_dim)
    del ds
    gc.collect()
    return Prepared(state=dds, stages=stages, graph=graph)
