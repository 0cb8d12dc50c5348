"""Dataset readers and the device dataset.

Port of ``parallel_gcn_tpu/data/parser.py``. Same on-disk format as the
reference (src/parser.cpp):
  <name>.graph     one line per node: space-separated neighbor ids (an
                   implicit self-loop is prepended to every row)
  <name>.svmlight  one line per node: "<label> <feat_id>:<feat_val> ..."
  <name>.split     one integer per node: 1=train 2=val 3=test

The readers are numpy; ``to_device`` writes torch tensors on a given device.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np
import torch

from parallel_gcn_tpu_torch.data.graph import (
    Graph,
    HostCSR,
    add_self_loops_csr,
    build_graph,
    pad_to_multiple,
)
from parallel_gcn_tpu_torch.utils.timer import span

TRAIN, VAL, TEST = 1, 2, 3


def _data_dir_candidates() -> tuple[str, ...]:
    repo = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    return (
        os.environ.get("PGCN_DATA_DIR", ""),
        "data",
        os.path.join(repo, "data"),
    )


def find_data_dir(
    dataset: str, data_dir: str = "", exts=("graph", "svmlight", "split")
) -> str:
    candidates = [data_dir] if data_dir else list(_data_dir_candidates())
    for cand in candidates:
        if cand and all(
            os.path.exists(os.path.join(cand, f"{dataset}.{ext}"))
            for ext in exts
        ):
            return cand
    raise FileNotFoundError(
        f"dataset {dataset!r} not found (need {exts}); searched {candidates}. "
        "Set PGCN_DATA_DIR or pass data_dir."
    )


@dataclass
class Dataset:
    """Host-side dataset (reference GCNData, include/gcn.cuh:53-60)."""

    name: str
    graph: HostCSR  # normalized adjacency Â, self-loop inclusive
    feature_csr: HostCSR | None  # sparse features (None after a permutation)
    features: np.ndarray  # dense float32 [n_nodes, input_dim]
    labels: np.ndarray  # int32 [n_nodes]
    split: np.ndarray  # int32 [n_nodes] of {1,2,3}
    n_nodes: int
    input_dim: int
    output_dim: int
    # set-up record: seconds by stage ("load_s", "reorder_s", "permute_s"),
    # where the data came from ("source") and the label sweep that ran
    setup: dict = field(default_factory=dict)

    @property
    def train_dim(self) -> int:
        return int((self.split == TRAIN).sum())

    @property
    def val_dim(self) -> int:
        return int((self.split == VAL).sum())

    @property
    def test_dim(self) -> int:
        return int((self.split == TEST).sum())


def parse_graph_file(path: str) -> HostCSR:
    """Adjacency list → CSR with implicit self-loops and Â values."""
    neighbor_lists = []
    with open(path) as f:
        for line in f:
            neighbor_lists.append(np.array(line.split(), dtype=np.int32))
    return add_self_loops_csr(neighbor_lists)


def parse_svmlight_file(
    path: str, binarize: bool = False
) -> tuple[HostCSR, np.ndarray, int, int]:
    """Labels and the sparse feature CSR. ``binarize`` mirrors -DNO_FEATURE
    (src/parser.cpp:100-104): every feature value becomes 1.0."""
    labels: list[int] = []
    indptr: list[int] = [0]
    idx_chunks: list[np.ndarray] = []
    val_chunks: list[np.ndarray] = []
    max_idx = 0
    max_label = 0
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                labels.append(-1)
                indptr.append(indptr[-1])
                continue
            label = int(parts[0])
            labels.append(label)
            max_label = max(max_label, label)
            if len(parts) > 1:
                kv = np.array([p.split(":") for p in parts[1:]])
                idx = kv[:, 0].astype(np.int32)
                val = kv[:, 1].astype(np.float32)
                idx_chunks.append(idx)
                val_chunks.append(val)
                max_idx = max(max_idx, int(idx.max()))
                indptr.append(indptr[-1] + len(idx))
            else:
                indptr.append(indptr[-1])

    indices = (
        np.concatenate(idx_chunks) if idx_chunks else np.zeros(0, dtype=np.int32)
    )
    values = (
        np.concatenate(val_chunks) if val_chunks else np.zeros(0, dtype=np.float32)
    )
    if binarize:
        values = np.ones_like(values)
    input_dim = max_idx + 1
    output_dim = max_label + 1
    csr = HostCSR(
        indptr=np.asarray(indptr, dtype=np.int64),
        indices=indices,
        values=values,
        n_rows=len(labels),
        n_cols=input_dim,
    )
    return csr, np.asarray(labels, dtype=np.int32), input_dim, output_dim


def parse_split_file(path: str) -> np.ndarray:
    return np.loadtxt(path, dtype=np.int32).reshape(-1)


def _native_tuple(directory: str, name: str, binarize: bool):
    """``native.load_dataset_native``'s tuple, or None where the library is
    unavailable (said once on stderr)."""
    from parallel_gcn_tpu_torch.data import native

    try:
        return native.load_dataset_native(directory, name, binarize)
    except RuntimeError:
        native.warn_fallback("the dataset reader")
        return None


def load_dataset(
    name: str, data_dir: str = "", binarize_features: bool = False, use_native: bool = True,
    spec: dict | None = None,
) -> Dataset:
    """A reference-format dataset (cora, citeseer, ...) read from disk, or a
    registered synthetic one (synth-reddit, ...) generated from its seed;
    ``spec`` overrides the synthetic spec's sizes (``make_synthetic_dataset``,
    never cached). ``use_native`` reads the files with the native loader
    (``data.native``) where it builds, else with the numpy readers; both give
    the same dataset."""
    from parallel_gcn_tpu_torch.data.synthetic import (
        SYNTH_FEATURE_SPECS,
        SYNTHETIC_SPECS,
        make_synth_feature_dataset,
        make_synthetic_dataset,
    )

    if name in SYNTHETIC_SPECS or spec:
        return make_synthetic_dataset(name, **(spec or {}))
    if name in SYNTH_FEATURE_SPECS:
        return make_synth_feature_dataset(name, data_dir=data_dir)

    directory = find_data_dir(name, data_dir)
    loaded = _native_tuple(directory, name, binarize_features) if use_native else None
    if loaded is not None:
        graph, feature_csr, labels, split, input_dim, output_dim = loaded
    else:
        graph = parse_graph_file(os.path.join(directory, f"{name}.graph"))
        feature_csr, labels, input_dim, output_dim = parse_svmlight_file(
            os.path.join(directory, f"{name}.svmlight"), binarize=binarize_features
        )
        split = parse_split_file(os.path.join(directory, f"{name}.split"))
    return Dataset(
        name=name,
        graph=graph,
        feature_csr=feature_csr,
        features=feature_csr.to_dense(),
        labels=labels,
        split=split,
        n_nodes=graph.n_rows,
        input_dim=input_dim,
        output_dim=output_dim,
    )


@dataclass
class DeviceDataset:
    """Padded device tensors. Padded nodes carry label -1 and split 0, so
    loss and accuracy never see them."""

    graph: Graph
    x: torch.Tensor  # float32 [n_pad, input_dim] (Â·X after input pre-aggregation)
    labels: torch.Tensor  # int64 [n_pad], -1 on padding
    split: torch.Tensor  # int32 [n_pad], 0 on padding
    n_real_nodes: int
    input_dim: int
    output_dim: int
    split_counts: dict  # {1: train_dim, 2: val_dim, 3: test_dim}
    # Â·X for eval forwards when the training input dropout is nonzero
    # (train.preaggregate_input); None until then
    x_agg: torch.Tensor | None = None
    # seconds of the host pack ("pack_s") and of the copy to the device
    # with the residual's segments ("copy_s")
    setup: dict = field(default_factory=dict)

    @property
    def device(self) -> torch.device:
        return self.x.device


def to_device(
    ds: Dataset,
    *,
    device: torch.device,
    node_pad: int = 8,
    dense: bool = False,
    bcsr: bool = False,
    hybrid: bool = False,
    n_nodes_pad: int | None = None,
    tile_dtype="float32",
    tile_size: int = 128,
    tile_cols: int = 0,
    tile_budget_mb: int = 3072,
    min_tile_nnz: int = 0,
    adj_dtype="float32",
) -> DeviceDataset:
    if bcsr or hybrid:
        node_pad = max(node_pad, tile_cols or tile_size)
    n_pad = n_nodes_pad or pad_to_multiple(ds.n_nodes, node_pad)
    setup: dict = {}
    graph = build_graph(
        ds.graph, device=device, node_pad=node_pad, dense=dense, bcsr=bcsr,
        hybrid=hybrid, n_nodes_pad=n_pad, tile_dtype=tile_dtype,
        tile_size=tile_size, tile_cols=tile_cols, adj_dtype=adj_dtype,
        tile_budget_bytes=tile_budget_mb * 1024 * 1024,
        min_tile_nnz=min_tile_nnz or None, times=setup,
    )
    with span("data.copy") as copied:
        dds = _device_dataset(ds, graph, n_pad, device, setup)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    setup["copy_s"] += copied.seconds
    return dds


def _device_dataset(ds: Dataset, graph: Graph, n_pad: int, device: torch.device,
                    setup: dict) -> DeviceDataset:
    """``to_device``'s features, labels and split, padded to ``n_pad`` rows
    and copied to ``device``, around ``graph``."""
    x = np.zeros((n_pad, ds.input_dim), dtype=np.float32)
    x[: ds.n_nodes] = ds.features
    labels = np.full(n_pad, -1, dtype=np.int64)
    labels[: ds.n_nodes] = ds.labels
    split = np.zeros(n_pad, dtype=np.int32)
    split[: ds.n_nodes] = ds.split

    return DeviceDataset(
        graph=graph,
        x=torch.from_numpy(x).to(device),
        labels=torch.from_numpy(labels).to(device),
        split=torch.from_numpy(split).to(device),
        n_real_nodes=ds.n_nodes,
        input_dim=ds.input_dim,
        output_dim=ds.output_dim,
        split_counts={s: int((ds.split == s).sum()) for s in (TRAIN, VAL, TEST)},
        setup=setup,
    )


def prepare_host_dataset(cfg, name: str, spec: dict | None = None) -> Dataset:
    """Load and (optionally) reorder: the host half of data preparation;
    ``spec`` overrides a synthetic spec's sizes (``load_dataset``). ``setup``
    of the result holds each stage's seconds (the spans ``pgcn::data.load``,
    ``data.reorder``, ``data.permute``) and, where this call ran a
    label sweep (generation, community reorder), which one: ``native`` where
    its library loads, else ``numpy``."""
    from parallel_gcn_tpu_torch.data import native, reorder

    with span("data.load") as loaded:
        ds = load_dataset(
            name, cfg.data.data_dir, binarize_features=cfg.data.binarize_features, spec=spec
        )
    setup = {**ds.setup, "load_s": loaded.seconds}
    if cfg.tpu.reorder != "none":
        with span("data.reorder") as reordered:
            if cfg.tpu.reorder == "community":
                order = reorder.community_order(ds.graph, hub_block=cfg.tpu.reorder_hub_block)
            else:
                order = reorder.rcm_permutation(ds.graph)
        setup["reorder_s"] = reordered.seconds
        with span("data.permute") as permuted:
            ds = reorder.permute_dataset(ds, order)
        setup["permute_s"] = permuted.seconds
    if cfg.tpu.reorder == "community" or setup.get("source") == "generated":
        setup["labels"] = "native" if native.available() else "numpy"
    ds.setup = setup
    return ds


def peak_rss_bytes() -> int:
    """This process's peak resident set size (``getrusage``; Linux reports
    kilobytes)."""
    import resource

    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


def describe_setup(ds: Dataset, dds: DeviceDataset) -> str:
    """The ``[setup]`` line: each host stage's seconds (load or generation,
    reorder, permute, pack, copy to the device), the label sweep that ran,
    the peak host RSS, and the tile / residual split of the graph's entries
    (self-loops included)."""
    st = {**ds.setup, **dds.setup}
    stages = ", ".join(f"{k[:-2]} {st[k]:.1f} s" for k in
                       ("load_s", "reorder_s", "permute_s", "pack_s", "copy_s") if k in st)
    line = (f"[setup] {stages} ({st.get('source', 'read')}, labels={st.get('labels', 'none')}); "
            f"peak host RSS {peak_rss_bytes() / 2**30:.2f} GiB")
    g = dds.graph
    if g.bcsr is not None:
        pack = g.bcsr
        resid = int((g.val != 0).sum()) if g.is_hybrid else 0
        line += (f"; {pack.n_tiles_real} tiles {pack.tile_r}x{pack.tile_c} "
                 f"{str(pack.tiles.dtype).removeprefix('torch.')} "
                 f"({pack.tiles.numel() * pack.tiles.element_size() / 2**30:.2f} GiB), "
                 f"residual {resid} entries, {1 - resid / max(g.n_real_edges, 1):.1%} of "
                 f"{g.n_real_edges} in tiles")
    return line


def prepare_device_dataset(
    cfg, name: str, device: torch.device, host: Dataset | None = None
) -> tuple[Dataset, DeviceDataset]:
    """Load → (optionally) reorder → device layout on ``device``, driven by
    one Config; ``host``, when given, is ``prepare_host_dataset``'s result
    for ``cfg`` (a sweep over layouts loads and reorders once)."""
    ds = prepare_host_dataset(cfg, name) if host is None else host
    cfg.tpu.__post_init__()
    backend = cfg.tpu.backend
    dense = backend == "dense" or (
        backend == "auto" and ds.n_nodes <= cfg.tpu.dense_threshold
    )
    tile_dtype = cfg.tpu.tile_dtype
    if tile_dtype == "auto":
        tile_dtype = (
            "float32" if cfg.tpu.matmul_precision == "highest" else "bfloat16"
        )
    adj_dtype = cfg.tpu.adj_dtype
    if adj_dtype == "auto":
        adj_dtype = (
            "float32" if cfg.tpu.matmul_precision == "highest" else "bfloat16"
        )
    dds = to_device(
        ds,
        device=device,
        node_pad=cfg.tpu.node_pad,
        dense=dense,
        bcsr=backend == "bcsr",
        hybrid=backend == "hybrid",
        tile_dtype=tile_dtype,
        adj_dtype=adj_dtype,
        tile_size=cfg.tpu.tile_size,
        tile_cols=cfg.tpu.tile_cols,
        tile_budget_mb=cfg.tpu.tile_budget_mb,
        min_tile_nnz=cfg.tpu.min_tile_nnz,
    )
    return ds, dds
