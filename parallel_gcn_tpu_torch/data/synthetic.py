"""Synthetic datasets at the published statistics of datasets not shipped.

Port of ``parallel_gcn_tpu/data/synthetic.py``: the same numpy generator
calls in the same order, so a seed gives the same graph, features, labels
and split in both packages. ``synth-reddit`` matches reddit's node and edge
count, power-law degrees, community structure, feature and class widths and
GraphSAGE split sizes (reference report p.10 Table 2).

Generated arrays are cached under ``.synth_cache/`` (``PGCN_CACHE_DIR``
overrides it) in files prefixed ``torch_``, so a cache written by the JAX
package never stands in for this generator.
"""

from __future__ import annotations

import heapq
import os

import numpy as np

from parallel_gcn_tpu_torch.data.graph import HostCSR, normalized_adjacency_values
from parallel_gcn_tpu_torch.data.reorder import _propagate_labels, hub_excluded_edges


def _cache_dir() -> str:
    return os.environ.get(
        "PGCN_CACHE_DIR",
        os.path.join(
            os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
            ".synth_cache",
        ),
    )


SYNTHETIC_SPECS = {
    "synth-reddit": dict(
        n_nodes=232_965,
        n_edges=11_606_919,  # directed nnz, excluding self-loops
        input_dim=602,
        n_classes=41,
        n_train=153_431,
        n_val=23_831,
        feature_nnz_per_row=64,
        # weak per-class feature signal plus label noise: aggregation is
        # needed to learn, and the noise bounds the attainable accuracy
        feature_signal=0.05,
        label_noise=0.45,
    ),
    # ogbn-products scale (2.45M nodes / 124M directed edges)
    "synth-products": dict(
        n_nodes=2_449_029,
        n_edges=123_718_280,
        input_dim=100,
        n_classes=47,
        n_train=196_615,
        n_val=39_323,
        feature_nnz_per_row=32,
        n_communities=4800,
    ),
    # a ~10x smaller variant for quick iteration
    "synth-medium": dict(
        n_nodes=25_000,
        n_edges=1_200_000,
        input_dim=300,
        n_classes=16,
        n_train=16_000,
        n_val=3_000,
        feature_nnz_per_row=32,
    ),
}

# real graph + split from the reference files, synthetic features/labels
SYNTH_FEATURE_SPECS = {
    "synth-pubmed": dict(
        real_name="pubmed",
        input_dim=500,
        n_classes=3,
        feature_nnz_per_row=50,
    ),
}


def _sample_endpoints(rng, n_nodes, n_sample, structure, power, n_communities,
                      intra_frac, hubness):
    """Draw ``n_sample`` candidate undirected edges as (src, dst) arrays."""
    if structure == "uniform-zipf":
        w = np.arange(1, n_nodes + 1, dtype=np.float64) ** (-power)
        p = w / w.sum()
        src = rng.choice(n_nodes, size=n_sample, p=p).astype(np.int64)
        dst = rng.integers(0, n_nodes, size=n_sample, dtype=np.int64)
        return src, dst

    # stochastic-block-model communities with Zipf sizes
    n_communities = max(1, min(n_communities, n_nodes // 8))
    sizes_w = np.arange(1, n_communities + 1, dtype=np.float64) ** (-0.8)
    sizes = np.maximum((sizes_w / sizes_w.sum() * n_nodes).astype(np.int64), 1)
    drift = n_nodes - sizes.sum()
    if drift >= 0:
        sizes[0] += drift
    else:
        take = np.minimum(sizes - 1, -drift)
        csum = np.cumsum(take)
        k = np.searchsorted(csum, -drift)
        sizes[: k + 1] -= take[: k + 1]
        sizes[k] += csum[k] + drift
    offsets = np.zeros(n_communities + 1, dtype=np.int64)
    np.cumsum(sizes, out=offsets[1:])

    n_intra = int(n_sample * intra_frac)
    c = rng.choice(n_communities, size=n_intra, p=sizes / sizes.sum())
    src_a = offsets[c] + (rng.random(n_intra) * sizes[c]).astype(np.int64)
    dst_a = offsets[c] + (rng.random(n_intra) * sizes[c]).astype(np.int64)

    # inter-community edges concentrate on hub nodes
    n_inter = n_sample - n_intra
    src_b = rng.choice(n_nodes, size=n_inter, p=hubness).astype(np.int64)
    dst_b = rng.choice(n_nodes, size=n_inter, p=hubness).astype(np.int64)
    return np.concatenate([src_a, src_b]), np.concatenate([dst_a, dst_b])


def synthetic_csr(
    n_nodes: int,
    n_edges: int,
    seed: int = 0,
    power: float = 1.05,
    structure: str = "community",
    n_communities: int = 960,
    intra_frac: float = 0.9,
    shuffle: bool = True,
) -> HostCSR:
    """Undirected graph as a self-loop-inclusive normalized CSR; node ids are
    shuffled so the labelling carries no structure (recovering locality is
    the reorder pass's job)."""
    rng = np.random.default_rng(seed)
    target_half = n_edges // 2

    hubness = None
    if structure == "community":
        w = np.arange(1, n_nodes + 1, dtype=np.float64) ** (-power)
        hubness = w / w.sum()

    # sample → dedupe → top up until the target holds
    key = np.zeros(0, dtype=np.int64)
    n_sample = int(target_half * 1.25) + 1024
    for _ in range(8):
        src, dst = _sample_endpoints(
            rng, n_nodes, n_sample, structure, power, n_communities, intra_frac,
            hubness,
        )
        keep = src != dst
        src, dst = src[keep], dst[keep]
        lo = np.minimum(src, dst)
        hi = np.maximum(src, dst)
        key = np.unique(np.concatenate([key, lo * n_nodes + hi]))
        if key.shape[0] >= target_half:
            break
        n_sample = int((target_half - key.shape[0]) * 2.5) + 1024
    if key.shape[0] > target_half:
        key = rng.permutation(key)[:target_half]
    lo, hi = key // n_nodes, key % n_nodes

    if shuffle:
        relabel = rng.permutation(n_nodes).astype(np.int64)
        lo, hi = relabel[lo], relabel[hi]

    # symmetrize; the self-loop sorts first in every row (src/parser.cpp:29-31)
    rows = np.concatenate([np.arange(n_nodes, dtype=np.int64), lo, hi])
    cols = np.concatenate([np.arange(n_nodes, dtype=np.int64), hi, lo])
    self_first = np.zeros(rows.shape[0], dtype=np.int64)
    self_first[n_nodes:] = 1
    order = np.lexsort((cols, self_first, rows))
    rows, cols = rows[order], cols[order]

    counts = np.bincount(rows, minlength=n_nodes)
    indptr = np.zeros(n_nodes + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    indices = cols.astype(np.int32)
    values = normalized_adjacency_values(indptr, indices)
    return HostCSR(
        indptr=indptr, indices=indices, values=values, n_rows=n_nodes, n_cols=n_nodes
    )


def structure_labels(
    csr: HostCSR,
    n_classes: int,
    rng: np.random.Generator,
    n_iters: int = 8,
    label_noise: float = 0.15,
) -> np.ndarray:
    """Graph-structure-correlated class labels: hub-excluded label
    propagation → whole clusters assigned greedily to the least-loaded class
    → ``label_noise`` of nodes flipped to a uniform class."""
    n = csr.n_rows
    rows, cols, _ = hub_excluded_edges(csr, 1024)
    clusters = _propagate_labels(rows, cols, n, n_iters)

    uniq, dense_id, sizes = np.unique(
        clusters, return_inverse=True, return_counts=True
    )
    cluster_class = np.empty(len(uniq), dtype=np.int32)
    heap = [(0, c) for c in range(n_classes)]
    heapq.heapify(heap)
    for ci in np.argsort(-sizes, kind="stable"):
        load, c = heapq.heappop(heap)
        cluster_class[ci] = c
        heapq.heappush(heap, (load + int(sizes[ci]), c))
    labels = cluster_class[dense_id]

    flip = rng.random(n) < label_noise
    labels[flip] = rng.integers(0, n_classes, size=int(flip.sum()))
    return labels.astype(np.int32)


def synthetic_features(
    n_nodes: int,
    input_dim: int,
    nnz_per_row: int,
    rng: np.random.Generator,
    labels: np.ndarray | None = None,
    n_classes: int = 0,
    feature_signal: float = 0.0,
) -> tuple[HostCSR, np.ndarray]:
    """Sparse feature CSR (svmlight-like) and its dense float32 form, with
    an optional per-class centroid component ``feature_signal·centroid``."""
    nnz_per_row = min(nnz_per_row, input_dim)
    keys = rng.random((n_nodes, input_dim), dtype=np.float32)
    cols = np.argsort(keys, axis=1)[:, :nnz_per_row].astype(np.int32)
    vals = rng.standard_normal((n_nodes, nnz_per_row), dtype=np.float32)
    if labels is not None and feature_signal > 0.0:
        centroids = rng.standard_normal((n_classes, input_dim)).astype(
            np.float32
        )
        vals += feature_signal * centroids[labels[:, None], cols]
    return _features_from_cols(cols, vals, input_dim)


def _features_from_cols(cols, vals, input_dim):
    """(row-sorted CSR, dense) from per-row column ids and values."""
    n, k = cols.shape
    dense = np.zeros((n, input_dim), dtype=np.float32)
    np.put_along_axis(dense, cols.astype(np.int64), vals, axis=1)
    order = np.argsort(cols, axis=1)
    cols_sorted = np.take_along_axis(cols, order, axis=1)
    vals_sorted = np.take_along_axis(vals, order, axis=1)
    csr = HostCSR(
        indptr=np.arange(n + 1, dtype=np.int64) * k,
        indices=cols_sorted.reshape(-1),
        values=vals_sorted.reshape(-1),
        n_rows=n,
        n_cols=input_dim,
    )
    return csr, dense


# bump when the generator changes so stale caches are ignored
_CACHE_VERSION = 1


def _cache_path(name: str, seed: int) -> str:
    return os.path.join(_cache_dir(), f"torch_{name}_{seed}_v{_CACHE_VERSION}.npz")


def _cache_load(name: str, seed: int):
    """(graph, feature_csr, features, labels, split) or None."""
    path = _cache_path(name, seed)
    if not os.path.exists(path):
        return None
    with np.load(path) as z:
        n = int(z["n_rows"])
        graph = HostCSR(indptr=z["indptr"], indices=z["indices"],
                        values=z["values"], n_rows=n, n_cols=n)
        feature_csr, features = _features_from_cols(
            z["feat_cols"], z["feat_vals"], int(z["input_dim"])
        )
        return graph, feature_csr, features, z["labels"], z["split"]


def _cache_save(name, seed, graph, feature_csr, input_dim, labels, split):
    os.makedirs(_cache_dir(), exist_ok=True)
    n = feature_csr.n_rows
    k = feature_csr.nnz // n
    path = _cache_path(name, seed)
    tmp = f"{path}.{os.getpid()}.tmp.npz"
    np.savez(
        tmp,
        indptr=graph.indptr, indices=graph.indices, values=graph.values,
        n_rows=graph.n_rows,
        feat_cols=feature_csr.indices.reshape(n, k),
        feat_vals=feature_csr.values.reshape(n, k),
        input_dim=input_dim, labels=labels, split=split,
    )
    os.replace(tmp, path)


def make_synthetic_dataset(name: str, seed: int = 19990304, **overrides):
    """A ``Dataset`` for a registered synthetic spec (or explicit kwargs).
    Registered specs without overrides are cached on disk by (name, seed)."""
    from parallel_gcn_tpu_torch.data.parser import TEST, TRAIN, VAL, Dataset

    spec = dict(SYNTHETIC_SPECS.get(name, {}))
    if not spec and not overrides:
        raise KeyError(f"unknown synthetic dataset {name!r}")
    spec.update(overrides)
    n_nodes = spec["n_nodes"]
    cacheable = name in SYNTHETIC_SPECS and not overrides
    cached = _cache_load(name, seed) if cacheable else None
    if cached is not None:
        graph, feature_csr, features, labels, split = cached
    else:
        rng = np.random.default_rng(seed ^ 0x5EED)
        graph = synthetic_csr(
            n_nodes, spec["n_edges"], seed=seed,
            structure=spec.get("structure", "community"),
            n_communities=spec.get("n_communities", 960),
        )
        labels = structure_labels(
            graph, spec["n_classes"], rng,
            label_noise=spec.get("label_noise", 0.15),
        )
        feature_csr, features = synthetic_features(
            n_nodes, spec["input_dim"], spec["feature_nnz_per_row"], rng,
            labels=labels, n_classes=spec["n_classes"],
            feature_signal=spec.get("feature_signal", 0.15),
        )
        split = np.full(n_nodes, TEST, dtype=np.int32)
        perm = rng.permutation(n_nodes)
        split[perm[: spec["n_train"]]] = TRAIN
        split[perm[spec["n_train"] : spec["n_train"] + spec["n_val"]]] = VAL
        if cacheable:
            _cache_save(name, seed, graph, feature_csr, spec["input_dim"],
                        labels, split)

    return Dataset(
        name=name,
        graph=graph,
        feature_csr=feature_csr,
        features=features,
        labels=labels,
        split=split,
        n_nodes=n_nodes,
        input_dim=spec["input_dim"],
        output_dim=spec["n_classes"],
        setup={"source": "cache" if cached is not None else "generated"},
    )


def make_synth_feature_dataset(name: str, seed: int = 19990304, data_dir: str = ""):
    """Real graph and split from the reference files (``.graph``,
    ``.split``), synthetic features and labels (SYNTH_FEATURE_SPECS)."""
    from parallel_gcn_tpu_torch.data.parser import (
        Dataset,
        find_data_dir,
        parse_graph_file,
        parse_split_file,
    )

    spec = SYNTH_FEATURE_SPECS[name]
    real = spec["real_name"]
    directory = find_data_dir(real, data_dir, exts=("graph", "split"))
    graph = parse_graph_file(os.path.join(directory, f"{real}.graph"))
    split = parse_split_file(os.path.join(directory, f"{real}.split"))
    n_nodes = graph.n_rows

    rng = np.random.default_rng(seed ^ 0x5EED)
    labels = structure_labels(
        graph, spec["n_classes"], rng, label_noise=spec.get("label_noise", 0.15)
    )
    feature_csr, features = synthetic_features(
        n_nodes, spec["input_dim"], spec["feature_nnz_per_row"], rng,
        labels=labels, n_classes=spec["n_classes"],
        feature_signal=spec.get("feature_signal", 0.15),
    )
    return Dataset(
        name=name, graph=graph, feature_csr=feature_csr, features=features,
        labels=labels, split=split, n_nodes=n_nodes,
        input_dim=spec["input_dim"], output_dim=spec["n_classes"],
    )
