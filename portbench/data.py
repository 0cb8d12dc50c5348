"""The benchmark's inputs: a statistics-matched graph, written once in the
reference trainer's file format.

A frozen numpy copy of the port's synthetic generator (the ``synth-reddit``
spec of ``parallel_gcn_tpu_torch/data/synthetic.py``: the same numpy calls in
the same order, so a data seed gives the same graph, features, labels and
split) and of its community reorder with the numpy label sweep
(``data/reorder.py``). The copy is kept here so that a change to the program
cannot change the yardstick's inputs.

``ensure(config)`` writes, once per checkout, ``<name>.graph``,
``<name>.svmlight`` and ``<name>.split`` (what the program's loader reads, as
a user with the real files would) and ``reference.npz`` (the same arrays and
the community order, which only the plain reference reads) into a cache
directory inside ``portbench/``. Later runs read them.
"""

from __future__ import annotations

import hashlib
import heapq
import json
import os
import time

import numpy as np

PORTBENCH_DIR = os.path.dirname(os.path.abspath(__file__))
CACHE_DIR = os.path.join(PORTBENCH_DIR, ".cache")

TRAIN, VAL, TEST = 1, 2, 3
# bump when the generator, the writer or the files change
FORMAT_VERSION = 1


# ---- the generator (frozen copy of data/synthetic.py) ----

def _sample_endpoints(rng, n_nodes, n_sample, n_communities, intra_frac, hubness):
    """``n_sample`` candidate undirected edges (src, dst): stochastic-block
    communities with Zipf sizes, inter-community edges on hub nodes."""
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

    n_inter = n_sample - n_intra
    src_b = rng.choice(n_nodes, size=n_inter, p=hubness).astype(np.int64)
    dst_b = rng.choice(n_nodes, size=n_inter, p=hubness).astype(np.int64)
    return np.concatenate([src_a, src_b]), np.concatenate([dst_a, dst_b])


def synthetic_csr(n_nodes: int, n_edges: int, seed: int, power: float = 1.05,
                  n_communities: int = 960, intra_frac: float = 0.9):
    """(indptr int64, indices int32) of an undirected community graph with
    the self-loop first in every row, node ids shuffled."""
    rng = np.random.default_rng(seed)
    target_half = n_edges // 2
    w = np.arange(1, n_nodes + 1, dtype=np.float64) ** (-power)
    hubness = w / w.sum()

    key = np.zeros(0, dtype=np.int64)
    n_sample = int(target_half * 1.25) + 1024
    for _ in range(8):
        src, dst = _sample_endpoints(rng, n_nodes, n_sample, n_communities, intra_frac,
                                     hubness)
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

    relabel = rng.permutation(n_nodes).astype(np.int64)
    lo, hi = relabel[lo], relabel[hi]

    rows = np.concatenate([np.arange(n_nodes, dtype=np.int64), lo, hi])
    cols = np.concatenate([np.arange(n_nodes, dtype=np.int64), hi, lo])
    self_first = np.zeros(rows.shape[0], dtype=np.int64)
    self_first[n_nodes:] = 1
    order = np.lexsort((cols, self_first, rows))
    rows, cols = rows[order], cols[order]

    indptr = np.zeros(n_nodes + 1, dtype=np.int64)
    np.cumsum(np.bincount(rows, minlength=n_nodes), out=indptr[1:])
    return indptr, cols.astype(np.int32)


def propagate_labels(rows_lp: np.ndarray, cols_lp: np.ndarray, n: int,
                     n_iters: int) -> np.ndarray:
    """Label propagation: each sweep every node adopts the most frequent
    label among its neighbours (ties toward the larger label); rows with no
    edges keep their label."""
    labels = np.arange(n, dtype=np.int64)
    for _ in range(n_iters):
        key = rows_lp * n + labels[cols_lp]
        uk, counts = np.unique(key, return_counts=True)
        r = uk // n
        lab = uk % n
        order = np.lexsort((lab, counts, r))
        last = np.searchsorted(r[order], np.arange(n), side="right") - 1
        first = np.searchsorted(r[order], np.arange(n), side="left")
        present = first <= last
        new_labels = labels.copy()
        new_labels[present] = lab[order][last[present]]
        labels = new_labels
    return labels


def hub_excluded_edges(indptr: np.ndarray, indices: np.ndarray, n_hub_max: int):
    """(rows, cols, hubs): the edges with every edge touching one of the
    ``min(n_hub_max, n // 64)`` highest-degree nodes removed, and those hubs."""
    n = len(indptr) - 1
    deg = np.diff(indptr).astype(np.int64)
    rows = np.repeat(np.arange(n, dtype=np.int64), deg)
    cols = indices.astype(np.int64)
    by_deg_desc = np.argsort(-deg, kind="stable")
    n_hub = min(n_hub_max, n // 64)
    if n_hub > 0:
        hub = np.zeros(n, dtype=bool)
        hub[by_deg_desc[:n_hub]] = True
        keep = ~(hub[rows] | hub[cols])
        rows, cols = rows[keep], cols[keep]
    return rows, cols, by_deg_desc[:max(n_hub, 0)]


def structure_labels(indptr, indices, n_classes, rng, n_iters=8, label_noise=0.15):
    """Class labels that follow the graph's clusters, ``label_noise`` of the
    nodes flipped to a uniform class."""
    n = len(indptr) - 1
    rows, cols, _ = hub_excluded_edges(indptr, indices, 1024)
    clusters = propagate_labels(rows, cols, n, n_iters)
    uniq, dense_id, sizes = np.unique(clusters, return_inverse=True, return_counts=True)
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


def synthetic_features(n_nodes, input_dim, nnz_per_row, rng, labels, n_classes,
                       feature_signal):
    """(cols int32 [n, k], vals float32 [n, k]) of each row's nonzero
    features, columns ascending within a row."""
    nnz_per_row = min(nnz_per_row, input_dim)
    keys = rng.random((n_nodes, input_dim), dtype=np.float32)
    cols = np.argsort(keys, axis=1)[:, :nnz_per_row].astype(np.int32)
    vals = rng.standard_normal((n_nodes, nnz_per_row), dtype=np.float32)
    if feature_signal > 0.0:
        centroids = rng.standard_normal((n_classes, input_dim)).astype(np.float32)
        vals += feature_signal * centroids[labels[:, None], cols]
    order = np.argsort(cols, axis=1)
    return np.take_along_axis(cols, order, axis=1), np.take_along_axis(vals, order, axis=1)


def generate(spec: dict, seed: int) -> dict:
    """The dataset of ``spec`` (a ``synth-*`` spec's numbers) from ``seed``:
    graph CSR (self-loop first), features, labels, split."""
    n = spec["n_nodes"]
    rng = np.random.default_rng(seed ^ 0x5EED)
    indptr, indices = synthetic_csr(n, spec["n_edges"], seed=seed,
                                    n_communities=spec.get("n_communities", 960))
    labels = structure_labels(indptr, indices, spec["n_classes"], rng,
                              label_noise=spec.get("label_noise", 0.15))
    feat_cols, feat_vals = synthetic_features(
        n, spec["input_dim"], spec["feature_nnz_per_row"], rng, labels, spec["n_classes"],
        spec.get("feature_signal", 0.15))
    split = np.full(n, TEST, dtype=np.int32)
    perm = rng.permutation(n)
    split[perm[: spec["n_train"]]] = TRAIN
    split[perm[spec["n_train"]: spec["n_train"] + spec["n_val"]]] = VAL
    return dict(indptr=indptr, indices=indices, feat_cols=feat_cols, feat_vals=feat_vals,
                labels=labels, split=split)


def community_order(indptr: np.ndarray, indices: np.ndarray, n_iters: int = 8,
                    hub_block: int = 1024) -> np.ndarray:
    """The program's ``reorder=community`` node order (frozen copy of
    ``data/reorder.community_order``): hubs first, then label-propagation
    communities, degree descending within one. ``order[i]`` is the node
    placed at position i."""
    n = len(indptr) - 1
    deg = np.diff(indptr).astype(np.int64)
    rows_lp, cols_lp, hubs = hub_excluded_edges(indptr, indices, hub_block)
    labels = propagate_labels(rows_lp, cols_lp, n, n_iters)
    nonhub = np.ones(n, dtype=np.int8)
    nonhub[hubs] = 0
    return np.lexsort((-deg, labels, nonhub)).astype(np.int64)


# ---- the files ----

def write_reference_files(directory: str, name: str, d: dict) -> None:
    """``<name>.graph`` (each node's neighbours, the self-loop left out: the
    reader adds it), ``<name>.svmlight`` (label, then ``col:value`` with
    values printed to float32's 9 significant digits, which read back
    exactly) and ``<name>.split``."""
    indptr, indices = d["indptr"], d["indices"]
    n = len(indptr) - 1
    rows = np.repeat(np.arange(n), np.diff(indptr))
    nbrs = np.split(np.where(rows == indices, -1, indices), indptr[1:-1])
    with open(os.path.join(directory, f"{name}.graph"), "w") as f:
        f.write("\n".join(" ".join(map(str, a[a >= 0].tolist())) for a in nbrs))
        f.write("\n")
    cols, vals = d["feat_cols"], d["feat_vals"]
    with open(os.path.join(directory, f"{name}.svmlight"), "w") as f:
        for lab, cs, vs in zip(d["labels"].tolist(), cols.tolist(), vals.tolist()):
            f.write(f"{lab} " + " ".join(f"{c}:{v:.9g}" for c, v in zip(cs, vs)) + "\n")
    with open(os.path.join(directory, f"{name}.split"), "w") as f:
        f.write("\n".join(map(str, d["split"].tolist())))
        f.write("\n")


def cache_dir(data: dict) -> str:
    """The directory of ``data`` (a configuration's ``data`` group), named
    from its contents: the same spec and seed always land in one place."""
    key = json.dumps({**data, "format": FORMAT_VERSION}, sort_keys=True)
    digest = hashlib.sha256(key.encode()).hexdigest()[:12]
    return os.path.join(CACHE_DIR, f"{data['name']}-{data['seed']}-{digest}")


def ensure(data: dict, log=None) -> str:
    """The cache directory of ``data``, generated and written first where a
    complete one is missing (the first run of a checkout). Returns its path."""
    path = cache_dir(data)
    done = os.path.join(path, "complete")
    if os.path.exists(done):
        return path
    t0 = time.perf_counter()
    tmp = f"{path}.partial"
    os.makedirs(tmp, exist_ok=True)
    d = generate(data["spec"], data["seed"])
    order = community_order(d["indptr"], d["indices"], hub_block=data.get("hub_block", 1024))
    write_reference_files(tmp, data["name"], d)
    np.savez(os.path.join(tmp, "reference.npz"), order=order, **d)
    if os.path.exists(path):
        import shutil

        shutil.rmtree(path)
    os.replace(tmp, path)
    with open(done, "w") as f:
        f.write(f"{time.perf_counter() - t0:.3f}\n")
    if log is not None:
        log(f"data: generated {data['name']} (seed {data['seed']}) in "
            f"{time.perf_counter() - t0:.1f} s into {path}")
    return path


def load_reference_arrays(path: str) -> dict:
    """``reference.npz`` of a cache directory as a dict of arrays."""
    with np.load(os.path.join(path, "reference.npz")) as z:
        return {k: z[k] for k in z.files}
