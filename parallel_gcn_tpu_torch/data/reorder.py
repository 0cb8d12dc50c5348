"""Graph reordering for block-sparse locality.

Port of ``parallel_gcn_tpu/data/reorder.py`` (numpy, same orders). A GCN is
permutation-equivariant, so nodes may be relabelled before training; an order
that concentrates edges in few tiles makes the tile pack of Â dense.

Label propagation (``_propagate_labels``) runs the native sweep of
``csrc/loader.cpp`` (``data.native``, C++ and OpenMP, about 10× the numpy
sweep at reddit scale) and the numpy sweep ``_propagate_labels_numpy`` only
where the library cannot be built or loaded. Both give the same labels, the
JAX package's, so both packages produce the same community order.
"""

from __future__ import annotations

from dataclasses import replace

import numpy as np

from parallel_gcn_tpu_torch.data.graph import HostCSR


def rcm_permutation(csr: HostCSR) -> np.ndarray:
    """Pseudo reverse Cuthill-McKee: level-synchronous BFS from a
    minimum-degree seed, each frontier sorted by degree, reversed. Returns
    ``perm`` with ``perm[i]`` the old id placed at new position i."""
    n = csr.n_rows
    deg = np.diff(csr.indptr)
    visited = np.zeros(n, dtype=bool)
    order = np.empty(n, dtype=np.int64)
    pos = 0
    indptr, indices = csr.indptr, csr.indices

    remaining = np.argsort(deg, kind="stable")
    rem_idx = 0
    while pos < n:
        while rem_idx < len(remaining) and visited[remaining[rem_idx]]:
            rem_idx += 1
        seed = remaining[rem_idx]
        visited[seed] = True
        order[pos] = seed
        pos += 1
        frontier = np.array([seed], dtype=np.int64)
        while len(frontier):
            starts = indptr[frontier]
            ends = indptr[frontier + 1]
            counts = (ends - starts).astype(np.int64)
            if counts.sum() == 0:
                break
            flat = np.concatenate(
                [indices[s:e] for s, e in zip(starts, ends)]
            ).astype(np.int64)
            nxt = np.unique(flat)
            nxt = nxt[~visited[nxt]]
            if len(nxt) == 0:
                break
            nxt = nxt[np.argsort(deg[nxt], kind="stable")]
            visited[nxt] = True
            order[pos : pos + len(nxt)] = nxt
            pos += len(nxt)
            frontier = nxt
    return order[::-1].copy()


def _propagate_labels_numpy(
    rows_lp: np.ndarray, cols_lp: np.ndarray, n: int, n_iters: int
) -> np.ndarray:
    """Vectorized label propagation: each sweep, every node adopts the most
    frequent label among its neighbors (ties toward the larger label);
    rows with no edges keep their label. O(E log E) per sweep."""
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


def _propagate_labels(
    rows_lp: np.ndarray, cols_lp: np.ndarray, n: int, n_iters: int
) -> np.ndarray:
    """``_propagate_labels_numpy``'s labels, from the native sweep where its
    library is available (``rows_lp`` sorted ascending, as a CSR's row ids
    are)."""
    from parallel_gcn_tpu_torch.data import native

    if len(rows_lp):
        try:
            return native.community_labels_native(rows_lp, cols_lp, n, n_iters)
        except RuntimeError:
            native.warn_fallback("label propagation")
    return _propagate_labels_numpy(rows_lp, cols_lp, n, n_iters)


def hub_excluded_edges(
    csr: HostCSR, n_hub_max: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(rows, cols, by_deg_desc) of the CSR's edges with every edge touching
    one of the top-degree hubs removed. Hubs carry most inter-community
    edges and would broadcast a foreign label through whole communities.
    The hub count is ``min(n_hub_max, n // 64)``."""
    n = csr.n_rows
    rows = csr.row_ids().astype(np.int64)
    cols = csr.indices.astype(np.int64)
    deg = np.diff(csr.indptr).astype(np.int64)
    by_deg_desc = np.argsort(-deg, kind="stable")
    n_hub = min(n_hub_max, n // 64)
    if n_hub > 0:
        hub = np.zeros(n, dtype=bool)
        hub[by_deg_desc[:n_hub]] = True
        keep = ~(hub[rows] | hub[cols])
        rows, cols = rows[keep], cols[keep]
    return rows, cols, by_deg_desc[:max(n_hub, 0)]


def community_order(
    csr: HostCSR, n_iters: int = 8, hub_block: int = 1024
) -> np.ndarray:
    """Community-clustering node order: hubs first, then label-propagation
    communities, then degree (descending) within a community. Same contract
    as ``rcm_permutation``."""
    n = csr.n_rows
    deg = np.diff(csr.indptr).astype(np.int64)
    rows_lp, cols_lp, hubs = hub_excluded_edges(csr, hub_block)
    labels = _propagate_labels(rows_lp, cols_lp, n, n_iters)
    nonhub = np.ones(n, dtype=np.int8)
    nonhub[hubs] = 0
    return np.lexsort((-deg, labels, nonhub)).astype(np.int64)


def permute_csr(csr: HostCSR, perm: np.ndarray) -> HostCSR:
    """Relabel nodes: new node i is old node perm[i]. Edge values move with
    their edges (an exact similarity P·Â·Pᵀ)."""
    n = csr.n_rows
    inv = np.empty(n, dtype=np.int64)
    inv[perm] = np.arange(n)

    old_rows = csr.row_ids().astype(np.int64)
    new_rows = inv[old_rows]
    new_cols = inv[csr.indices.astype(np.int64)]
    order = np.lexsort((new_cols, new_rows))
    new_rows = new_rows[order]
    new_cols = new_cols[order]

    indptr = np.zeros(n + 1, dtype=np.int64)
    np.add.at(indptr, new_rows + 1, 1)
    np.cumsum(indptr, out=indptr)
    return HostCSR(
        indptr=indptr,
        indices=new_cols.astype(np.int32),
        values=csr.values[order],
        n_rows=n,
        n_cols=csr.n_cols,
        sym_scale=None if csr.sym_scale is None else csr.sym_scale[perm],
    )


def permute_dataset(ds, perm: np.ndarray):
    """Apply a node permutation to a whole Dataset (features, labels and
    split move with their nodes)."""
    return replace(
        ds,
        graph=permute_csr(ds.graph, perm),
        features=ds.features[perm],
        labels=ds.labels[perm],
        split=ds.split[perm],
        feature_csr=None,
    )
