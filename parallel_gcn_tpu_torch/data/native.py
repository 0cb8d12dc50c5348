"""ctypes bindings for the native loader (``csrc/loader.cpp``).

Port of ``parallel_gcn_tpu/data/native.py``: the same C interface, the same
signatures and return tuples. ``loader.cpp`` is compiled by
``g++ -O3 -std=c++17 -fPIC -fopenmp -shared`` at its first use in a process
(about a second), into ``parallel_gcn_tpu_torch/_build/`` under a name
hashed from the source and the flags, written under a temporary name and
moved into place, so concurrent processes (pytest workers, torchrun ranks)
never load a half-written library. Where the library cannot be built or
loaded (no g++, no OpenMP), every call raises ``RuntimeError`` and the
callers (``data.parser.load_dataset``, ``data.reorder._propagate_labels``)
run their numpy versions, which compute the same result; ``warn_fallback``
says so once on stderr.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys
import threading

import numpy as np

from parallel_gcn_tpu_torch.data.graph import HostCSR, coalesce_duplicate_edges

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG_DIR, "csrc", "loader.cpp")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
FLAGS = ["-O3", "-std=c++17", "-fPIC", "-fopenmp", "-shared"]

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_error: str | None = None  # why the library is unavailable, once known
_warned = False


def library_path() -> str:
    """Where the build of this source and these flags lives."""
    digest = hashlib.sha256(" ".join(FLAGS).encode())
    with open(SOURCE, "rb") as f:
        digest.update(f.read())
    return os.path.join(BUILD_DIR, f"libpgcn_loader_{digest.hexdigest()[:16]}.so")


def _build(path: str) -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    try:
        proc = subprocess.run(["g++", *FLAGS, "-o", tmp, SOURCE], capture_output=True,
                              text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed (exit {proc.returncode}): {proc.stderr[-2000:]}")
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _declare(lib: ctypes.CDLL) -> None:
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.pgcn_load.restype = p
    lib.pgcn_load.argtypes = [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int]
    lib.pgcn_status.restype = ctypes.c_int
    lib.pgcn_status.argtypes = [p]
    for name in ("pgcn_n_nodes", "pgcn_input_dim", "pgcn_output_dim", "pgcn_graph_nnz",
                 "pgcn_feat_nnz", "pgcn_split_len"):
        getattr(lib, name).restype = i64
        getattr(lib, name).argtypes = [p]
    for name, ctype in (("pgcn_graph_indptr", ctypes.c_int64),
                        ("pgcn_graph_indices", ctypes.c_int32),
                        ("pgcn_graph_values", ctypes.c_float),
                        ("pgcn_feat_indptr", ctypes.c_int64),
                        ("pgcn_feat_indices", ctypes.c_int32),
                        ("pgcn_feat_values", ctypes.c_float),
                        ("pgcn_labels", ctypes.c_int32), ("pgcn_split", ctypes.c_int32)):
        getattr(lib, name).restype = ctypes.POINTER(ctype)
        getattr(lib, name).argtypes = [p]
    lib.pgcn_free.restype = None
    lib.pgcn_free.argtypes = [p]
    ptr64 = ctypes.POINTER(ctypes.c_int64)
    lib.pgcn_community_labels.restype = None
    lib.pgcn_community_labels.argtypes = [ptr64, ptr64, i64, i64, ctypes.c_int, ptr64]


def load_library() -> ctypes.CDLL:
    """The loader's library, built on first use; raises ``RuntimeError``
    (with the reason) when it cannot be built or loaded."""
    global _lib, _error
    with _lock:
        if _lib is not None:
            return _lib
        if _error is None:
            try:
                path = library_path()
                if not os.path.exists(path):
                    _build(path)
                lib = ctypes.CDLL(path)
                _declare(lib)
                _lib = lib
                return lib
            except Exception as e:  # no g++, no OpenMP, an unloadable file
                _error = f"{type(e).__name__}: {e}"
        raise RuntimeError(f"native loader unavailable ({_error})")


def available() -> bool:
    """Whether the library builds and loads in this process (built on the
    first call)."""
    try:
        load_library()
        return True
    except RuntimeError:
        return False


def warn_fallback(what: str) -> None:
    """Say once on stderr that ``what`` runs its numpy version, and why."""
    global _warned
    if not _warned:
        _warned = True
        print(f"warning: the native loader is unavailable ({_error}); {what} runs its numpy "
              "version", file=sys.stderr)


def _copy(ptr, n: int, dtype) -> np.ndarray:
    if n == 0:
        return np.zeros(0, dtype=dtype)
    return np.ctypeslib.as_array(ptr, shape=(n,)).astype(dtype, copy=True)


def load_dataset_native(directory: str, name: str, binarize: bool):
    """(graph HostCSR, feature HostCSR, labels, split, input_dim,
    output_dim): the tuple of the JAX package's ``load_dataset_native``. The
    graph's duplicate entries are coalesced into weighted edges, and its
    ``sym_scale`` is d = deg^{-1/2} of the duplicate-inclusive degrees, as
    the numpy reader (``graph.add_self_loops_csr``) gives them."""
    lib = load_library()
    handle = lib.pgcn_load(directory.encode(), name.encode(), 1 if binarize else 0)
    if not handle:
        raise RuntimeError("pgcn_load returned NULL")
    try:
        status = lib.pgcn_status(handle)
        if status != 0:
            raise FileNotFoundError(f"native loader status {status} for {name}")
        n = lib.pgcn_n_nodes(handle)
        input_dim = lib.pgcn_input_dim(handle)
        output_dim = lib.pgcn_output_dim(handle)
        g_indptr = _copy(lib.pgcn_graph_indptr(handle), n + 1, np.int64)
        g_deg = np.diff(g_indptr).astype(np.float64)
        graph = coalesce_duplicate_edges(HostCSR(
            indptr=g_indptr,
            indices=_copy(lib.pgcn_graph_indices(handle), lib.pgcn_graph_nnz(handle), np.int32),
            values=_copy(lib.pgcn_graph_values(handle), lib.pgcn_graph_nnz(handle), np.float32),
            n_rows=int(n),
            n_cols=int(n),
            sym_scale=(1.0 / np.sqrt(np.maximum(g_deg, 1.0))).astype(np.float32),
        ))
        f_nnz = lib.pgcn_feat_nnz(handle)
        features = HostCSR(
            indptr=_copy(lib.pgcn_feat_indptr(handle), n + 1, np.int64),
            indices=_copy(lib.pgcn_feat_indices(handle), f_nnz, np.int32),
            values=_copy(lib.pgcn_feat_values(handle), f_nnz, np.float32),
            n_rows=int(n),
            n_cols=int(input_dim),
        )
        labels = _copy(lib.pgcn_labels(handle), n, np.int32)
        split = _copy(lib.pgcn_split(handle), lib.pgcn_split_len(handle), np.int32)
        return graph, features, labels, split, int(input_dim), int(output_dim)
    finally:
        lib.pgcn_free(handle)


def community_labels_native(rows: np.ndarray, cols: np.ndarray, n: int,
                            n_iters: int) -> np.ndarray:
    """``n_iters`` label-propagation sweeps over the edges (``rows`` sorted
    ascending), from labels 0..n-1: each row adopts its neighbours' most
    frequent label, ties to the larger, rows with no edges keep theirs
    (``reorder._propagate_labels_numpy``). Raises ``RuntimeError`` when the
    library is unavailable."""
    lib = load_library()
    ptr64 = ctypes.POINTER(ctypes.c_int64)
    rows64 = np.ascontiguousarray(rows, dtype=np.int64)
    cols64 = np.ascontiguousarray(cols, dtype=np.int64)
    labels = np.arange(n, dtype=np.int64)
    lib.pgcn_community_labels(rows64.ctypes.data_as(ptr64), cols64.ctypes.data_as(ptr64),
                              len(rows64), n, n_iters, labels.ctypes.data_as(ptr64))
    return labels
