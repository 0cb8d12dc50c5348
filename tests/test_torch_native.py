"""The port's native loader (``parallel_gcn_tpu_torch/data/native.py`` over
``csrc/loader.cpp``) against its numpy versions and the JAX package.

Label propagation: the native sweep gives the numpy sweep's labels and the
JAX package's, bit for bit (ties to the larger label, rows with no edges
keep theirs), so the community order and the generated datasets' labels do
not depend on which sweep ran. The reader: ``load_dataset_native`` gives
the numpy reader's dataset and JAX's ``load_dataset(use_native=False)`` on
reference-format files written under ``tmp_path``. The build: a hashed
name under ``_build/``, written atomically, so concurrent builds both load.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import parallel_gcn_tpu.data.parser as jparser
import parallel_gcn_tpu.data.reorder as jreorder
from parallel_gcn_tpu_torch.data import native, parser, reorder, synthetic
from parallel_gcn_tpu_torch.data.graph import random_graph

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def numpy_only(monkeypatch):
    """The library unavailable: every native call raises as a failed build
    does."""
    def unavailable(*_a, **_k):
        raise RuntimeError("native loader unavailable (forced)")

    monkeypatch.setattr(native, "load_library", unavailable)
    monkeypatch.setattr(native, "_warned", False)


def _edges(kind: str, seed: int):
    """Row-sorted (rows, cols, n) of a random graph or a community graph,
    with every edge of some rows removed (rows with no edges)."""
    if kind == "random":
        csr, _ = random_graph(600, 6, seed=seed)
    else:
        csr = synthetic.synthetic_csr(1500, 30000, seed=seed, n_communities=12)
    rows = csr.row_ids().astype(np.int64)
    cols = csr.indices.astype(np.int64)
    keep = ~np.isin(rows, np.arange(0, csr.n_rows, 9)) & ((rows * 131 + cols * 17) % 7 != 0)
    return rows[keep], cols[keep], csr.n_rows


@pytest.mark.parametrize("iters", [1, 2, 4, 8])
@pytest.mark.parametrize("kind", ["random", "community"])
def test_native_labels_equal_both_numpy_sweeps(kind, iters):
    rows, cols, n = _edges(kind, seed=iters)
    got = native.community_labels_native(rows, cols, n, iters)
    np.testing.assert_array_equal(got, reorder._propagate_labels_numpy(rows, cols, n, iters))
    np.testing.assert_array_equal(got, jreorder._propagate_labels_numpy(rows, cols, n, iters))
    empty = np.setdiff1d(np.arange(n), rows)
    assert len(empty) and (got[empty] == empty).all()  # rows with no edges keep theirs


def test_ties_go_to_the_larger_label():
    # row 0 sees labels 1 and 2 once each; row 3 sees 0, 1, 1, 2
    rows = np.array([0, 0, 3, 3, 3, 3], np.int64)
    cols = np.array([1, 2, 0, 1, 1, 2], np.int64)
    got = native.community_labels_native(rows, cols, 4, 1)
    np.testing.assert_array_equal(got, [2, 1, 2, 1])
    np.testing.assert_array_equal(got, reorder._propagate_labels_numpy(rows, cols, 4, 1))


def test_propagate_labels_records_the_sweep_and_falls_back(monkeypatch, capsys):
    rows, cols, n = _edges("community", seed=3)
    ref = reorder._propagate_labels_numpy(rows, cols, n, 8)
    np.testing.assert_array_equal(reorder._propagate_labels(rows, cols, n, 8), ref)
    assert native.available()

    def unavailable(*_a, **_k):
        raise RuntimeError("native loader unavailable (forced)")

    monkeypatch.setattr(native, "load_library", unavailable)
    monkeypatch.setattr(native, "_warned", False)
    for _ in range(2):
        np.testing.assert_array_equal(reorder._propagate_labels(rows, cols, n, 8), ref)
    assert not native.available()
    err = capsys.readouterr().err
    assert err.count("warning: the native loader is unavailable") == 1, err


def test_community_order_and_structure_labels_do_not_depend_on_the_sweep(monkeypatch):
    csr = synthetic.synthetic_csr(3000, 60000, seed=5, n_communities=20)
    order = reorder.community_order(csr, hub_block=16)
    labels = synthetic.structure_labels(csr, 7, np.random.default_rng(1))
    np.testing.assert_array_equal(order, jreorder.community_order(csr, hub_block=16))

    def unavailable(*_a, **_k):
        raise RuntimeError("native loader unavailable (forced)")

    monkeypatch.setattr(native, "load_library", unavailable)
    np.testing.assert_array_equal(reorder.community_order(csr, hub_block=16), order)
    np.testing.assert_array_equal(
        synthetic.structure_labels(csr, 7, np.random.default_rng(1)), labels)
    assert not native.available()


def write_dataset(directory, name="tiny", n=300, f=40, c=5, seed=0, isolated=False):
    """Reference-format files: neighbour lists with duplicate entries (which
    the readers coalesce), float feature values, a blank svmlight line (a
    node with no features and label -1); with ``isolated``, empty neighbour
    lines (nodes with the self-loop alone)."""
    rng = np.random.default_rng(seed)
    with open(os.path.join(directory, f"{name}.graph"), "w") as fh:
        for i in range(n):
            nb = rng.integers(0, n, int(rng.integers(0 if isolated else 1, 8)))
            fh.write(" ".join(map(str, np.concatenate([nb, nb[:1]]))) + "\n")
    with open(os.path.join(directory, f"{name}.svmlight"), "w") as fh:
        for i in range(n):
            if i == 7:
                fh.write("\n")
                continue
            cols = np.sort(rng.choice(f, int(rng.integers(1, 6)), replace=False))
            vals = rng.normal(0, 1, len(cols)).astype(np.float32)
            fh.write(f"{int(rng.integers(0, c))} "
                     + " ".join(f"{j}:{v:.6g}" for j, v in zip(cols, vals)) + "\n")
    np.savetxt(os.path.join(directory, f"{name}.split"), rng.integers(1, 4, n), fmt="%d")


@pytest.mark.parametrize("binarize", [False, True])
def test_load_dataset_native_equals_both_python_readers(tmp_path, binarize):
    write_dataset(str(tmp_path))
    graph, feats, labels, split, fin, fout = native.load_dataset_native(
        str(tmp_path), "tiny", binarize)
    py = parser.load_dataset("tiny", str(tmp_path), binarize, use_native=False)
    jx = jparser.load_dataset("tiny", str(tmp_path), binarize, use_native=False)
    for ref in (py, jx):
        assert (fin, fout) == (ref.input_dim, ref.output_dim)
        for name in ("indptr", "indices", "values", "sym_scale"):
            np.testing.assert_array_equal(getattr(graph, name), getattr(ref.graph, name),
                                          err_msg=name)
        for name in ("indptr", "indices", "values"):
            np.testing.assert_array_equal(getattr(feats, name),
                                          getattr(ref.feature_csr, name), err_msg=name)
        np.testing.assert_array_equal(labels, ref.labels)
        np.testing.assert_array_equal(split, ref.split)
    assert labels[7] == -1
    # load_dataset reads through the native loader by default: the same dataset
    nat = parser.load_dataset("tiny", str(tmp_path), binarize)
    np.testing.assert_array_equal(nat.features, py.features)
    np.testing.assert_array_equal(nat.graph.values, py.graph.values)


def test_an_empty_graph_line_is_a_node_without_neighbours(tmp_path):
    """The native loader and the port's numpy reader read an empty neighbour
    line as the self-loop alone, as the reference's parser does. The JAX
    package's numpy reader (``np.fromstring`` of the line) reads it as one
    neighbour, node 0: a gap of the JAX side, pinned here."""
    write_dataset(str(tmp_path), isolated=True)
    graph, *_ = native.load_dataset_native(str(tmp_path), "tiny", False)
    py = parser.load_dataset("tiny", str(tmp_path), use_native=False)
    for name in ("indptr", "indices", "values", "sym_scale"):
        np.testing.assert_array_equal(getattr(graph, name), getattr(py.graph, name))
    with open(tmp_path / "tiny.graph") as fh:
        empty = [i for i, line in enumerate(fh) if not line.split()]
    assert empty and (np.diff(graph.indptr)[empty] == 1).all()
    jx = jparser.load_dataset("tiny", str(tmp_path), use_native=False)
    jdeg = np.diff(jx.graph.indptr)
    assert (jdeg[empty] == 2).all() and (jx.graph.indices[jx.graph.indptr[empty]] == 0).all()


def test_load_dataset_falls_back_to_the_numpy_readers(tmp_path, numpy_only, capsys):
    write_dataset(str(tmp_path))
    ds = parser.load_dataset("tiny", str(tmp_path))
    ref = jparser.load_dataset("tiny", str(tmp_path), use_native=False)
    np.testing.assert_array_equal(ds.graph.indices, ref.graph.indices)
    np.testing.assert_array_equal(ds.features, ref.features)
    assert "the dataset reader runs its numpy version" in capsys.readouterr().err


@pytest.mark.parametrize("case,status", [
    ("overflow", -7),  # an id past 2^63 fails the parse instead of wrapping
    ("range", -4),  # a neighbour id outside [0, n)
    ("split", -6),  # a split file shorter than the graph
])
def test_native_loader_refuses_corrupt_files(tmp_path, case, status):
    graph = {"overflow": "1\n99999999999999999999999\n", "range": "1\n5\n"}.get(case, "1\n0\n")
    (tmp_path / "bad.graph").write_text(graph)
    (tmp_path / "bad.svmlight").write_text("0 0:1.0\n1 0:1.0\n")
    (tmp_path / "bad.split").write_text("1\n" if case == "split" else "1\n2\n")
    with pytest.raises(FileNotFoundError, match=f"status {status}"):
        native.load_dataset_native(str(tmp_path), "bad", False)


def test_the_library_is_hashed_under_build_and_concurrent_builds_load(tmp_path):
    path = native.library_path()
    assert os.path.dirname(path) == native.BUILD_DIR
    assert native.BUILD_DIR == os.path.join(REPO, "parallel_gcn_tpu_torch", "_build")
    assert os.path.basename(path).startswith("libpgcn_loader_") and path.endswith(".so")
    native.load_library()
    assert os.path.exists(path)
    # two processes build the same source into an empty directory at once
    code = ("import sys\n"
            "from parallel_gcn_tpu_torch.data import native\n"
            "native.BUILD_DIR = sys.argv[1]\n"
            "lib = native.load_library()\n"
            "print(native.community_labels_native([0, 0, 1], [1, 2, 0], 3, 1).tolist())\n")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)], cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=240) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        assert out.strip() == "[2, 0, 2]"
    assert os.listdir(tmp_path) == [os.path.basename(path)]
