"""The port's harnesses (``parallel_gcn_tpu_torch.harness``) on the CPU, each
``main`` on a small generated graph written in the reference format as
``cora``'s files (``PGCN_DATA_DIR``), with an output directory under
``tmp_path``: the rows, the statistics over the lanes, the grids against the
JAX harnesses', and the refusal to overwrite a card-measured file."""

import json
import os
import re

import numpy as np
import pytest
import torch

from harness import tuning as jax_tuning
from harness import tuning_layout as jax_tuning_layout
from parallel_gcn_tpu_torch.config import default_params_path, load_config
from parallel_gcn_tpu_torch.data.parser import prepare_device_dataset
from parallel_gcn_tpu_torch.harness import (accuracy, performance, performance_golden, profile,
                                            seed_select, tuning, tuning_layout)
from parallel_gcn_tpu_torch.seeds import fit_seeds

torch.set_num_threads(1)


def write_reference_dataset(directory, name="cora", n=240, f=24, c=4, seed=0):
    """A community graph with noisy labels and random binary features as the
    reference's ``<name>.graph``, ``.svmlight`` and ``.split`` files."""
    rng = np.random.default_rng(seed)
    comm = rng.integers(0, c, n)
    nbrs = [set() for _ in range(n)]
    for _ in range(4 * n):
        a = int(rng.integers(0, n))
        pool = np.flatnonzero(comm == comm[a]) if rng.random() < 0.8 else np.arange(n)
        b = int(rng.choice(pool))
        if a != b:
            nbrs[a].add(b)
            nbrs[b].add(a)
    labels = np.where(rng.random(n) < 0.25, rng.integers(0, c, n), comm)
    with open(os.path.join(directory, f"{name}.graph"), "w") as fh:
        fh.writelines(" ".join(map(str, sorted(s))) + "\n" for s in nbrs)
    with open(os.path.join(directory, f"{name}.svmlight"), "w") as fh:
        for i in range(n):
            cols = sorted(set(rng.integers(0, f - 1, 5).tolist()) | {f - 1})
            fh.write(f"{labels[i]} " + " ".join(f"{j}:1" for j in cols) + "\n")
    split = np.full(n, 3)
    perm = rng.permutation(n)
    split[perm[: n // 2]], split[perm[n // 2: n // 2 + n // 5]] = 1, 2
    np.savetxt(os.path.join(directory, f"{name}.split"), split, fmt="%d")


@pytest.fixture
def data(tmp_path, monkeypatch):
    d = tmp_path / "data"
    d.mkdir()
    write_reference_dataset(str(d))
    monkeypatch.setenv("PGCN_DATA_DIR", str(d))
    monkeypatch.setenv("PGCN_CACHE_DIR", str(tmp_path / "cache"))
    return tmp_path / "out"


def _lines(path):
    with open(path) as f:
        return [ln for ln in f.read().splitlines() if ln]


def test_accuracy_rows_and_statistics_over_the_lanes(data, capsys):
    out = str(data)
    assert accuracy.main(["cora", "citeseer", "--seeds", "3", "--epochs", "12",
                          "--set", "hidden_dims=16", "--tag", "t", "--device", "cpu",
                          "--out-dir", out]) == 0
    assert "[citeseer] dataset unavailable, skipping" in capsys.readouterr().err
    (line,) = _lines(os.path.join(out, "accuracy_h100_t.txt"))
    assert re.match(r"cora +val \S+±\S+ \(max \S+\) test \S+ \(max \S+\) epochs~\d+ \[3 seeds, "
                    r"\S+s, \S+ ms/epoch; one lane \S+s, \S+ ms/epoch\] on cpu  \| published val "
                    r"88.42±0.297, test 87.9$", line), line
    row = accuracy.run_seeds("cora", 3, 12, overrides={"hidden_dims": 16}, device="cpu")
    cfg = load_config(default_params_path("cora"), {"hidden_dims": 16, "epochs": 12,
                                                    "verbose": False,
                                                    "matmul_precision": "default"})
    _, dds = prepare_device_dataset(cfg, "cora", torch.device("cpu"))
    lanes = fit_seeds(cfg, dds, [0, 1, 2])
    val, test = np.asarray(lanes.val_acc) * 100, np.asarray(lanes.test_acc) * 100
    assert row["val_mean"] == pytest.approx(val.mean(), abs=1e-4)
    assert row["val_sd"] == pytest.approx(val.std(ddof=1), abs=1e-4)
    assert row["val_max"] == pytest.approx(val.max(), abs=1e-4)
    assert row["test_mean"] == pytest.approx(test.mean(), abs=1e-4)
    assert row["epochs_mean"] == np.mean(lanes.epochs_run)
    assert row["lane0_equal_alone"] and row["device"] == "cpu" and row["card"] == "cpu"


def test_tuning_presets_equal_jax_and_a_sweep(data, monkeypatch):
    assert tuning.PRESETS == jax_tuning.PRESETS
    monkeypatch.setitem(tuning.PRESETS, "coarse",
                        {"n_layers": [2], "hidden": [8, 16], "dropout": [0.2], "wd": [5e-4]})
    out = str(data)
    assert tuning.main(["cora", "--seeds", "2", "--epochs", "8", "--device", "cpu",
                        "--out-dir", out]) == 0
    rows = _lines(os.path.join(out, "tuning_cora_h100.txt"))
    assert len(rows) == 2
    means = [float(r.split()[0]) for r in rows]
    assert means == sorted(means, reverse=True)
    assert all(re.search(r"L=2 H=(8|16) D=0.2 wd=0.0005 \[2 seeds on cpu\]$", r) for r in rows)


def test_seed_select_checks_every_solo_run_against_its_lane(data, capsys):
    out = str(data)
    assert seed_select.main(["cora", "--seeds", "4", "--batch", "3", "--verify", "2",
                             "--device", "cpu", "--out-dir", out]) == 0
    lines = _lines(os.path.join(out, "seed_select_cora_h100.txt"))
    assert "every solo run equals its lane: True" in lines[1]
    verified = lines[3:5]
    assert all(ln.split()[-1] == "True" for ln in verified)
    ranking = lines[lines.index("# the lanes' ranking") + 1:]
    assert sorted(int(ln.split()[0]) for ln in ranking) == [0, 1, 2, 3]
    assert "suggested: seed=" in capsys.readouterr().out


def test_performance_rows_and_the_refusal_to_downgrade(data):
    out = str(data)
    assert performance.main(["cora", "--epochs", "6", "--reps", "2", "--device", "cpu",
                             "--out-dir", out]) == 0
    path = os.path.join(out, "performance_h100.txt")
    (row,) = [json.loads(ln) for ln in _lines(path)]
    assert row["dataset"] == "cora" and row["backend"] == "dense" and row["device"] == "cpu"
    assert len(row["reps_ms"]) == 2 and row["epoch_ms_min"] == pytest.approx(
        min(row["reps_ms"]), abs=1e-4)
    assert row["epoch_ms_median"] == pytest.approx(np.median(row["reps_ms"]), abs=1e-4)
    assert row["baseline_t4_ms"] == 0.277 and row["vs_gpu_baseline"] == pytest.approx(
        0.277 / row["epoch_ms_min"])
    # a card-measured file is not overwritten from the CPU, unless asked
    card = json.dumps({**row, "device": "cuda", "card": "NVIDIA H100 80GB HBM3, 700.00 W"})
    with open(path, "w") as f:
        f.write(card + "\n")
    assert performance.main(["cora", "--epochs", "6", "--reps", "1", "--device", "cpu",
                             "--out-dir", out]) == 2
    assert _lines(path) == [card]
    assert performance.main(["cora", "--epochs", "6", "--reps", "1", "--device", "cpu",
                             "--out-dir", out, "--allow-downgrade"]) == 0
    assert json.loads(_lines(path)[0])["device"] == "cpu"


def test_performance_golden(data):
    out = str(data)
    assert performance_golden.main(["cora", "--epochs", "2", "--port-epochs", "6",
                                    "--device", "cpu", "--out-dir", out]) == 0
    (line,) = _lines(os.path.join(out, "performance_golden_h100.txt"))
    assert re.match(r"cora +golden-oracle epoch \S+ ms \(numpy, host\); port \S+ ms on cpu: "
                    r"\S+x \(the reference's optimized CPU baseline: 5.002 ms\)$", line), line


@pytest.mark.parametrize("mode", ["eager", "scan"])
def test_profile_prints_the_op_table(data, capsys, mode):
    assert profile.main(["cora", "--mode", mode, "--top", "4", "--device", "cpu"]) == 0
    text = capsys.readouterr().out
    assert f"mode={mode}" in text and "in CPU ops (self time; the CPU, no device time)" in text
    assert len([ln for ln in text.splitlines() if " ms  x" in ln]) == 4


def test_tuning_layout_grid_equals_jax_and_a_sweep(data):
    assert tuning_layout.GRID == jax_tuning_layout.GRID
    out = str(data)
    assert tuning_layout.main(["cora", "--epochs", "5", "--reps", "1", "--backends",
                               "dense,hybrid", "--reorders", "none", "--tiles", "128",
                               "--mults", "1", "--tile-dtypes", "auto,int8", "--min-nnz", "8",
                               "--device", "cpu", "--out-dir", out]) == 0
    rows = _lines(os.path.join(out, "tuning_layout_cora_h100.txt"))
    labels = sorted(r.split()[2] for r in rows)
    assert labels == ["dense/none", "hybrid/none/t128x128/auto/nnz8",
                      "hybrid/none/t128x128/int8/nnz8"]
    ms = [float(r.split()[0]) for r in rows]
    assert ms == sorted(ms) and all(r.endswith("[cpu]") for r in rows)
    assert tuning_layout.main(["cora", "--backends", "sparse", "--device", "cpu",
                               "--out-dir", out]) == 2
