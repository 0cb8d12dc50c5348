"""Fixtures of the benchmark's tests: a tiny copy of the benchmark's files
(the real cells' traffic and workloads, a configuration cut to a graph the
CPU trains in seconds), and the card for the tests marked ``cuda``."""

import json
import os
import shutil

import pytest

from portbench import data as bench_data
from portbench import harness

TINY_SPEC = dict(n_nodes=2000, n_edges=40000, input_dim=48, n_classes=6, n_train=1000,
                 n_val=400, feature_nnz_per_row=8, feature_signal=0.5, label_noise=0.1,
                 n_communities=40)
TINY_PARAMS = {"hidden_dims": 32, "epochs": 4, "tile_size": 128, "tile_cols": 256,
               "tile_budget_mb": 1, "min_tile_nnz": 8}


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU; skipped without one")


@pytest.fixture
def cuda_device():
    """The card, or a skip where there is none (decided here, never at import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA): run on the card")
    return torch.device("cuda", 0)


@pytest.fixture
def tiny_root(tmp_path, monkeypatch):
    """A copy of the benchmark's files whose configurations train a
    2,000-node graph; the data cache under ``tmp_path``. Yields a function
    ``(workload, **overrides) -> name`` that writes one more cell there."""
    root = tmp_path / "portbench"
    for sub in ("configs", "traffic", "workloads"):
        shutil.copytree(os.path.join(harness.PORTBENCH_DIR, sub), root / sub)
    shutil.copy(os.path.join(harness.PORTBENCH_DIR, "peaks.json"), root / "peaks.json")
    for path in (root / "configs").glob("*.json"):
        cfg = json.loads(path.read_text())
        cfg["data"]["spec"] = TINY_SPEC
        cfg["overrides"] = {**cfg.get("overrides", {}), **TINY_PARAMS}
        path.write_text(json.dumps(cfg))
    monkeypatch.setattr(harness, "PORTBENCH_DIR", str(root))
    monkeypatch.setattr(bench_data, "CACHE_DIR", str(tmp_path / "cache"))

    def add_cell(base: str, name: str, **changes) -> str:
        wl = json.loads((root / "workloads" / f"{base}.json").read_text())
        cfg = json.loads((root / "configs" / f"{wl['config']}.json").read_text())
        cfg["overrides"].update(changes)
        (root / "configs" / f"{name}.json").write_text(json.dumps(cfg))
        wl["config"] = name
        (root / "workloads" / f"{name}.json").write_text(json.dumps(wl))
        return name

    yield add_cell
