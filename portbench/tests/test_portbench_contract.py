"""The benchmark's files against its contract: names and units, every
cell's files found by name, and a new cell made runnable by files alone."""

import json
import os
import re
import subprocess
import sys

import pytest

from portbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def bench():
    with open(os.path.join(harness.REPO_DIR, "BENCHMARK.json")) as f:
        return json.load(f)


def test_names_and_units_use_only_the_allowed_characters():
    b = bench()
    names = [c["name"] for c in b["configs"]] + [w["name"] for w in b["workloads"]]
    names += [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    names += [w[k] for w in b["workloads"] for k in ("config", "traffic")]
    names += [k for c in b["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), [n for n in names if not NAME.match(n)]
    assert all(UNIT.match(m["unit"]) for m in b["end_to_end"] + b["per_layer"])
    for text in ([w["why"] for w in b["workloads"]] + [c["why"] for c in b["configs"]]
                 + [m["layer"] for m in b["per_layer"]]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text
    assert len({m["name"] for m in b["end_to_end"] + b["per_layer"]}) == \
        len(b["end_to_end"]) + len(b["per_layer"])


@pytest.mark.parametrize("cell", [w["name"] for w in bench()["workloads"]])
def test_every_cell_finds_its_files_by_name(cell):
    b = bench()
    entry = next(w for w in b["workloads"] if w["name"] == cell)
    c = harness.Cell.load(cell)
    assert (c.workload["config"], c.workload["traffic"], c.workload["chips"]) == \
        (entry["config"], entry["traffic"], entry["chips"])
    conf = next(x for x in b["configs"] if x["name"] == entry["config"])
    assert conf["file"] == f"portbench/configs/{entry['config']}.json"
    assert c.config["reduced"] == conf["reduced"] and c.config["source"] == conf["source"]
    entry_mod = harness.entry_module(c.traffic["entry"])
    assert all(callable(getattr(entry_mod, f)) for f in ("devices", "prepare", "call"))
    for m in harness.per_layer_metrics(cell):
        assert callable(harness.reader(m["name"]).read)
    assert c.workload["limits"]


def test_per_layer_metrics_name_an_end_to_end_metric_they_move():
    b = bench()
    e2e = {m["name"]: m for m in b["end_to_end"]}
    cells = {w["name"] for w in b["workloads"]}
    for m in b["per_layer"]:
        assert m["moves"] in e2e
        assert set(m.get("workloads", cells)) <= cells


def test_a_new_workload_file_is_a_runnable_cell(tiny_root):
    """One more file under ``workloads/`` and the harness runs it: no edit
    of a file that is there."""
    root = harness.PORTBENCH_DIR
    wl = {"config": "gcn-reddit", "traffic": "seeds4", "chips": 1,
          "limits": {"loss2_gap": 0.05, "drop_gap": 0.2}}
    with open(os.path.join(root, "workloads", "gcn-reddit.extra.json"), "w") as f:
        json.dump(wl, f)
    out = harness.run("gcn-reddit.extra", 2**33 + 5, 0.5, False, t_start=0.0,
                      require_cuda=False, log=lambda m: None)
    assert out.correct and out.attempted >= 4 and set(out.checks) == {"loss2_gap", "drop_gap"}
    assert set(out.metrics) == {"epoch_ms", "peak_mem_gib", "setup_s"}


def test_a_new_entry_file_is_a_runnable_traffic(tiny_root, tmp_path, monkeypatch):
    """A new entry is one more module under ``entries/``, named by a new
    traffic file: no edit of a file that is there."""
    import portbench.entries

    extra = tmp_path / "entries"
    extra.mkdir()
    (extra / "fit_again.py").write_text(
        "from portbench.entries.fit import call as fit_call, devices, prepare\n"
        "CALLS = []\n"
        "def call(prepared, cfg, seeds, weights):\n"
        "    CALLS.append(list(seeds))\n"
        "    return fit_call(prepared, cfg, seeds, weights)\n")
    monkeypatch.setattr(portbench.entries, "__path__", [*portbench.entries.__path__, str(extra)])
    root = harness.PORTBENCH_DIR
    with open(os.path.join(root, "traffic", "again.json"), "w") as f:
        json.dump({"entry": "fit_again", "lanes": 1}, f)
    with open(os.path.join(root, "workloads", "gcn-reddit.again.json"), "w") as f:
        json.dump({"config": "gcn-reddit", "traffic": "again", "chips": 1,
                   "limits": {"loss2_gap": 0.05}}, f)
    out = harness.run("gcn-reddit.again", 2**34 + 1, 0.3, False, t_start=0.0,
                      require_cuda=False, log=lambda m: None)
    calls = harness.entry_module("fit_again").CALLS
    assert out.correct and len(calls) == out.attempted + 1  # the warm-up run too


def test_the_command_refuses_a_machine_without_the_card():
    """Without CUDA the run exits 1 and prints no result line."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("the machine has a card")
    p = subprocess.run([sys.executable, os.path.join(harness.PORTBENCH_DIR, "run.py"),
                        "--workload", "gcn-reddit.train", "--seed", str(2**31 + 7),
                        "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, cwd=harness.REPO_DIR, timeout=120)
    assert p.returncode == 1 and p.stdout.strip() == ""
    assert "CUDA" in p.stderr
