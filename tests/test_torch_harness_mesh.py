"""The port's mesh harnesses on the CPU: ``scaling`` over torchrun worlds of
1 and 2 gloo processes and ``mesh_onechip`` in a world of one, on the small
generated graph of ``test_torch_harness``."""

import json
import os
import re

import pytest
import torch

from parallel_gcn_tpu_torch.harness import mesh_onechip, scaling
from tests.test_torch_harness import _lines, data  # noqa: F401  (the fixture)

torch.set_num_threads(1)


def test_scaling_over_worlds_of_one_and_two(data):  # noqa: F811
    out = str(data)
    assert scaling.main(["cora", "--devices", "1,2", "--epochs", "3", "--device", "cpu",
                         "--out-dir", out, "--timeout", "240"]) == 0
    lines = _lines(os.path.join(out, "scaling_h100.txt"))
    assert lines[0] == "# cora on cpu (cpu), 3 epochs a point, mode=scan"
    rows = [re.match(r"(\S+) +n= *(\d+) epoch +(\S+) ms  efficiency +(\S+)%  test_acc (\S+)$",
                     ln).groups() for ln in lines[1:]]
    assert [(r[0], int(r[1])) for r in rows] == [(h, n) for h in scaling.HALOS for n in (1, 2)]
    assert all(float(r[2]) > 0 for r in rows) and all(r[3] == "100.0" for r in rows[::2])
    # efficiency: the first size's time × its ranks over this size's
    for one, two in zip(rows[::2], rows[1::2]):
        assert float(two[3]) == pytest.approx(100 * float(one[2]) / (2 * float(two[2])), abs=0.3)

def test_mesh_onechip_tax_against_fit(data):  # noqa: F811
    out = str(data)
    assert mesh_onechip.main(["--routes", "cora-gcn,cora-gat", "--epochs", "6", "--reps", "1",
                              "--device", "cpu", "--out-dir", out]) == 0
    rows = [json.loads(ln) for ln in _lines(os.path.join(out, "mesh_onechip_h100.txt"))]
    assert [r["route"] for r in rows] == ["cora-gcn", "cora-gat"]
    for r in rows:
        assert r["device"] == "cpu" and r["n_devices"] == 1
        assert r["tax"] == r["epoch_ms_min"] / r["fit_epoch_ms_min"]
