"""The control on the card, at each cell's own size, on three seeds: the
plain reference in float8 (e4m3, a scale a tensor: the precision below
the configurations' bfloat16) put in the program's place fails the cell's
limits. Run on the card: ``python3 -m pytest portbench/tests -m cuda``."""

import pytest

from portbench import data as bench_data
from portbench import harness

CELLS = ["gcn-reddit.train", "sage-reddit.train", "gcn-reddit.seeds4"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cuda_device, cell):
    from portbench.reference.common import RefData

    c = harness.Cell.load(cell)
    path = bench_data.ensure(c.config["data"])
    ref = RefData(bench_data.load_reference_arrays(path), cuda_device)
    seeds = harness.run_seeds(2**31 + 17, 0, 3)
    per_lane = harness.compare(c, [(s, None) for s in seeds], ref, precision="fp8")
    correct, failed, checks = harness.judge(c, per_lane)
    assert not correct and failed == 3, checks
