"""The yardstick's frozen copies and plain reference against the program,
on graphs the CPU holds: the generator and the community order, the
dropout mask and seeds, and a whole run of each cell's entry in float32,
which the reference follows to rounding."""

import numpy as np
import pytest
import torch

from portbench import data as bench_data
from portbench import harness
from portbench.reference import philox
from portbench.tests.conftest import TINY_SPEC


def test_the_generator_and_the_order_are_the_programs():
    from parallel_gcn_tpu_torch.data import reorder, synthetic

    spec = dict(TINY_SPEC)
    d = bench_data.generate(spec, 4242)
    ds = synthetic.make_synthetic_dataset("tiny", seed=4242, **spec)
    assert np.array_equal(d["indptr"], ds.graph.indptr)
    assert np.array_equal(d["indices"], ds.graph.indices)
    assert np.array_equal(d["labels"], ds.labels) and np.array_equal(d["split"], ds.split)
    dense = np.zeros((spec["n_nodes"], spec["input_dim"]), np.float32)
    np.put_along_axis(dense, d["feat_cols"].astype(np.int64), d["feat_vals"], axis=1)
    assert np.array_equal(dense, ds.features)
    assert np.array_equal(bench_data.community_order(d["indptr"], d["indices"], hub_block=16),
                          reorder.community_order(ds.graph, hub_block=16))


def test_the_written_files_read_back_exactly(tmp_path):
    from parallel_gcn_tpu_torch.data.parser import load_dataset

    d = bench_data.generate(dict(TINY_SPEC), 7)
    bench_data.write_reference_files(str(tmp_path), "reddit", d)
    ds = load_dataset("reddit", str(tmp_path))
    assert np.array_equal(ds.graph.indptr, d["indptr"])
    for r in range(0, TINY_SPEC["n_nodes"], 97):
        a, b = slice(d["indptr"][r], d["indptr"][r + 1]), slice(ds.graph.indptr[r],
                                                                 ds.graph.indptr[r + 1])
        assert sorted(d["indices"][a]) == sorted(ds.graph.indices[b])
    dense = np.zeros_like(ds.features)
    np.put_along_axis(dense, d["feat_cols"].astype(np.int64), d["feat_vals"], axis=1)
    assert np.array_equal(dense, ds.features)
    assert np.array_equal(ds.labels, d["labels"]) and np.array_equal(ds.split, d["split"])


@pytest.mark.parametrize("seed", [1, 2**40 + 3, 2**62 - 5])
def test_mask_and_seeds_are_the_programs(seed):
    from parallel_gcn_tpu_torch.ops.cuda_dropout import keep_mask
    from parallel_gcn_tpu_torch.train import epoch_seeds

    assert torch.equal(philox.keep_mask(seed, 0.1, 37, 41, "cpu"),
                       keep_mask(seed, 0.1, (37, 41), "cpu"))
    gen = torch.Generator().manual_seed(seed % 2**32)
    assert philox.epoch_seeds(seed % 2**32, 3, 2) == [epoch_seeds(gen, 2) for _ in range(3)]


@pytest.mark.parametrize("cell", ["gcn-reddit.train", "sage-reddit.train",
                                  "gcn-reddit.seeds4"])
def test_the_reference_follows_the_program_in_float32(tiny_root, cell):
    """At compute_dtype float32 every compared number is rounding."""
    name = tiny_root(cell, cell + ".f32", compute_dtype="float32")
    c = harness.Cell.load(name)
    su = harness.set_up(c, 2**35 + 1, lambda m: None, require_cuda=False)
    lanes = []
    for i in range(2):
        r = su.entry.run(harness.run_seeds(2**35 + 1, i, c.lanes))
        lanes += list(zip(r.seeds, r.histories))
    from portbench.reference.common import RefData

    ref = RefData(bench_data.load_reference_arrays(su.data_dir), "cpu")
    for g in harness.compare(c, lanes, ref):
        assert max(g[f"{k}{e}_gap"] for k in ("loss", "val") for e in (1, 2, 3)) < 1e-5, g
        assert g["drop_gap"] < 1e-3 and g["val_drop_gap"] < 1e-3, g
        assert g["acc_gap"] == 0.0, g
