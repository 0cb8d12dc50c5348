"""The products-scale harnesses of the port (``parallel_gcn_tpu_torch/harness/``)
on the CPU, against the JAX package's where it has them.

- ``scale_demo``: the row and byte accounting of a downsized synth-products
  (20,000 nodes, 1M edges, 40 communities, the spec's widths) equals the same
  quantities from the JAX package's partitions at D = 2, 4 and 8; its file
  keeps the accounting and the executed step as sections; JAX's criterion
  (the adaptive buffer under half of all_gather's) fails a non-compact
  synth-products layout and notes another dataset's; the executed step in a
  gloo world of 2 gives finite metrics;
- ``pack_census`` and ``residual_stats`` reproduce the JAX harnesses' numbers
  on that graph given the JAX harnesses' TPU constants;
- ``plots`` writes its SVGs from sample files; ``evidence_check`` passes on
  the repository and fails on a missing cited path or an unstamped row;
- ``feature_impl_bench`` at cora's size: the dense and sparse chains agree
  (Y and dW within rtol 1e-5 + 1e-5·max|ref|, f32) at dropout 0 and at 0.4;
- the CLI's ``[setup]`` line names each stage and the label sweep.
"""

import contextlib
import io
import os
import re
import shutil
import warnings

import numpy as np
import pytest
import torch

import parallel_gcn_tpu.data.synthetic as jsynth
import parallel_gcn_tpu_torch.data.synthetic as tsynth
from harness import pack_census as jax_census
from harness import residual_stats as jax_residual
from parallel_gcn_tpu.parallel.partition import partition_graph_hybrid as jax_partition
from parallel_gcn_tpu_torch.data.parser import prepare_host_dataset
from parallel_gcn_tpu_torch.harness import (common, evidence_check, feature_impl_bench,
                                            pack_census, plots, residual_stats, scale_demo)
from tests.test_torch_parallel import run_world

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPEC = dict(n_nodes=20_000, n_edges=1_000_000, n_communities=40, n_train=1_606, n_val=321)


@pytest.fixture(scope="module")
def products():
    """The downsized synth-products, reordered, and the mesh partition's
    arguments (128x128 int8 tiles, floor 32, no balancing)."""
    cfg = common.config("synth-products")
    ds = prepare_host_dataset(cfg, "synth-products", SPEC)
    return ds, scale_demo.mesh_kwargs(cfg, 128, 32)


@pytest.fixture
def small_products(tmp_path, monkeypatch):
    """synth-products registered at the downsized spec in both packages, its
    cache under ``tmp_path``."""
    monkeypatch.setenv("PGCN_CACHE_DIR", str(tmp_path / "cache"))
    for mod in (jsynth, tsynth):
        monkeypatch.setitem(mod.SYNTHETIC_SPECS, "synth-products",
                            {**mod.SYNTHETIC_SPECS["synth-products"], **SPEC})


@pytest.mark.parametrize("n_dev", [2, 4, 8])
def test_scale_demo_accounting_equals_jax_partitions(products, n_dev):
    ds, kw = products
    with warnings.catch_warnings():  # the small graph's imbalance and boundary halo
        warnings.simplefilter("ignore", UserWarning)
        acc = scale_demo.accounting(ds, n_dev, kw)
        jkw = dict(kw, tile_dtype=np.dtype("int8"))
        sgb = jax_partition(ds.graph, n_dev, boundary=True, **jkw)
        sg = jax_partition(ds.graph, n_dev, adaptive=True, **jkw)
    # the JAX harness's arithmetic (harness/scale_demo.py)
    slab = (sg.tiles.nbytes + sg.res_row.nbytes + sg.res_col.nbytes + sg.res_val.nbytes) // n_dev
    if sg.push_slab:
        slab += (sg.ptiles.nbytes + sg.prow.nbytes + sg.pcol.nbytes + sg.pval.nbytes) // n_dev
    want = dict(n_dev=n_dev, local=sg.n_local, halo_size=sg.halo_size, push_slab=sg.push_slab,
                buf_rows=sg.n_local + n_dev * (sg.halo_size + sg.push_slab),
                bnd_rows=sgb.n_local + n_dev * sgb.halo_size, full_rows=sg.n_nodes_pad,
                slab_bytes=slab, send_bytes=sg.send_idx.nbytes // n_dev)
    assert acc == want
    assert acc["push_slab"] > 0 and acc["buf_rows"] < acc["bnd_rows"]
    lines = scale_demo.accounting_lines("synth-products", ds, acc,
                                        {"input features (F)": 100}, "128x128")
    assert lines[1].endswith(f"buffer={acc['buf_rows']:,}")
    assert f"all_gather={acc['full_rows']:,}" in lines[2]


def _scale_demo_argv(out: str, dataset: str = "synth-products") -> list[str]:
    return [dataset, "--devices", "2", "--device", "cpu", "--out-dir", out,
            "--spec", *(f"{k}={v}" for k, v in SPEC.items())]


@pytest.mark.filterwarnings("ignore::UserWarning")
def test_scale_demo_file_keeps_both_sections(tmp_path):
    out = str(tmp_path)
    path = os.path.join(out, "scale_demo_synth-products_h100.txt")
    argv = _scale_demo_argv(out)
    # the downsized graph misses the compactness criterion; the file is
    # written before the run fails
    with pytest.raises(AssertionError):
        scale_demo.main(argv)
    acc, step = scale_demo._sections(path)
    assert acc[0].startswith("# accounting: host partitions (parallel/partition.py) on the "
                             "host of cpu") and not step
    assert acc[2].startswith("# synth-products: 20,000 nodes") and "D=2" in acc[2]
    scale_demo._write(out, path, acc, [f"{scale_demo.STEP_MARK} on 2 x cpu", "x"])
    with pytest.raises(AssertionError):
        scale_demo.main(argv)
    again, step = scale_demo._sections(path)
    assert step == [f"{scale_demo.STEP_MARK} on 2 x cpu", "x"] and len(again) == len(acc)


@pytest.mark.filterwarnings("ignore::UserWarning")
@pytest.mark.parametrize("dataset", ["synth-products", "synth-medium"])
def test_scale_demo_criterion_on_a_non_compact_layout(tmp_path, dataset):
    # JAX's criterion (buffer under half of all_gather) holds synth-products
    # to it at every D, a downsized spec too; another dataset gets a note
    out = str(tmp_path)
    if dataset == "synth-products":
        with pytest.raises(AssertionError, match=r"D=2: adaptive halo buffer [\d,]+ rows is "
                                                 r"not under half of all_gather's"):
            scale_demo.main(_scale_demo_argv(out, dataset))
    else:
        assert scale_demo.main(_scale_demo_argv(out, dataset)) == 0
    text = (tmp_path / f"scale_demo_{dataset}_h100.txt").read_text()
    want = "criterion missed at D=2" if dataset == "synth-products" else "note: halo not compact"
    assert want in text


def test_scale_demo_step_in_a_world_of_two(tmp_path):
    rows = run_world(scale_demo.executed_step, 2, tmp_path, "synth-products", SPEC,
                     {"hidden_dims": 32}, 3, "cpu", 128, 32, timeout_s=240.0)
    assert [r["rank"] for r in rows] == [0, 1]
    for r in rows:
        assert np.isfinite(r["metrics"]).all() and np.isfinite(r["history"]).all()
        assert len(r["history"]) == 3 and r["peak_rss"] > 0 and r["world"] == 2
        assert r["metrics"] == rows[0]["metrics"]  # the world's metrics, on every rank
    assert rows[0]["push_slab"] > 0  # the adaptive halo pushes for some pairs
    lines = scale_demo.step_lines(rows)
    assert "finite=True" in lines[1] and lines[0].startswith(scale_demo.STEP_MARK)
    assert lines[3].startswith("rank 0: rows local") and lines[4].startswith("rank 1:")


LAYOUTS = [(128, 128, 32), (128, 256, None), (256, 256, 16)]


@pytest.mark.parametrize("tile,cols,min_nnz", LAYOUTS)
def test_pack_census_equals_jax_with_its_constants(small_products, tile, cols, min_nnz):
    want = jax_census.census("synth-products", "community", tile, cols, min_nnz, "int8")
    got = pack_census.census("synth-products", "community", tile, cols, min_nnz, "int8",
                             pack_census.V5E)
    assert got.pop("dtype") == "int8" and want.pop("dtype") == "int8"
    assert got.pop("pred_us") == pytest.approx(want.pop("pred_us"), rel=1e-12)
    assert got == want
    # the H100 constants: the same pack, priced by the card's rates
    h100 = pack_census.census("synth-products", "community", tile, cols, min_nnz, "int8",
                              pack_census.constants(47))
    assert {k: h100[k] for k in ("n_tiles", "resid", "covered")} == {
        k: want[k] for k in ("n_tiles", "resid", "covered")}


def test_residual_stats_equals_jax_with_its_constants(small_products, monkeypatch, tmp_path):
    buf = io.StringIO()
    monkeypatch.setattr("sys.argv", ["residual_stats.py", "synth-products"])
    with contextlib.redirect_stdout(buf):
        assert jax_residual.main() == 0
    want = buf.getvalue().splitlines()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert residual_stats.main(["synth-products", "--item-ns", "17", "--indices-per-item",
                                    "2", "--device", "cpu", "--out-dir", str(tmp_path)]) == 0
    assert buf.getvalue().splitlines() == want
    with open(tmp_path / "residual_stats_synth-products_h100.txt") as f:
        lines = f.read().splitlines()
    assert lines[0].startswith("# synth-products (hybrid, t512x512 int8) on cpu")
    assert lines[1:] == want


SAMPLES = {
    "performance_h100.txt": '{"dataset": "synth-reddit", "card": "NVIDIA H100 80GB HBM3, '
                            '700.00 W", "epoch_ms_median": 8.0, "baseline_t4_ms": 231.5, '
                            '"baseline_cpu_ms": 9826.1}\n',
    "tuning_layout_synth-reddit_h100.txt": "7.8 synth-reddit hybrid/a [NVIDIA H100 80GB HBM3, "
                                           "700.00 W]\n8.1 synth-reddit hybrid/b [NVIDIA H100 "
                                           "80GB HBM3, 700.00 W]\n",
    "tuning_synth-medium_h100.txt": "84.2 0.1 84.3 L=3 H=64 [4 seeds on NVIDIA H100 80GB HBM3, "
                                    "700.00 W]\n",
    "scaling_h100.txt": "# synth-reddit on NVIDIA H100 80GB HBM3, 700.00 W (cuda)\n"
                        "ring       n= 1 epoch    9.0 ms  efficiency 100.0%  test_acc 0.5\n"
                        "ring       n= 2 epoch    6.0 ms  efficiency  75.0%  test_acc 0.5\n",
}


def test_plots_write_their_svgs(tmp_path):
    src = tmp_path / "output"
    src.mkdir()
    for name, text in SAMPLES.items():
        (src / name).write_text(text)
    out = tmp_path / "plots"
    assert plots.main(["--in-dir", str(src), "--out-dir", str(out)]) == 0
    assert sorted(os.listdir(out)) == [
        "performance_comparison_h100.svg", "scaling_h100.svg",
        "tuning_accuracy_synth-medium_h100.svg", "tuning_layout_synth-reddit_h100.svg"]
    for f in os.listdir(out):
        assert (out / f).read_text().lstrip().startswith("<?xml")
    # a missing input skips its figure
    empty = tmp_path / "empty"
    empty.mkdir()
    assert plots.main(["--in-dir", str(empty), "--out-dir", str(tmp_path / "none")]) == 0
    assert not os.path.exists(tmp_path / "none")


def test_evidence_check_passes_here_and_fails_on_a_missing_path(tmp_path, capsys):
    assert evidence_check.main(["--root", REPO]) == 0
    root = tmp_path / "repo"
    shutil.copytree(os.path.join(REPO, "output"), root / "output")
    (root / "PERF.md").write_text("see `output/performance_h100.txt` and "
                                  "`output/no_such_file_h100.txt`\n")
    (root / "README.md").write_text("## Other\n`output/outside.txt`\n"
                                    "## PyTorch + CUDA port (`x`)\n`output/missing_too.txt`\n")
    assert evidence_check.main(["--root", str(root)]) == 1
    out = capsys.readouterr().out
    assert "output/no_such_file_h100.txt is cited but not present" in out
    assert "output/missing_too.txt is cited but not present" in out
    assert "outside.txt" not in out  # outside the port's section
    (root / "output" / "bare_h100.txt").write_text("1.0 a row without its card\n")
    assert evidence_check.main(["--root", str(root)]) == 1
    assert "output/bare_h100.txt:1 carries no card stamp" in capsys.readouterr().out


@pytest.mark.parametrize("p", [0.0, 0.4])
def test_feature_impl_chains_agree_at_coras_size(p):
    ds, generated = feature_impl_bench.dataset("cora")
    chains = feature_impl_bench.Chains(ds, 72, p, torch.float32, torch.device("cpu"))
    (yd, wd), (ys, ws) = chains.dense(), chains.sparse()
    for got, ref in ((ys, yd), (ws, wd)):
        err = (got - ref).abs()
        assert bool((err <= 1e-5 * ref.abs().max() + 1e-5 * ref.abs()).all()), float(err.max())
    assert generated == (not os.path.exists(os.path.join(REPO, "data", "cora.graph")))


def test_feature_impl_bench_writes_its_rows(tmp_path):
    assert feature_impl_bench.main(["cora", "--steps", "1", "--reps", "1", "--device", "cpu",
                                    "--out-dir", str(tmp_path)]) == 0
    lines = (tmp_path / "feature_impl_cora_h100.txt").read_text().splitlines()
    assert lines[0].startswith("# device=cpu card=cpu steps=1;")
    assert [ln.split()[1] for ln in lines[1:]] == list(feature_impl_bench.VARIANTS)


def test_cli_setup_line_names_stages_and_sweep(tmp_path, monkeypatch, capsys):
    from parallel_gcn_tpu_torch import cli

    monkeypatch.setenv("PGCN_CACHE_DIR", str(tmp_path))
    assert cli.main(["synth-medium", "device=cpu", "epochs=1", "backend=hybrid",
                     "tile_dtype=int8", "tile_size=128", "reorder=community"]) == 0
    out = capsys.readouterr().out
    line = next(ln for ln in out.splitlines() if ln.startswith("[setup]"))
    assert re.match(r"\[setup\] load \S+ s, reorder \S+ s, permute \S+ s, pack \S+ s, copy \S+ s "
                    r"\(generated, labels=native\); peak host RSS \S+ GiB; \d+ tiles 128x128 "
                    r"int8 \(\S+ GiB\), residual \d+ entries, \S+% of 1225000 in tiles$",
                    line), line
    assert "setup: the input's pre-aggregation (Â·X at 300 columns) in" in out
