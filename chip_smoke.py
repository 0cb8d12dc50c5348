#!/usr/bin/env python3
"""GPU smoke test of parallel_gcn_tpu_torch on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printed on its own lines:
  1. device: nvidia-smi's name and power limit, torch's device name;
  2. build: compiles the CUDA kernels (csrc/*.cu) and prints the seconds;
  3. kernels: each kernel against its plain PyTorch version on the card, at
     the shapes synth-reddit's training gives it (dropout bit-equal; tile
     SpMM forward and backward within rtol 1e-4 for f32 x and 2e-3 for bf16
     x, atol 1e-5·max|ref| for both; GAT tile attention K5/K6 at heads 2,
     d 32 and 41, bf16 and f32, attention dropout 0 and 0.6, forward within
     rtol 1e-4 (f32) / 2e-3 (bf16) + 1e-5·max|ref|, gradients within rtol
     1e-3 + 1e-4·max|ref|, two runs bit-identical), with CUDA-event times;
  4. profile: the synth-reddit GAT's epoch under ``torch.profiler``: device
     time by op and the device's idle share;
  5. reference: a small hybrid int8 graph trains 3 epochs on the card and on
     the CPU (the plain versions), as a GCN and as a GAT with feature and
     attention dropout; the metrics must agree within 2e-4;
  6. main paths, each with the launch counts set to 0 just before it:
     ``parallel_gcn_tpu_torch.cli.main(["synth-reddit", "epochs=10"])`` (the
     GCN) and the same with ``model=gat heads=2 hidden_dims=32
     dropouts=0.0,0.1 mode=eager`` (the GAT); the losses must be finite and
     fall, and the kernels of each path must have launched at least as often
     as its epochs imply.
Then one JSON line with every kernel's launches, error and times, and last
``{"ok": true, "device": {...}}``. Any failure raises before that line; with
no CUDA device the script exits 1 and prints no result.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import os
import re
import subprocess
import sys
import time

EPOCHS = 10
# the repo's reddit GAT configuration (Makefile run-reddit-gat)
GAT_ARGS = ["model=gat", "heads=2", "hidden_dims=32", "dropouts=0.0,0.1"]


def _events_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` calls, by CUDA events,
    after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _max_err(got, ref, rtol: float, atol_frac: float = 1e-5) -> float:
    """max |got − ref|, after asserting
    |got − ref| ≤ atol_frac·max|ref| + rtol·|ref|."""
    import torch

    got, ref = got.float(), ref.float()
    assert bool(torch.isfinite(got).all()), "non-finite kernel output"
    err = (got - ref).abs()
    bound = atol_frac * ref.abs().max() + rtol * ref.abs()
    worst = float((err - bound).max())
    assert worst <= 0, f"mismatch: max excess over tolerance {worst}"
    return float(err.max())


def phase_device():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    for line in smi.stdout.strip().splitlines():
        print(f"[device] nvidia-smi: {line.strip()}")
    name = torch.cuda.get_device_name(0)
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda}: {name}")
    return name


def phase_build():
    from parallel_gcn_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.load_library()
    secs = time.perf_counter() - t0
    print(f"[build] kernels built and loaded in {secs:.2f} s "
          f"({os.path.basename(_build.build_info['path'])})")
    for line in _build.build_info["log"].splitlines():
        if "registers" in line or "spill" in line:
            print(f"[build] {line.strip()}")


def check_dropout(results: dict) -> None:
    import torch

    from parallel_gcn_tpu_torch.ops import cuda_dropout as cd

    gen = torch.Generator().manual_seed(1)
    seed = 0x1234_5678_9ABC
    # K2's shape on the GCN path, K1's on the GAT path (layer 1's input),
    # and a ragged f32 one
    for shape, dtype, rate in (((233472, 600), torch.bfloat16, 0.1),
                               ((233472, 64), torch.bfloat16, 0.1),
                               ((1001, 257), torch.float32, 0.3)):
        x = torch.randn(shape, generator=gen).to(dtype).cuda()
        g = torch.randn(shape, generator=gen).to(dtype).cuda()
        k1 = cd.dropout(x, seed, rate)
        p1 = cd.dropout_plain(x, seed, rate)
        assert torch.equal(k1, p1), f"K1 != plain at {shape} {dtype}"
        k2 = cd.relu_dropout(x, seed, rate)
        p2 = cd.dropout_plain(x, seed, rate, relu=True)
        assert torch.equal(k2, p2), f"K2 != plain at {shape} {dtype}"
        assert torch.equal(k2, cd.dropout(torch.relu(x), seed, rate)), "K2 != K1(relu)"
        keep = float((k1 != 0).float().mean())
        assert abs(keep - (1 - rate)) < 5e-3, f"keep-rate {keep}"
        # backward: K1 reruns on the cotangent, K2 reads its output
        xr = x.clone().requires_grad_(True)
        cd.dropout(xr, seed, rate).backward(g)
        assert torch.equal(xr.grad, cd.dropout_plain(g, seed, rate)), "K1 backward"
        xr = x.clone().requires_grad_(True)
        out = cd.relu_dropout(xr, seed, rate)
        out.backward(g)
        inv = torch.tensor(1 / (1 - rate), dtype=dtype).cuda()
        want = torch.where(out > 0, g * inv, torch.zeros((), dtype=dtype, device="cuda"))
        assert torch.equal(xr.grad, want), "K2 backward"
        ms1 = _events_ms(lambda: cd.dropout(x, seed, rate), 20)
        pms1 = _events_ms(lambda: cd.dropout_plain(x, seed, rate), 3)
        ms2 = _events_ms(lambda: cd.relu_dropout(x, seed, rate), 20)
        pms2 = _events_ms(lambda: cd.dropout_plain(x, seed, rate, relu=True), 3)
        print(f"[kernels] K1 dropout {list(shape)} {dtype} rate {rate}: bit-equal "
              f"to plain, fwd and bwd; keep-rate {keep:.6f}; "
              f"kernel {ms1:.4f} ms, plain {pms1:.4f} ms")
        print(f"[kernels] K2 relu_dropout {list(shape)} {dtype} rate {rate}: "
              f"bit-equal to plain and to K1(relu), fwd and bwd; "
              f"kernel {ms2:.4f} ms, plain {pms2:.4f} ms")
        if shape[1] == 64:
            results["K1"] = dict(err=0.0, ms=ms1, plain_ms=pms1)
        elif dtype == torch.bfloat16:
            results["K2"] = dict(err=0.0, ms=ms2, plain_ms=pms2)


def check_bcsr(results: dict, bcsr_pack, x602) -> None:
    import dataclasses

    import torch

    from parallel_gcn_tpu_torch.ops import cuda_bcsr as cb

    gen = torch.Generator().manual_seed(2)
    n = bcsr_pack.n_nodes
    x41 = torch.randn((n, 41), generator=gen).to(torch.bfloat16).cuda()
    g41 = torch.randn((n, 41), generator=gen).cuda()
    # K3: the same tiles as a plain pattern pack (no d scaling)
    pattern = dataclasses.replace(bcsr_pack, sym_scale=None)
    for key, pack in (("K4", bcsr_pack), ("K3", pattern)):
        errs = []
        for x, rtol in ((x41, 2e-3), (x602, 1e-4)):
            got = cb.bcsr_matmul_impl(pack, x)
            ref = cb.bcsr_matmul_plain(pack, x)
            errs.append(_max_err(got, ref, rtol))
            ms = _events_ms(lambda: cb.bcsr_matmul_impl(pack, x), 10)
            pms = _events_ms(lambda: cb.bcsr_matmul_plain(pack, x), 2)
            print(f"[kernels] {key} bcsr fwd F={x.shape[1]} {x.dtype}: max_abs_err "
                  f"{errs[-1]:.3e} (rtol {rtol}); kernel {ms:.4f} ms, plain {pms:.4f} ms")
            if x is x41:
                results[key] = dict(ms=ms, plain_ms=pms)
        # backward through autograd: the same kernel on the cotangent
        for x, g in ((x41.float(), g41), (x602, torch.randn(x602.shape, generator=gen).cuda())):
            xr = x.clone().requires_grad_(True)
            cb.bcsr_matmul(pack, xr).backward(g)
            errs.append(_max_err(xr.grad, cb.bcsr_matmul_plain(pack, g), 1e-4))
            print(f"[kernels] {key} bcsr bwd F={x.shape[1]} {x.dtype}: max_abs_err "
                  f"{errs[-1]:.3e} (rtol 1e-4)")
        results[key]["err"] = max(errs)


def check_tile_attention(results: dict, pack) -> None:
    """K5/K6 against their plain versions on synth-reddit's pack at the GAT's
    shapes (heads 2; d 32 for layer 0, 41 for layer 1)."""
    import torch

    from parallel_gcn_tpu_torch.ops import tile_attention as ta

    gen = torch.Generator().manual_seed(3)
    n, H = pack.n_nodes, 2
    errs = {"K5": [], "K6": []}
    for D in (32, 41):
        for dtype, rtol in ((torch.bfloat16, 2e-3), (torch.float32, 1e-4)):
            s, t = (torch.randn((n, H), generator=gen).to(dtype).cuda() for _ in range(2))
            v = torch.randn((n, H, D), generator=gen).to(dtype).cuda()
            g = torch.randn((n, H, D), generator=gen).cuda()
            for rate in (0.0, 0.6):
                kw = dict(slope=0.2, rate=rate, seed=0x2468ACE)
                fwd = ta.gat_fwd_tiles(pack, s, t, v, **kw)
                again = ta.gat_fwd_tiles(pack, s, t, v, **kw)
                assert all(map(torch.equal, fwd, again)), "K5: two runs differ"
                acc, m, den = ta.gat_fwd_tiles_plain(pack, s, t, v, **kw)
                live = den > 0  # rows with edges; the others keep m = -1e9
                assert torch.equal(fwd[1][~live], m[~live]), "K5: m of empty rows"
                e5 = max(_max_err(fwd[0], acc, rtol), _max_err(fwd[2], den, rtol),
                         _max_err(fwd[1][live], m[live], 1e-6))
                rho = (g * acc / den.clamp(min=1e-16)[:, :, None]).sum(-1)
                bwd = ta.gat_bwd_tiles(pack, s, t, v, g, m, den, rho, **kw)
                again = ta.gat_bwd_tiles(pack, s, t, v, g, m, den, rho, **kw)
                assert all(map(torch.equal, bwd, again)), "K6: two runs differ"
                ref = ta.gat_bwd_tiles_plain(pack, s, t, v, g, m, den, rho, **kw)
                e6 = max(_max_err(a, b, 1e-3, atol_frac=1e-4) for a, b in zip(bwd, ref))
                errs["K5"].append(e5)
                errs["K6"].append(e6)
                ms5 = _events_ms(lambda: ta.gat_fwd_tiles(pack, s, t, v, **kw), 10)
                pms5 = _events_ms(lambda: ta.gat_fwd_tiles_plain(pack, s, t, v, **kw), 2)
                ms6 = _events_ms(
                    lambda: ta.gat_bwd_tiles(pack, s, t, v, g, m, den, rho, **kw), 10)
                pms6 = _events_ms(
                    lambda: ta.gat_bwd_tiles_plain(pack, s, t, v, g, m, den, rho, **kw), 2)
                print(f"[kernels] K5 gat_fwd H={H} D={D} {dtype} rate {rate}: max_abs_err "
                      f"{e5:.3e} (rtol {rtol}), runs bit-identical; kernel {ms5:.4f} ms, "
                      f"plain {pms5:.4f} ms")
                print(f"[kernels] K6 gat_bwd H={H} D={D} {dtype} rate {rate}: max_abs_err "
                      f"{e6:.3e} (rtol 1e-3), runs bit-identical; kernel {ms6:.4f} ms, "
                      f"plain {pms6:.4f} ms")
                if (D, dtype, rate) == (41, torch.bfloat16, 0.0):  # layer 1 of the main path
                    results["K5"] = dict(ms=ms5, plain_ms=pms5)
                    results["K6"] = dict(ms=ms6, plain_ms=pms6)
    for key in errs:
        results[key]["err"] = max(errs[key])


def _gat_config(epochs: int):
    from parallel_gcn_tpu_torch.config import (default_params_path, load_config,
                                               parse_override)

    overrides = dict(a.split("=", 1) for a in GAT_ARGS)
    cfg = load_config(default_params_path("synth-reddit"),
                      {k: parse_override(v) for k, v in overrides.items()})
    cfg.gcn.epochs, cfg.train.verbose = epochs, False
    return cfg


def _category(kernel: str) -> str:
    for key, cat in (("gat_fwd_kernel", "K5 gat_fwd"), ("merge_segments_kernel<true>", "K5 gat_fwd"),
                     ("gat_bwd_kernel", "K6 gat_bwd"), ("merge_segments_kernel<false>", "K6 gat_bwd"),
                     ("dropout_kernel", "K1 dropout"), ("gemm", "GEMMs"), ("gemv", "GEMMs"),
                     ("xmma", "GEMMs"), ("nvjet", "GEMMs"), ("cutlass", "GEMMs"),
                     ("scatter", "scatter/index (residual)"),
                     ("index", "scatter/index (residual)"), ("reduce", "reductions"),
                     ("Memcpy", "copies"), ("Memset", "copies")):
        if key in kernel:
            return cat
    return "other elementwise"


def phase_profile_gat(dds) -> None:
    """Device time by op over 3 synth-reddit GAT epochs after 2 warm-up
    epochs (``torch.profiler``), and the device's idle share."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from parallel_gcn_tpu_torch.optim import init_adam
    from parallel_gcn_tpu_torch.train import build_model, epoch_seeds, make_epoch_step

    cfg = _gat_config(5)
    model = build_model(cfg, dds)
    opt = init_adam(list(model.weights))
    step = make_epoch_step(model, cfg, dds)
    gen = torch.Generator().manual_seed(cfg.tpu.seed)
    for _ in range(2):
        step(opt, epoch_seeds(gen, model.n_layers, attention=True)).tolist()
    reps = 3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            step(opt, epoch_seeds(gen, model.n_layers, attention=True)).tolist()
        host_ms = (time.perf_counter() - t0) * 1e3 / reps
    by_kernel: dict = {}
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            by_kernel[evt.name] = by_kernel.get(evt.name, 0.0) + evt.device_time_total / 1e3 / reps
    dev_ms = sum(by_kernel.values())
    print(f"[profile] synth-reddit GAT ({' '.join(GAT_ARGS)}), {reps} epochs after 2 "
          f"warm-up: {host_ms:.3f} ms/epoch host clock, {dev_ms:.3f} ms/epoch device "
          f"time, device idle {100 * (1 - dev_ms / host_ms):.1f}%")
    if dev_ms == 0:
        print("[profile] the profiler saw no device time")
        return
    by_cat: dict = {}
    for name, ms in by_kernel.items():
        by_cat[_category(name)] = by_cat.get(_category(name), 0.0) + ms
    for cat, ms in sorted(by_cat.items(), key=lambda kv: -kv[1]):
        print(f"[profile]   {cat:28s} {ms:9.3f} ms/epoch {100 * ms / dev_ms:5.1f}%")
    for name, ms in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:10]:
        print(f"[profile]   kernel {ms:9.3f} ms/epoch  {name[:110]}")


def check_reference() -> None:
    """A small graph through the port's training on the card and on the CPU
    (plain versions), as a GCN and as a GAT on the tile backend with feature
    and attention dropout: metrics must agree. Both dropout masks (K1's
    Philox, the attention hash) depend only on seeds and indices."""
    import torch

    from parallel_gcn_tpu_torch.config import Config
    from parallel_gcn_tpu_torch.data.parser import to_device
    from parallel_gcn_tpu_torch.data.synthetic import make_synthetic_dataset
    from parallel_gcn_tpu_torch.ops import tile_attention
    from parallel_gcn_tpu_torch.train import fit

    ds = make_synthetic_dataset(
        "smoke", n_nodes=2000, n_edges=40_000, input_dim=64, n_classes=8,
        n_train=1200, n_val=300, feature_nnz_per_row=16, n_communities=20,
    )
    gcn = Config()
    gcn.gcn.hidden_dims, gcn.gcn.dropouts = (32,), (0.0, 0.1)
    gat = Config()
    gat.gcn.model, gat.gcn.heads, gat.gcn.hidden_dims = "gat", 2, (8,)
    gat.gcn.dropouts, gat.gcn.attn_dropout = (0.0, 0.3), 0.3
    for name, cfg in (("GCN", gcn), ("GAT", gat)):
        cfg.gcn.epochs, cfg.train.verbose = 3, False
        hist = {}
        for dev in ("cuda", "cpu"):
            dds = to_device(ds, device=torch.device(dev), hybrid=True, tile_dtype="int8",
                            tile_size=128, tile_cols=256)
            before = tile_attention.launches["gat_fwd"]
            hist[dev] = fit(cfg, dds).history
            if name == "GAT":
                ran = tile_attention.launches["gat_fwd"] > before
                assert ran == (dev == "cuda"), f"K5 launched on {dev}: {ran}"
        diff = float(abs(hist["cuda"] - hist["cpu"]).max())
        print(f"[reference] {name}: 2000-node hybrid int8 graph, 3 epochs: card vs "
              f"CPU plain max metric diff {diff:.3e}")
        assert diff < 2e-4, f"{name}: card and CPU trajectories differ by {diff}"


def _reset_counts() -> None:
    from parallel_gcn_tpu_torch.ops import cuda_bcsr, cuda_dropout, tile_attention

    for d in (cuda_dropout.launches, cuda_bcsr.launches, tile_attention.launches):
        for k in d:
            d[k] = 0


def _read_counts() -> dict:
    from parallel_gcn_tpu_torch.ops import cuda_bcsr, cuda_dropout, tile_attention

    return dict(K1=cuda_dropout.launches["dropout"],
                K2=cuda_dropout.launches["relu_dropout"],
                K3=cuda_bcsr.launches["bcsr"],
                K4=cuda_bcsr.launches["bcsr_scaled"],
                K5=tile_attention.launches["gat_fwd"],
                K6=tile_attention.launches["gat_bwd"])


def phase_main_path(tag: str, argv: list[str]) -> dict:
    """``cli.main(argv)`` with every launch count set to 0 just before it;
    checks the losses and returns the counts read just after."""
    from parallel_gcn_tpu_torch import cli

    buf = io.StringIO()
    _reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    secs = time.perf_counter() - t0
    counts = _read_counts()
    out = buf.getvalue()
    for line in out.splitlines():
        print(f"[{tag}] {line}")
    assert rc == 0, f"cli.main returned {rc}"
    losses = [float(m) for m in re.findall(r"^epoch=\d+ train_loss=(\S+)", out, re.M)]
    assert len(losses) == EPOCHS, f"expected {EPOCHS} epoch lines, got {len(losses)}"
    assert all(math.isfinite(v) for v in losses), losses
    assert losses[-1] < losses[0], f"train loss did not fall: {losses}"
    test_acc = float(re.search(r"test_acc=(\S+)", out).group(1))
    assert math.isfinite(test_acc), test_acc
    ms = float(re.search(r"avg_epoch_time=(\S+) ms", out).group(1))
    steady = [float(t) * 1e3 for t in re.findall(r"^epoch=\d+ .* time=(\S+)$", out, re.M)][1:]
    print(f"[{tag}] {' '.join(argv)} through cli.main in {secs:.1f} s: {ms:.3f} "
          f"ms/epoch ({sum(steady) / len(steady):.3f} over epochs 2-{EPOCHS}), train loss "
          f"{losses[0]:.5f} -> {losses[-1]:.5f}, test_acc {test_acc:.5f}, launches {counts}")
    return counts


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("error: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    repo = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, repo)
    import parallel_gcn_tpu_torch  # noqa: F401  (fails outside a checkout)
    from parallel_gcn_tpu_torch.config import default_params_path, load_config
    from parallel_gcn_tpu_torch.data.parser import prepare_device_dataset

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    kind = phase_device()
    phase_build()

    t0 = time.perf_counter()
    cfg = load_config(default_params_path("synth-reddit"))
    _, dds = prepare_device_dataset(cfg, "synth-reddit", torch.device("cuda"))
    torch.cuda.synchronize()
    pack = dds.graph.bcsr
    per_row = torch.bincount(pack.tile_rows.long(), minlength=pack.n_tile_rows)
    print(f"[setup] synth-reddit generated, reordered and packed in "
          f"{time.perf_counter() - t0:.1f} s: {pack.n_tiles} tiles "
          f"{pack.tile_r}x{pack.tile_c} int8 (max {int(per_row.max())} per tile-row, "
          f"{pack.schedule.n_seg} segments, {pack.schedule.multi_row.numel()} split rows), "
          f"{dds.graph.n_edges_pad} padded residual edges, n_pad {dds.graph.n_nodes}")

    results: dict = {}
    check_dropout(results)
    check_bcsr(results, dds.graph.bcsr, dds.x)
    check_tile_attention(results, dds.graph.bcsr)
    phase_profile_gat(dds)
    del dds
    torch.cuda.empty_cache()
    check_reference()

    gcn = phase_main_path("main-gcn", ["synth-reddit", f"epochs={EPOCHS}"])
    # per epoch: K2 once (layer 1's train forward); K4 forward, backward and
    # val eval; plus K4 once for the input pre-aggregation and once for test
    assert gcn["K2"] >= EPOCHS and gcn["K4"] >= 3 * EPOCHS + 2, gcn
    gat = phase_main_path("main-gat", ["synth-reddit", *GAT_ARGS, f"epochs={EPOCHS}",
                                       "mode=eager"])
    # per epoch: K5 for both layers in the train forward and the val eval,
    # plus both layers of the test eval; K6 for both layers' backward; K1 on
    # layer 1's train input (its backward reruns it)
    assert gat["K5"] >= 4 * EPOCHS + 2 and gat["K6"] >= 2 * EPOCHS, gat
    assert gat["K1"] >= EPOCHS, gat
    counts = dict(K1=gat["K1"], K2=gcn["K2"], K3=gcn["K3"] + gat["K3"], K4=gcn["K4"],
                  K5=gat["K5"], K6=gat["K6"])

    def entry(key, name, source, replaces):
        r = results[key]
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": counts[key], "max_abs_err": r["err"], "ms": r["ms"],
                "plain_ms": r["plain_ms"]}

    drop_src = "parallel_gcn_tpu_torch/csrc/dropout.cu"
    bcsr_src = "parallel_gcn_tpu_torch/csrc/bcsr_spmm.cu"
    attn_src = "parallel_gcn_tpu_torch/csrc/tile_attention.cu"
    print(json.dumps({
        "kernels": [
            entry("K1", "dropout", drop_src, "parallel_gcn_tpu/ops/pallas_dropout.py:30"),
            entry("K2", "relu_dropout", drop_src, "parallel_gcn_tpu/ops/pallas_dropout.py:142"),
            entry("K4", "bcsr_spmm_scaled", bcsr_src, "parallel_gcn_tpu/ops/pallas_bcsr.py:254"),
            entry("K5", "gat_fwd", attn_src, "parallel_gcn_tpu/ops/tile_attention.py:179"),
            entry("K6", "gat_bwd", attn_src, "parallel_gcn_tpu/ops/tile_attention.py:283"),
        ],
        # ported kernels that neither main path launches
        "off_path_kernels": [
            entry("K3", "bcsr_spmm", bcsr_src, "parallel_gcn_tpu/ops/pallas_bcsr.py:190"),
        ],
    }))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
