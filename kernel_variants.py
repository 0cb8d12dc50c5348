#!/usr/bin/env python3
"""Time kernels of this checkout, and variants of their sources, on one
NVIDIA card at synth-reddit's shapes.

    python3 kernel_variants.py                        # both families below
    python3 kernel_variants.py fused                  # K9/K10: every variant, base first and last
    python3 kernel_variants.py base no-philox base    # K9/K10: the named ones, in order
    python3 kernel_variants.py spmm [--parent DIR]    # K3/K4: every variant in one process

K9/K10. Each variant is a copy of ``parallel_gcn_tpu_torch/`` under
``.smoke/variants/<name>/`` with the source edits listed in ``VARIANTS``,
built there by the package's own build and timed in a process of its own:
K9 (masked CE, train and eval variants, [233472, 41] f32 logits) and K10
(dropout⊗matmul forward, dW, dX, [233472, 600] bf16 × [600, 41], rate 0.1).
Times are CUDA events over 20 calls; K9's also by ``torch.profiler``
device time, which its short kernels need (the host's launch cost hides
them from events). Each line carries a hash of every output, so variants
that change only speed show the base's hashes.

``base`` is the checkout. The ``no-*`` and ``w-staged-once`` variants give
wrong results on purpose: each removes one cost from K10 to show its share.
``dw-splits-53`` is the first dW split count, ``k9-looped`` the first K9
(every row read from memory, as for C > 64).

K3/K4 (the tile SpMM, ``csrc/bcsr_spmm.cu``). Every source variant in
``SPMM_VARIANTS`` is an edited copy of that one file, all built at once
(nvcc in parallel) into ``.smoke/variants/spmm/``, and loaded in turn in
one process under the checkout's wrapper, on synth-reddit's own int8 pack:
K4 and K3 at F=41 bf16, K3 at F=600 bf16 (CUDA events over 10 calls, hashes
of the outputs). The base also sweeps the tiles per segment
(``SPMM_SEGMENT_TILES``); the CTA shape is a source variant.
``--parent DIR`` also times the K3/K4 of another checkout's package (e.g.
the parent commit unpacked with ``git archive``) in a process of its own.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
PKG = "parallel_gcn_tpu_torch"
MM = "csrc/dropout_matmul.cu"
_W_LOOP = ("    for (int e = tid; e < kTN * kMmaK; e += kMmaThreads) {"
           "  // W rows read coalesced")
_X_LOAD = """  if (len == 4 && aligned4(x + b)) {
    load4(x + b, xv);
  } else {
    for (int q = 0; q < len; ++q) xv[q] = to_float(x[b + q]);
  }"""
_NO_LOAD = "  xv[0] = xv[1] = xv[2] = xv[3] = 1.0f;"
_PHILOX = "const unsigned keep = mk.keep4(b);"
_NO_PHILOX = "const unsigned keep = 0xFu;"

# name -> [(file under the package, text, replacement)]
VARIANTS = {
    "base": [],
    "dw-splits-53": [("ops/cuda_fused.py", "_DW_BLOCKS = 16 * 132", "_DW_BLOCKS = 4 * 132")],
    "k9-looped": [("csrc/fused_ce.cu", "if (c <= kCachedCols) {", "if (false) {")],
    "no-philox": [(MM, _PHILOX, _NO_PHILOX)],
    "w-staged-once": [(MM, _W_LOOP, "    if (k0 == 0) " + _W_LOOP.lstrip())],
    "no-x-loads": [(MM, _X_LOAD, _NO_LOAD)],
    "no-x-loads-no-philox": [(MM, _X_LOAD, _NO_LOAD), (MM, _PHILOX, _NO_PHILOX)],
}


SPMM = "csrc/bcsr_spmm.cu"
# name -> [(text, replacement)] in csrc/bcsr_spmm.cu
_SHAPE = "using CtaShape = Shape<2, 64, 8, 2>;"
_COPY = "cp.async.cg.shared.global.L2::256B [%0], [%1], 16;"
_STEPS = "for (int s = 0; s < kSteps; ++s) {"
SPMM_VARIANTS = {
    # the pipeline and aligned x with the first kernel's CTA shape: 4 warps
    # of 16 rows and 64 features
    "pipeline-64-rows": [(_SHAPE, "using CtaShape = Shape<1, 64, 4, 1>;")],
    # one 512-row CTA per SM, of 8 warps (64 rows each) or 16 (32 rows each)
    "one-512-row-cta": [(_SHAPE, "using CtaShape = Shape<4, 64, 8, 1>;")],
    "one-cta-16-warps": [(_SHAPE, "using CtaShape = Shape<2, 64, 16, 1>;")],
    # 128 features a CTA (F > 64: 5 feature blocks at 600, not 10)
    "f128": [(_SHAPE, "using CtaShape = Shape<2, 128, 8, 1>;")],
    "stages-2": [("constexpr int kStages = 4;", "constexpr int kStages = 2;")],
    "stages-3": [("constexpr int kStages = 4;", "constexpr int kStages = 3;")],
    "no-l2-prefetch": [(_COPY, "cp.async.cg.shared.global [%0], [%1], 16;")],
    # every int8 byte through the signed conversion
    "signed-convert": [("if (a.nonneg) return", "if (false) return")],
    # wrong on purpose, each removes one cost: the int8 → bf16 conversion
    # (raw bytes as bf16 pairs), or all the compute (the ring alone)
    "no-convert": [("    lo = pack_bf16(v0 * dr, v1 * dr);\n    hi = pack_bf16(v2 * dr, v3 * dr);",
                    "    lo = w;\n    hi = w ^ 0x1000u;"),
                   ("    lo = bf16x2_minus_128(__byte_perm(w, 0x43434343u, 0x4140));\n"
                    "    hi = bf16x2_minus_128(__byte_perm(w, 0x43434343u, 0x4342));",
                    "    lo = w;\n    hi = w ^ 0x1000u;")],
    "loads-only": [(_STEPS, "for (int s = 0; s < 0; ++s) {")],
    "loads-only-no-l2-prefetch": [(_STEPS, "for (int s = 0; s < 0; ++s) {"),
                                  (_COPY, "cp.async.cg.shared.global [%0], [%1], 16;")],
}


def make_variant(name: str) -> str:
    """The variant's package root (a copy of the checkout's, edited)."""
    if name == "base":
        return ROOT
    dst = os.path.join(ROOT, ".smoke", "variants", name)
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(os.path.join(ROOT, PKG), os.path.join(dst, PKG),
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    for rel, old, new in VARIANTS[name]:
        path = os.path.join(dst, PKG, rel)
        with open(path) as f:
            text = f.read()
        if old not in text:
            raise ValueError(f"variant {name}: {rel} no longer holds {old!r}")
        with open(path, "w") as f:
            f.write(text.replace(old, new))
    return dst


def time_tree(root: str, name: str) -> None:
    """Import the package under ``root``, build it, time K9 and K10."""
    sys.path.insert(0, root)
    import torch
    from torch.profiler import ProfilerActivity, profile

    from parallel_gcn_tpu_torch.ops import _build
    from parallel_gcn_tpu_torch.ops import cuda_ce as ce
    from parallel_gcn_tpu_torch.ops import cuda_fused as cf

    assert os.path.abspath(ce.__file__).startswith(os.path.abspath(root)), ce.__file__
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.load_library()

    def device_ms(fn, reps=20):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        return sum(e.device_time_total for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3 / reps

    gen = torch.Generator().manual_seed(0)
    n = 233472
    logits = (3 * torch.randn((n, 41), generator=gen)).cuda()
    labels = torch.randint(0, 41, (n,), generator=gen)
    labels[232965:] = -1
    split = torch.randint(1, 4, (n,), generator=gen)
    split[232965:] = 0
    labels, split = labels.cuda(), split.cuda()
    x = torch.randn((n, 600), generator=gen).bfloat16().cuda()
    w = ((torch.rand((600, 41), generator=gen) * 2 - 1) * 0.0988).bfloat16().cuda()
    g = (torch.randn((n, 41), generator=gen) / n).cuda()
    seed, rate = 0x0F1E_2D3C_4B5A_6978, 0.1
    calls = {}
    for key, s, train, out in (("K9 train", 1, True, 2), ("K9 eval", 2, False, 0)):
        mask = split == s
        num = int(mask.sum())
        calls[key] = ((lambda m=mask, c=num, t=train: ce._run(logits, labels, m, c, t)), out)
    calls["K10 fwd"] = (lambda: cf._fwd(x, w, seed, rate), None)
    calls["K10 dW"] = (lambda: cf._dw(x, g, seed, rate, torch.bfloat16), None)
    calls["K10 dX"] = (lambda: cf._dx(g, w, seed, rate, torch.bfloat16), None)
    parts = []
    for key, (fn, out) in calls.items():
        result = fn() if out is None else fn()[out]
        extra = f", device {device_ms(fn):.4f}" if key.startswith("K9") else ""
        parts.append(f"{key} {_events_ms(torch, fn, 20):.4f} ms{extra} ({_digest(result)})")
    print(f"[variant] {name}: " + "; ".join(parts), flush=True)


def _spmm_inputs(torch):
    """synth-reddit's int8 pack on the card and the inputs of K3/K4."""
    from parallel_gcn_tpu_torch.config import default_params_path, load_config
    from parallel_gcn_tpu_torch.data.parser import prepare_device_dataset

    cfg = load_config(default_params_path("synth-reddit"))
    _, dds = prepare_device_dataset(cfg, "synth-reddit", torch.device("cuda"))
    gen = torch.Generator().manual_seed(2)
    n = dds.graph.bcsr.n_nodes
    x41 = torch.randn((n, 41), generator=gen).to(torch.bfloat16).cuda()
    x600 = torch.randn((n, 600), generator=gen).to(torch.bfloat16).cuda()
    return dds.graph.bcsr, x41, x600


def _events_ms(torch, fn, reps=10):
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def _digest(t):
    return hashlib.sha1(t.detach().float().cpu().numpy().tobytes()).hexdigest()[:10]


def _time_spmm(torch, cb, pack, x41, x600) -> str:
    import dataclasses

    pattern = dataclasses.replace(pack, sym_scale=None)
    parts = []
    for key, pk, x in (("K4 F=41", pack, x41), ("K3 F=41", pattern, x41),
                       ("K3 F=600", pattern, x600)):
        out = cb.bcsr_matmul_impl(pk, x)
        parts.append(f"{key} {_events_ms(torch, lambda: cb.bcsr_matmul_impl(pk, x)):.4f} ms "
                     f"({_digest(out)})")
    return "; ".join(parts)


def spmm_family(parent: str | None) -> int:
    """K3/K4 of the checkout, its source variants and knob settings, and of
    ``parent``'s package."""
    import ctypes
    import dataclasses
    import threading

    import torch

    sys.path.insert(0, ROOT)
    from parallel_gcn_tpu_torch.ops import _build
    from parallel_gcn_tpu_torch.ops import cuda_bcsr as cb

    torch.backends.cuda.matmul.allow_tf32 = False
    out_dir = os.path.join(ROOT, ".smoke", "variants", "spmm")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    with open(os.path.join(ROOT, PKG, SPMM)) as f:
        text = f.read()
    libs, errors = {}, {}

    def build(name, edits):
        src = os.path.join(out_dir, f"{name}.cu")
        edited = text
        for old, new in edits:
            if old not in edited:
                errors[name] = f"{SPMM} no longer holds {old!r}"
                return
            edited = edited.replace(old, new)
        with open(src, "w") as f:
            f.write(edited)
        try:
            _build._run_nvcc([src], os.path.join(out_dir, f"lib{name}.so"))
            libs[name] = os.path.join(out_dir, f"lib{name}.so")
        except RuntimeError as e:
            errors[name] = str(e)

    # every variant's nvcc at once, while the checkout builds and the data loads
    threads = [threading.Thread(target=build, args=item) for item in SPMM_VARIANTS.items()]
    for t in threads:
        t.start()
    base = _build.load_library()
    pack, x41, x600 = _spmm_inputs(torch)
    for t in threads:
        t.join()
    if errors:
        print(f"[spmm-variant] build failures: {errors}")
        return 1
    print(f"[spmm-variant] synth-reddit pack: {pack.n_tiles} tiles "
          f"{pack.tile_r}x{pack.tile_c} int8", flush=True)
    rows_np = pack.tile_rows.cpu().numpy()

    def with_segments(tiles: int):
        sched = cb.tile_schedule(rows_np, pack.n_tile_rows, tiles).to(pack.tiles.device)
        return dataclasses.replace(pack, spmm_schedule=sched)

    print(f"[spmm-variant] base (segments of {cb.SPMM_SEGMENT_TILES}): "
          f"{_time_spmm(torch, cb, pack, x41, x600)}", flush=True)
    xp_ms = _events_ms(torch, lambda: cb.pad_features(x41))
    print(f"[spmm-variant] x41 padded to 48 bf16 features (the wrapper's copy): "
          f"{xp_ms:.4f} ms", flush=True)
    for tiles in (2, 4, 8):
        print(f"[spmm-variant] base, segments of {tiles}: "
              f"{_time_spmm(torch, cb, with_segments(tiles), x41, x600)}", flush=True)
    for name, path in libs.items():
        lib = ctypes.CDLL(path)
        lib.pgcn_bcsr_spmm.argtypes = base.pgcn_bcsr_spmm.argtypes
        lib.pgcn_bcsr_spmm.restype = base.pgcn_bcsr_spmm.restype
        _build._lib = lib
        print(f"[spmm-variant] {name}: {_time_spmm(torch, cb, pack, x41, x600)}", flush=True)
    _build._lib = base
    print(f"[spmm-variant] base again: {_time_spmm(torch, cb, pack, x41, x600)}", flush=True)
    if parent:
        del pack, x41, x600
        torch.cuda.empty_cache()
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--time-spmm",
                               os.path.abspath(parent)])
        return proc.returncode
    return 0


def time_spmm_tree(root: str) -> None:
    """K3/K4 of the package under ``root`` (another checkout)."""
    sys.path.insert(0, root)
    import torch

    from parallel_gcn_tpu_torch.ops import _build
    from parallel_gcn_tpu_torch.ops import cuda_bcsr as cb

    assert os.path.abspath(cb.__file__).startswith(os.path.abspath(root)), cb.__file__
    _build.load_library()
    pack, x41, x600 = _spmm_inputs(torch)
    print(f"[spmm-variant] {root}: {_time_spmm(torch, cb, pack, x41, x600)}", flush=True)


def main(argv: list[str]) -> int:
    if argv[:1] == ["--time"]:
        time_tree(argv[1], argv[2])
        return 0
    if argv[:1] == ["--time-spmm"]:
        time_spmm_tree(argv[1])
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(f"[variant] card: {smi.stdout.strip()}", flush=True)
    if argv[:1] == ["spmm"]:
        return spmm_family(argv[argv.index("--parent") + 1] if "--parent" in argv else None)
    if not argv:
        rc = spmm_family(None)
        if rc:
            return rc
    elif argv[0] == "fused":
        argv = argv[1:]
    names = argv or ["base", *[v for v in VARIANTS if v != "base"], "base"]
    unknown = [v for v in names if v not in VARIANTS]
    if unknown:
        print(f"error: unknown variants {unknown}; known: {list(VARIANTS)}")
        return 2
    for name in names:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--time",
                               make_variant(name), name])
        if proc.returncode != 0:
            return proc.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
