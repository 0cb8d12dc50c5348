#!/usr/bin/env python3
"""Time the fused kernels K9 and K10 of this checkout, and variants of
their sources, on one NVIDIA card at synth-reddit's shapes.

    python3 kernel_variants.py                        # every variant, base first and last
    python3 kernel_variants.py base no-philox base    # the named ones, in order

Each variant is a copy of ``parallel_gcn_tpu_torch/`` under
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

    def events_ms(fn, reps=20):
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

    def device_ms(fn, reps=20):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        return sum(e.device_time_total for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3 / reps

    def digest(t):
        return hashlib.sha1(t.detach().float().cpu().numpy().tobytes()).hexdigest()[:10]

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
        parts.append(f"{key} {events_ms(fn):.4f} ms{extra} ({digest(result)})")
    print(f"[variant] {name}: " + "; ".join(parts), flush=True)


def main(argv: list[str]) -> int:
    if argv[:1] == ["--time"]:
        time_tree(argv[1], argv[2])
        return 0
    names = argv or ["base", *[v for v in VARIANTS if v != "base"], "base"]
    unknown = [v for v in names if v not in VARIANTS]
    if unknown:
        print(f"error: unknown variants {unknown}; known: {list(VARIANTS)}")
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(f"[variant] card: {smi.stdout.strip()}")
    for name in names:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--time",
                               make_variant(name), name])
        if proc.returncode != 0:
            return proc.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
