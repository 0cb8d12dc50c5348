#!/usr/bin/env python3
"""Time kernels of this checkout, and variants of their sources, on one
NVIDIA card at synth-reddit's shapes.

    python3 kernel_variants.py                        # the spmm and fused families below
    python3 kernel_variants.py fused [--parent DIR]   # K9/K10: every variant in one process
    python3 kernel_variants.py spmm [--parent DIR]    # K3/K4: every variant in one process

K9/K10 (``csrc/fused_ce.cu``, ``csrc/dropout_matmul.cu``). Every source
variant in ``FUSED_VARIANTS`` is an edited copy of the two files, built
together (nvcc in parallel, all variants at once) into
``.smoke/variants/fused/`` and loaded in turn in one process under the
checkout's wrappers: K9 (masked CE, train and eval variants, [233472, 41]
f32 logits) and K10 (dropout⊗matmul forward, dW, dX, [233472, 600] bf16 ×
[600, 41], rate 0.1), CUDA events over 20 wrapper calls and the device
time of every kernel a call launches (``torch.profiler``), with hashes of
the outputs, so variants that change only speed show the base's hashes.
``FUSED_KNOBS`` are settings of the checkout's wrapper (dW's slab width).
The design steps are the forward's ring depth and row tile, dW's ring
depth and slab width, K9's staged rows against its looped path; the
wrong-on-purpose variants each remove one cost (Philox, the products, the
X stream, dX's split terms) to show its share. ``--parent DIR`` times the
K9/K10 of another checkout's package (``--time-fused DIR``) in a process
of its own.

K3/K4 (the tile SpMM, ``csrc/bcsr_spmm.cu``). Every source variant in
``SPMM_VARIANTS`` is an edited copy of that one file, all built at once
(nvcc in parallel) into ``.smoke/variants/spmm/``, and loaded in turn in
one process under the checkout's wrapper, on synth-reddit's own int8 pack:
K4 and K3 at F=41 bf16, K3 at F=600 bf16 (CUDA events over 10 calls, hashes
of the outputs). The base also sweeps the tiles per segment
(``SPMM_SEGMENT_TILES``); the CTA shape is a source variant.
``--parent DIR`` also times the K3/K4 of another checkout's package (e.g.
the parent commit unpacked with ``git archive``) in a process of its own.

    python3 kernel_variants.py rowsum                     # the COO residual's row sums
    python3 kernel_variants.py attention [--parent DIR]   # K5/K6: every variant in one process
    python3 kernel_variants.py rect [--parent DIR]        # K7: every variant in one process
    python3 kernel_variants.py dropout [--parent DIR]     # K1/K2: every variant in one process

K5/K6 (the GAT tile attention, ``csrc/tile_attention.cu``) in the same
way: every source variant in ``ATTN_VARIANTS`` is an edited copy of that
file (with its header beside it), all built at once into
``.smoke/variants/attention/`` and loaded in turn in one process, on
synth-reddit's own int8 pack at the GAT's shapes (heads 2, d 32 and 41,
bf16, attention dropout 0): each wrapper call, and for the checkout the
library call alone (its padded copies, the walk and the merge, without the
wrapper's torch work), by CUDA events over 10 calls, with hashes of the
outputs; the base is also checked against the plain versions, and the
live-column index's build is timed. ``--parent`` times K5/K6 of another
checkout's package (``--time-attention DIR`` alone) in a process of its own.

K7 (the mesh GAT backward, ``csrc/tile_attention_rect.cu``) in the same
way, on rank 0's GAT slabs of synth-reddit's mesh partition at one rank and
at 4 ranks (boundary halo), heads 2, d 32 and 41, bf16, attention dropout 0:
each sweep's wrapper call and, for the checkout, the library call alone
(the records and padded rows prepared once). ``RECT_VARIANTS`` holds the
knobs (min blocks, warp steps in flight, ``__expf``) and variants that are
wrong on purpose, each removing one cost. ``--parent`` times K7 of another
checkout (``--time-rect DIR``).

K1/K2 (``csrc/dropout.cu``) in the same way at the main paths' bf16 shapes
[233472, 64] and [233472, 600], rate 0.1: CUDA events over 20 wrapper calls
and the kernel's device time by ``torch.profiler``, beside
``torch.nn.functional.dropout``, and a K1 call's cost by layer (autograd
Function, wrapper, library call) at the small shape, where the host's share
shows. ``DROP_VARIANTS`` are the design steps:
the vector width (every element through the scalar path), the loads in
flight, the grid, streaming cache hints, and the Philox rounds removed
(wrong on purpose). ``--parent`` times another checkout's K1/K2
(``--time-dropout DIR``).
"""

from __future__ import annotations

import glob
import hashlib
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
PKG = "parallel_gcn_tpu_torch"
MM = "csrc/dropout_matmul.cu"
CE = "csrc/fused_ce.cu"
_ALL = "make_uint2(0xFFFFFFFFu, 0xFFFFFFFFu)"
_FWD_KEEP = [(MM, "keep_masks<kAl4>(mk, b0 + 16 * s)", _ALL),
             (MM, "keep_masks<kAl4>(mk, b0 + 8 * (int64_t)k + 16 * s)", _ALL)]
_DW_KEEP = [(MM, "mask4(make_uint2(v.x, v.y), keep_masks<kAl4>(mk, b), ik2);",
             f"mask4(make_uint2(v.x, v.y), {_ALL}, ik2);"),
            (MM, "mask4(make_uint2(v.z, v.w), keep_masks<kAl4>(mk, b + 4), ik2);",
             f"mask4(make_uint2(v.z, v.w), {_ALL}, ik2);")]
_DX_KEEP = [(MM, "const unsigned bits = keep4<kAl4>(mk, bidx);", "const unsigned bits = 0xFu;")]
_NO_MMA = [(MM, """  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));""",
            "  c[0] += __uint_as_float(a0 ^ a1 ^ a2 ^ a3 ^ b0 ^ b1);")]
_NO_X = [(MM, "      cp_async16(dst, ok ? x + row * k + col : x, ok ? 16 : 0);\n    } else {", "    } else {")]


def _const(name: str, value: int) -> tuple:
    """An edit of ``constexpr int name = ...;`` in csrc/dropout_matmul.cu."""
    import re

    with open(os.path.join(ROOT, PKG, MM)) as f:
        line = re.search(rf"constexpr int {name} = [^;]*;", f.read()).group(0)
    return (MM, line, f"constexpr int {name} = {value};")


# name -> [(file under the package, text, replacement)]: K9/K10 source
# variants, built together with the checkout's other source and loaded in
# turn under the checkout's wrappers
FUSED_VARIANTS = {
    # design steps: the forward's ring depth (stages a warp) and warps a
    # block (8: 128 rows of X a block, half the warps an SM); dW's ring
    # depth and row tile (32-row stages, 4 deep); dX's stores (plain, not
    # evict-first), its pair loop not unrolled (one pair's mma chains in
    # flight, not two), each column half's pairs contiguous rather than
    # interleaved;
    # K9 with every C on the looped (warp-per-row, from memory) path
    "fwd-stages-2": lambda: [_const("kFwdStages", 2)],
    "fwd-stages-3": lambda: [_const("kFwdStages", 3)],
    "fwd-stages-5": lambda: [_const("kFwdStages", 5)],
    "fwd-8-warps": lambda: [_const("kFwdWarps", 8)],
    "dw-stages-3": lambda: [_const("kDwStages", 3)],
    "dw-rows-32": lambda: [_const("kDwRows", 32), _const("kDwStages", 4)],
    "dx-plain-stores": lambda: [(MM, "__stcs(reinterpret_cast<uint2*>(dx + bidx),\n"
                                 "                     make_uint2(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3])));",
                                 "*reinterpret_cast<uint2*>(dx + bidx) =\n"
                                 "                  make_uint2(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]));")],
    "dx-no-unroll": lambda: [(MM, "#pragma unroll 2  // two pairs' mma chains in flight\n", "")],
    "dx-halves-contiguous": lambda: [(MM, "for (int pr = half; pr < pairs; pr += 2) {",
                                      "for (int pr = half * ((pairs + 1) / 2); "
                                      "pr < min(pairs, (half + 1) * ((pairs + 1) / 2)); ++pr) {")],
    "k9-looped": lambda: [(CE, "if (c <= kStagedCols) {", "if (false) {")],
    # wrong on purpose, each removes one cost: Philox (every element kept),
    # the products (a cheap stand-in keeps the fragments live), both; the
    # forward's X stream (no copies: the ring holds stale bytes) and its W
    # staging; dX's stores, its products and Philox (the stores alone), its
    # whole pair loop (the g ring and fragment build alone), its second and
    # third split terms
    "no-philox": lambda: _FWD_KEEP + _DW_KEEP + _DX_KEEP,
    "no-mma": lambda: list(_NO_MMA),
    "no-philox-no-mma": lambda: _FWD_KEEP + _DW_KEEP + _DX_KEEP + _NO_MMA,
    "no-x-stream": lambda: list(_NO_X),
    "no-w-staging": lambda: [(MM, "        wf32[e] = v;\n", "")],
    "dx-no-stores": lambda: [(MM, "            if (kAl4) {\n              __stcs(",
                              "            if (v[0] == 1234.5f) {\n              __stcs("),
                             (MM, "                if (col + t < k) dx[bidx + t]",
                              "                if (v[t] == 1234.5f) dx[bidx + t]")],
    "dx-stores-only": lambda: _DX_KEEP + [(MM, "for (int t = 0; t < 3; ++t) {",
                                           "for (int t = 0; t < 0; ++t) {")],
    "dx-no-pairs": lambda: [(MM, "for (int pr = half; pr < pairs; pr += 2) {",
                             "for (int pr = half; pr < 0; pr += 2) {")],
    "dx-one-term": lambda: [(MM, "for (int t = 0; t < 3; ++t) {", "for (int t = 2; t < 3; ++t) {")],
}
# name -> {attribute of ops/cuda_fused.py: value}: knobs of the checkout's
# wrapper, timed with the checkout's library (dW's slab width at most)
FUSED_KNOBS = {"dw-slab-128": {"_DW_MAX_SLAB": 128}, "dw-slab-192": {"_DW_MAX_SLAB": 192},
               "dw-slab-256": {"_DW_MAX_SLAB": 256}}


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


ATTN = "csrc/tile_attention.cu"
_FWD_V = "x[u][k].load(v + (size_t)c * S + tm.offset(k, P));"
_BWD_V = "            xv[u][k].load(vp + (size_t)c * S + tm.offset(k, P));\n"
_BWD_G = "            xg[u][k].load(gp + (size_t)c * S + tm.offset(k, P));\n"
_NO_ROWS = [(_FWD_V, "x[u][k].zero();"), (_BWD_V, ""), (_BWD_G, "")]
_NO_EXPS = [("const float w = live ? expf(e - m_new) : 0.0f;", "const float w = live ? 1.0f : 0.0f;"),
            ("const float a = expf(leaky(pre, slope) - m_i[h]) / den_i[h];",
             "const float a = 1.0f;"),
            ("const float a_m = expf(leaky(pre_m, slope) - rec[5 * h + 2]) / rec[5 * h + 3];",
             "const float a_m = 1.0f;")]
_NO_NODES = [("load_heads<kH>(t + (size_t)col * H, H, t_j);",
              "for (int h = 0; h < kH; ++h) t_j[h] = 0.0f;"),
             ("const float4 a = __ldg(n_j + i);", "const float4 a = make_float4(0.f, 0.f, 0.f, 1.f);")]


def _knob(name: str, value: int) -> tuple:
    old = {"kFwdBlocks": "constexpr int kFwdBlocks = 2;", "kBwdBlocks": "constexpr int kBwdBlocks = 3;",
           "kFwdUnroll": "constexpr int kFwdUnroll = 4;",
           "kBwdUnroll": "constexpr int kBwdUnroll = 2;"}[name]
    return (old, old.rsplit("=", 1)[0] + f"= {value};")


# name -> [(text, replacement)] in csrc/tile_attention.cu
ATTN_VARIANTS = {
    # min blocks per SM in __launch_bounds__ (register caps 128/85/64/51/42)
    "fwd-blocks-3": [_knob("kFwdBlocks", 3)],
    "fwd-blocks-4": [_knob("kFwdBlocks", 4)],
    "bwd-blocks-2": [_knob("kBwdBlocks", 2)],
    "bwd-blocks-4": [_knob("kBwdBlocks", 4)],
    # warp steps whose row gathers are issued together
    "fwd-unroll-1": [_knob("kFwdUnroll", 1)],
    "fwd-unroll-2": [_knob("kFwdUnroll", 2)],
    "fwd-unroll-8": [_knob("kFwdUnroll", 8)],
    "bwd-unroll-1": [_knob("kBwdUnroll", 1)],
    "bwd-unroll-4": [_knob("kBwdUnroll", 4)],
    # the hardware's approximate exp (ex2.approx of a prescaled argument)
    "fast-exp": [("expf(", "__expf(")],
    # wrong on purpose, each removes one cost: the v_j / g_j row gathers;
    # the exps (and K6's divisions); and everything but the index walk
    # (no row or t_j / node_j gathers, no exps)
    "no-row-gathers": _NO_ROWS,
    "no-exps": _NO_EXPS,
    "index-only": _NO_ROWS + _NO_EXPS + _NO_NODES,
}


RECT = "csrc/tile_attention_rect.cu"
_ROW_V = "xv[u][k].load(vp + (size_t)c * S + tm.offset(k, P));"
_COL_G = "xg[u][k].load(gp + (size_t)c * S + tm.offset(k, P));"
_RECT_EXP = "const float a = expf(leaky(pre, slope) - m_i[h]) / den_i[h];"
_RECT_NODES = [("load_heads<kH>(t + (size_t)col * H, H, t_j);",
                "for (int h = 0; h < kH; ++h) t_j[h] = 0.0f;"),
               ("load_records<kH>(nd + (size_t)col * 4 * H, H, s_i, m_i, den_i, rho_i);",
                "for (int h = 0; h < kH; ++h) s_i[h] = m_i[h] = rho_i[h] = 0.0f, den_i[h] = 1.0f;")]


def _rect_knob(name: str, value: int) -> tuple:
    old = {"kRowBlocks": "constexpr int kRowBlocks = 4;",
           "kColBlocks": "constexpr int kColBlocks = 3;",
           "kRowUnroll": "constexpr int kRowUnroll = 4;",
           "kColUnroll": "constexpr int kColUnroll = 2;"}[name]
    return (old, old.rsplit("=", 1)[0] + f"= {value};")


# name -> [(text, replacement)] in csrc/tile_attention_rect.cu
RECT_VARIANTS = {
    # min blocks per SM in __launch_bounds__
    "row-blocks-2": [_rect_knob("kRowBlocks", 2)],
    "row-blocks-3": [_rect_knob("kRowBlocks", 3)],
    "row-blocks-5": [_rect_knob("kRowBlocks", 5)],
    "col-blocks-2": [_rect_knob("kColBlocks", 2)],
    "col-blocks-4": [_rect_knob("kColBlocks", 4)],
    # warp steps whose row gathers are issued together
    "row-unroll-2": [_rect_knob("kRowUnroll", 2)],
    "row-unroll-8": [_rect_knob("kRowUnroll", 8)],
    "col-unroll-1": [_rect_knob("kColUnroll", 1)],
    "col-unroll-4": [_rect_knob("kColUnroll", 4)],
    "fast-exp": [("expf(", "__expf(")],
    # wrong on purpose, each removes one cost: the v_j / g_i row gathers; the
    # exps and divisions; and everything but the index walk (no row, t_j or
    # record gathers, no exps)
    "no-row-gathers": [(_ROW_V, "xv[u][k].zero();"), (_COL_G, "xg[u][k].zero();")],
    "no-exps": [(_RECT_EXP, "const float a = 1.0f;")],
    "index-only": [(_ROW_V, "xv[u][k].zero();"), (_COL_G, "xg[u][k].zero();"),
                   (_RECT_EXP, "const float a = 1.0f;"), *_RECT_NODES],
}

DROP = "csrc/dropout.cu"
_WAVE = "constexpr int kWaves = 8;"
_UNROLL = "constexpr int kUnroll = 4;"
# name -> [(text, replacement)] in csrc/dropout.cu
DROP_VARIANTS = {
    # the vector width: every element through the scalar path, one Philox
    # counter (4 scalar loads and stores) a thread, as the first kernel
    "scalar": [("  const int64_t n_vec = aligned ? n / kVec : 0;", "  const int64_t n_vec = 0;")],
    # vectors whose loads a thread issues before their Philox rounds
    "unroll-1": [(_UNROLL, "constexpr int kUnroll = 1;")],
    "unroll-2": [(_UNROLL, "constexpr int kUnroll = 2;")],
    "unroll-8": [(_UNROLL, "constexpr int kUnroll = 8;")],
    # the grid: 1 to 16 waves of the card's resident blocks, and the first
    # kernel's literal 132·64
    "grid-1-wave": [(_WAVE, "constexpr int kWaves = 1;")],
    "grid-2-waves": [(_WAVE, "constexpr int kWaves = 2;")],
    "grid-4-waves": [(_WAVE, "constexpr int kWaves = 4;")],
    "grid-16-waves": [(_WAVE, "constexpr int kWaves = 16;")],
    "grid-132x64": [("  *blocks = kWaves * sms * (per_sm > 0 ? per_sm : 1);",
                     "  *blocks = 132 * 64;")],
    # 8 blocks of 256 threads an SM at most 32 registers
    "min-blocks-8": [("__global__ void __launch_bounds__(kThreads)\ndropout_kernel",
                      "__global__ void __launch_bounds__(kThreads, 8)\ndropout_kernel")],
    # streaming cache hints on the vector loads and stores
    "streaming": [("raw[u] = __ldg(xv + v);", "raw[u] = __ldcs(xv + v);"),
                  ("ov[v] = Vec<T>::put(f);", "__stcs(ov + v, Vec<T>::put(f));")],
    # wrong on purpose: no Philox rounds (a fixed word), to show their share
    "no-philox": [("const uint4 b = philox4x32_10(ctr0 + (uint64_t)v * kCtr + c, k0, k1);",
                   "const uint4 b = make_uint4(0u, 0u, 0u, 0u);")],
}


def _start_builds(src, variants: dict, family: str):
    """Build every variant of ``src`` (a file under the package, or a tuple
    of them, edited as ``variants`` lists: (text, replacement) pairs in the
    one file, or (file, text, replacement) triples; the package's headers
    beside them) into ``.smoke/variants/<family>/``, each nvcc in a thread
    of its own, all at once. Returns a function that waits for them and
    gives ({name: (library, ptxas log)}, {name: error})."""
    import threading

    from parallel_gcn_tpu_torch.ops import _build

    srcs = (src,) if isinstance(src, str) else tuple(src)
    out_dir = os.path.join(ROOT, ".smoke", "variants", family)
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    texts = {}
    for rel in srcs:
        with open(os.path.join(ROOT, PKG, rel)) as f:
            texts[rel] = f.read()
    libs, errors = {}, {}

    def build(name, edits):
        vdir = os.path.join(out_dir, name)
        os.makedirs(vdir)
        for header in glob.glob(os.path.join(ROOT, PKG, "csrc", "*.cuh")):
            shutil.copy(header, vdir)
        edited = dict(texts)
        for edit in edits:
            rel, old, new = edit if len(edit) == 3 else (srcs[0], *edit)
            if old not in edited[rel]:
                errors[name] = f"{rel} no longer holds {old!r}"
                return
            edited[rel] = edited[rel].replace(old, new)
        paths = []
        for rel, text in edited.items():
            paths.append(os.path.join(vdir, os.path.basename(rel)))
            with open(paths[-1], "w") as f:
                f.write(text)
        lib = os.path.join(out_dir, f"lib{name}.so")
        try:
            libs[name] = (lib, _build._run_nvcc(paths, lib))
        except RuntimeError as e:
            errors[name] = str(e)

    threads = [threading.Thread(target=build, args=item) for item in variants.items()]
    for t in threads:
        t.start()

    def join():
        for t in threads:
            t.join()
        return libs, errors

    return join


def _load_variant(path: str, base, fns) -> None:
    """Make the variant library at ``path`` the package's kernel library,
    with ``base``'s ctypes signatures for ``fns``."""
    import ctypes

    from parallel_gcn_tpu_torch.ops import _build

    lib = ctypes.CDLL(path)
    for fn in fns:
        getattr(lib, fn).argtypes = getattr(base, fn).argtypes
        getattr(lib, fn).restype = getattr(base, fn).restype
    _build._lib = lib


def _run_parent(flag: str, parent: str) -> int:
    return subprocess.run([sys.executable, os.path.abspath(__file__), flag,
                           os.path.abspath(parent)]).returncode


def _fused_inputs(torch):
    """K9's logits, labels and split masks and K10's x, w and g at
    synth-reddit's shapes."""
    gen = torch.Generator().manual_seed(0)
    n = 233472
    logits = (3 * torch.randn((n, 41), generator=gen)).cuda()
    labels = torch.randint(0, 41, (n,), generator=gen)
    labels[232965:] = -1
    split = torch.randint(1, 4, (n,), generator=gen)
    split[232965:] = 0
    x = torch.randn((n, 600), generator=gen).bfloat16().cuda()
    w = ((torch.rand((600, 41), generator=gen) * 2 - 1) * 0.0988).bfloat16().cuda()
    g = (torch.randn((n, 41), generator=gen) / n).cuda()
    return dict(logits=logits, labels=labels.cuda(), split=split.cuda(), x=x, w=w, g=g)


def _device_total_ms(torch, fn, reps=20) -> float:
    """Device ms per call of ``fn``, every kernel it launches, by
    ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.device_time_total for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3 / reps


def _time_fused(torch, ce, cf, t) -> str:
    """K9 (train, eval) and K10 (fwd, dW, dX) at synth-reddit's shapes:
    CUDA events over 20 wrapper calls and device time by the profiler, with
    hashes of the outputs."""
    seed, rate = 0x0F1E_2D3C_4B5A_6978, 0.1
    calls = {}
    for key, s, train, out in (("K9 train", 1, True, 2), ("K9 eval", 2, False, 0)):
        mask = t["split"] == s
        num = int(mask.sum())
        calls[key] = ((lambda m=mask, c=num, tr=train: ce._run(t["logits"], t["labels"], m, c, tr)),
                      out)
    x, w, g = t["x"], t["w"], t["g"]
    calls["K10 fwd"] = (lambda: cf._fwd(x, w, seed, rate), None)
    calls["K10 dW"] = (lambda: cf._dw(x, g, seed, rate, torch.bfloat16), None)
    calls["K10 dX"] = (lambda: cf._dx(g, w, seed, rate, torch.bfloat16), None)
    parts = []
    for key, (fn, out) in calls.items():
        result = fn() if out is None else fn()[out]
        parts.append(f"{key} {_events_ms(torch, fn, 20):.4f} ms (device "
                     f"{_device_total_ms(torch, fn):.4f}; {_digest(result)})")
    return "; ".join(parts)


_PTXAS_FUSED = (("fwd_mma_kernelILb1E", "fwd"), ("dw_mma_kernelILb1E", "dW"),
                ("dx_mma_kernelILi3ELb1E", "dX m<=48"), ("ce_kernelILb1El", "K9 train"))


def fused_family(parent: str | None) -> int:
    """K9/K10 of the checkout, its source variants and wrapper knobs, and of
    ``parent``'s package."""
    import torch

    sys.path.insert(0, ROOT)
    from parallel_gcn_tpu_torch.ops import _build
    from parallel_gcn_tpu_torch.ops import cuda_ce as ce
    from parallel_gcn_tpu_torch.ops import cuda_fused as cf

    torch.backends.cuda.matmul.allow_tf32 = False
    join = _start_builds((MM, CE), {k: v() for k, v in FUSED_VARIANTS.items()}, "fused")
    base = _build.load_library()
    inputs = _fused_inputs(torch)
    libs, errors = join()
    print(f"[fused-variant] base ptxas: {_ptxas(_build.build_info['log'], _PTXAS_FUSED)}")
    for name, err in errors.items():
        print(f"[fused-variant] {name} not built: {err}")
    fns = ["pgcn_masked_ce", "pgcn_dropout_matmul_fwd", "pgcn_dropout_matmul_dw",
           "pgcn_dropout_matmul_dw_blocks", "pgcn_dropout_matmul_dx"]
    print(f"[fused-variant] base: {_time_fused(torch, ce, cf, inputs)}", flush=True)
    for name, knobs in FUSED_KNOBS.items():
        old = {k: getattr(cf, k) for k in knobs}
        for k, v in knobs.items():
            setattr(cf, k, v)
        print(f"[fused-variant] {name}: {_time_fused(torch, ce, cf, inputs)}", flush=True)
        for k, v in old.items():
            setattr(cf, k, v)
    for name, (path, log) in libs.items():
        _load_variant(path, base, fns)
        print(f"[fused-variant] {name}: {_time_fused(torch, ce, cf, inputs)} "
              f"[ptxas: {_ptxas(log, _PTXAS_FUSED)}]", flush=True)
    _build._lib = base
    print(f"[fused-variant] base again: {_time_fused(torch, ce, cf, inputs)}", flush=True)
    if parent:
        del inputs
        torch.cuda.empty_cache()
        return _run_parent("--time-fused", parent) or int(bool(errors))
    return int(bool(errors))


def time_fused_tree(root: str) -> None:
    """K9/K10 of the package under ``root`` (another checkout)."""
    sys.path.insert(0, root)
    import torch

    from parallel_gcn_tpu_torch.ops import _build
    from parallel_gcn_tpu_torch.ops import cuda_ce as ce
    from parallel_gcn_tpu_torch.ops import cuda_fused as cf

    assert os.path.abspath(cf.__file__).startswith(os.path.abspath(root)), cf.__file__
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.load_library()
    inputs = _fused_inputs(torch)
    print(f"[fused-variant] {root}: {_time_fused(torch, ce, cf, inputs)}", flush=True)


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
    import dataclasses

    import torch

    sys.path.insert(0, ROOT)
    from parallel_gcn_tpu_torch.ops import _build
    from parallel_gcn_tpu_torch.ops import cuda_bcsr as cb

    torch.backends.cuda.matmul.allow_tf32 = False
    # every variant's nvcc at once, while the checkout builds and the data loads
    join = _start_builds(SPMM, SPMM_VARIANTS, "spmm")
    base = _build.load_library()
    pack, x41, x600 = _spmm_inputs(torch)
    libs, errors = join()
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
    for name, (path, _) in libs.items():
        _load_variant(path, base, ["pgcn_bcsr_spmm"])
        print(f"[spmm-variant] {name}: {_time_spmm(torch, cb, pack, x41, x600)}", flush=True)
    _build._lib = base
    print(f"[spmm-variant] base again: {_time_spmm(torch, cb, pack, x41, x600)}", flush=True)
    if parent:
        del pack, x41, x600
        torch.cuda.empty_cache()
        return _run_parent("--time-spmm", parent)
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


def _attention_inputs(torch):
    """synth-reddit's int8 pack on the card and K5/K6 inputs at heads 2, d
    32 and 41 (bf16; the backward's m, den and ρ from the plain forward)."""
    from parallel_gcn_tpu_torch.config import default_params_path, load_config
    from parallel_gcn_tpu_torch.data.parser import prepare_device_dataset
    from parallel_gcn_tpu_torch.ops import tile_attention as ta

    cfg = load_config(default_params_path("synth-reddit"))
    _, dds = prepare_device_dataset(cfg, "synth-reddit", torch.device("cuda"))
    pack = dds.graph.bcsr
    gen = torch.Generator().manual_seed(3)
    n, H = pack.n_nodes, 2
    shapes = {}
    for D in (32, 41):
        s, t = (torch.randn((n, H), generator=gen).to(torch.bfloat16).cuda() for _ in range(2))
        v = torch.randn((n, H, D), generator=gen).to(torch.bfloat16).cuda()
        g = torch.randn((n, H, D), generator=gen).cuda()
        acc, m, den = ta.gat_fwd_tiles_plain(pack, s, t, v, slope=0.2)
        rho = (g * acc / den.clamp(min=1e-16)[:, :, None]).sum(-1)
        shapes[D] = (s, t, v, g, m, den, rho)
    return pack, shapes


def _time_attention(torch, ta, pack, shapes, bare: bool) -> str:
    """Each wrapper call (and with ``bare`` the kernel call alone, its
    arguments prepared once) at d 32 and 41."""
    parts = []
    for D, (s, t, v, g, m, den, rho) in shapes.items():
        calls = {"K5": lambda: ta.gat_fwd_tiles(pack, s, t, v, slope=0.2),
                 "K6": lambda: ta.gat_bwd_tiles(pack, s, t, v, g, m, den, rho, slope=0.2)}
        for key, fn in calls.items():
            out = fn()
            part = (f"{key} D={D} {_events_ms(torch, fn):.4f} ms "
                    f"({_digest(torch.cat([x.reshape(x.shape[0], -1) for x in out], 1))})")
            if bare:
                part += f", kernel alone {_events_ms(torch, _bare_call(ta, key, pack, shapes[D])):.4f}"
            parts.append(part)
    return "; ".join(parts)


def _bare_call(ta, key: str, pack, inputs):
    """The K5 or K6 library call with the wrapper's arguments built once."""
    import ctypes

    import torch

    from parallel_gcn_tpu_torch.ops import _build
    from parallel_gcn_tpu_torch.ops.cuda_bcsr import _DTYPE_CODE

    s, t, v, g, m, den, rho = inputs
    n, H, D = v.shape
    P, S = ta._padded_width(H, D)
    vf = v.reshape(n, H * D)
    vp = torch.empty((n, S), dtype=v.dtype, device=v.device)
    out = torch.empty((n, H * D + 2 * H), dtype=torch.float32, device=v.device)
    ws = torch.empty((pack.schedule.n_slots, pack.tile_r, H * D + 2 * H),
                     dtype=torch.float32, device=v.device)
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    tail = [P, S, out.data_ptr(), ws.data_ptr(), H, D, 0.2, *ta._dropout_args(0.0, 0), stream]
    walk = ta._walk_args(pack)
    code = _DTYPE_CODE[v.dtype]
    if key == "K5":
        held = (s.float(), t.float(), vf, vp, out, ws)  # alive as long as the call
        head = [held[0].data_ptr(), held[1].data_ptr(), vf.data_ptr(), n, code, vp.data_ptr()]
        return lambda: (held, _build._lib.pgcn_gat_fwd(*walk, *head, *tail))
    held = (ta._node_records(s, t, m, den, rho), g.reshape(n, H * D),
            torch.empty((n, S), dtype=torch.float32, device=v.device), vf, vp, out, ws)
    head = [held[0].data_ptr(), held[1].data_ptr(), vf.data_ptr(), n, code, held[2].data_ptr(),
            vp.data_ptr()]
    return lambda: (held, _build._lib.pgcn_gat_bwd(*walk, *head, *tail))


_PTXAS_K56 = (("gat_fwd_kernelILi2ELi1E13__nv_bfloat16", "K5"),
              ("gat_bwd_kernelILi2ELi1E13__nv_bfloat16", "K6"))
_PTXAS_K7 = (("gat_bwd_rect_row_kernelILi2ELi1E13__nv_bfloat16", "K7 row"),
             ("gat_bwd_rect_col_kernelILi2ELi1E13__nv_bfloat16", "K7 col"))
_PTXAS_K12 = (("dropout_kernelI13__nv_bfloat16Lb0E", "K1 bf16"),
              ("dropout_kernelI13__nv_bfloat16Lb1E", "K2 bf16"))


def _ptxas(log: str, keys=_PTXAS_K56) -> str:
    """Registers and spills of the main path's instantiations (``keys``:
    mangled-name part and label; K5/K6 at heads <= 2 and bf16 v by
    default) from nvcc's -Xptxas -v output."""
    parts, name, spill = [], "", ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name, spill = line.split("'")[1], ""
        elif "spill stores" in line:
            spill = line.strip()
        elif "Used" in line and "registers" in line:
            for key, label in keys:
                if key in name:
                    regs = line.split("Used")[1].split(",")[0].strip()
                    parts.append(f"{label} {regs} ({spill})")
    return "; ".join(parts)


def attention_family(parent: str | None) -> int:
    """K5/K6 of the checkout and its source variants, and of ``parent``'s
    package."""
    import torch

    sys.path.insert(0, ROOT)
    from parallel_gcn_tpu_torch.ops import _build
    from parallel_gcn_tpu_torch.ops import cuda_bcsr as cb
    from parallel_gcn_tpu_torch.ops import tile_attention as ta

    join = _start_builds(ATTN, ATTN_VARIANTS, "attention")
    base = _build.load_library()
    pack, shapes = _attention_inputs(torch)
    libs, errors = join()
    for name, err in errors.items():
        print(f"[attn-variant] {name} not built: {err}")
    print(f"[attn-variant] base ptxas: {_ptxas(_build.build_info['log'])}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    idx = cb.attn_index(pack)
    torch.cuda.synchronize()
    print(f"[attn-variant] synth-reddit pack: {pack.n_tiles} tiles {pack.tile_r}x{pack.tile_c} "
          f"int8, {pack.schedule.n_seg} segments; live-column index of {idx.col.numel()} "
          f"entries built in {time.perf_counter() - t0:.4f} s", flush=True)
    # the base against the plain versions (d 41, rate 0)
    s, t, v, g, m, den, rho = shapes[41]
    got = ta.gat_fwd_tiles(pack, s, t, v, slope=0.2)
    ref = ta.gat_fwd_tiles_plain(pack, s, t, v, slope=0.2)
    e5 = max(float((a - b).abs().max()) for a, b in zip(got, ref) if a.numel())
    got = ta.gat_bwd_tiles(pack, s, t, v, g, m, den, rho, slope=0.2)
    ref = ta.gat_bwd_tiles_plain(pack, s, t, v, g, m, den, rho, slope=0.2)
    e6 = max(float((a - b).abs().max() / b.abs().max()) for a, b in zip(got, ref))
    print(f"[attn-variant] base vs plain at D=41: K5 max abs err {e5:.3e}, K6 max err "
          f"{e6:.3e} of max|ref|", flush=True)
    print(f"[attn-variant] base: {_time_attention(torch, ta, pack, shapes, True)}", flush=True)
    for D, (s, t, v, g, m, den, rho) in shapes.items():
        ms = _events_ms(torch, lambda: ta._node_records(s, t, m, den, rho))
        print(f"[attn-variant] K6's node records (torch, in its wrapper) D={D}: {ms:.4f} ms",
              flush=True)
    for name, (path, log) in libs.items():
        _load_variant(path, base, ["pgcn_gat_fwd", "pgcn_gat_bwd"])
        print(f"[attn-variant] {name}: {_time_attention(torch, ta, pack, shapes, False)} "
              f"[ptxas: {_ptxas(log)}]", flush=True)
    _build._lib = base
    print(f"[attn-variant] base again: {_time_attention(torch, ta, pack, shapes, False)}",
          flush=True)
    if parent:
        del pack, shapes, idx
        torch.cuda.empty_cache()
        return _run_parent("--time-attention", parent) or int(bool(errors))
    return int(bool(errors))


def time_attention_tree(root: str) -> None:
    """K5/K6 of the package under ``root`` (another checkout)."""
    sys.path.insert(0, root)
    import torch

    from parallel_gcn_tpu_torch.ops import _build
    from parallel_gcn_tpu_torch.ops import tile_attention as ta

    assert os.path.abspath(ta.__file__).startswith(os.path.abspath(root)), ta.__file__
    _build.load_library()
    pack, shapes = _attention_inputs(torch)
    print(f"[attn-variant] {root}: {_time_attention(torch, ta, pack, shapes, False)}",
          flush=True)


def _rect_inputs(torch):
    """Rank 0's GAT slabs of synth-reddit's mesh partition at one rank and at
    4 ranks (boundary halo kept), and K7's inputs on each at heads 2, d 32
    and 41 (bf16; m, den and ρ from the plain forward), with K7's records
    and padded rows prepared once (``a``)."""
    from chip_smoke import _config, mesh_slabs
    from parallel_gcn_tpu_torch.data.parser import prepare_host_dataset
    from parallel_gcn_tpu_torch.ops import tile_attention as ta

    ds = prepare_host_dataset(_config([], 1), "synth-reddit")
    gen = torch.Generator().manual_seed(7)
    slabs = {}
    for n_dev, args in ((1, []), (4, ["halo_fallback=false"])):
        _, attn = mesh_slabs(ds, n_dev, args)
        n, nb, H = attn.n_rows, attn.n_buf, 2
        shapes = {}
        for D in (32, 41):
            s = torch.randn((n, H), generator=gen).to(torch.bfloat16).cuda()
            t = torch.randn((nb, H), generator=gen).to(torch.bfloat16).cuda()
            v = torch.randn((nb, H, D), generator=gen).to(torch.bfloat16).cuda()
            g = torch.randn((n, H, D), generator=gen).cuda()
            acc, m, den = ta.gat_fwd_tiles_plain(attn.rows, s, t, v, slope=0.2)
            rho = (g * acc / den.clamp(min=1e-16)[:, :, None]).sum(-1)
            bw = (s, t, v, g, m, den, rho)
            shapes[D] = (bw, ta._rect_bwd_args(*bw))
        slabs[f"{n_dev}-way"] = (attn, shapes)
    return slabs


def _time_rect(torch, ta, slabs, bare: bool) -> str:
    """Each K7 sweep's wrapper call (and with ``bare`` the library call with
    its records and padded rows prepared once) on each slab at d 32 and 41."""
    parts = []
    for tag, (attn, shapes) in slabs.items():
        for D, (bw, a) in shapes.items():
            calls = {"row": (lambda: ta.gat_bwd_rect_row(attn.rows, *bw, slope=0.2),
                             lambda: ta._launch_rect("row", attn.rows, a, 0.2, 0.0, 0)),
                     "col": (lambda: ta.gat_bwd_rect_col(attn.cols, *bw, slope=0.2),
                             lambda: ta._launch_rect("col", attn.cols, a, 0.2, 0.0, 0))}
            for sweep, (fn, lib_call) in calls.items():
                out = fn()
                out = out if sweep == "row" else torch.cat([out[0], out[1].flatten(1)], 1)
                part = (f"{tag} {sweep} D={D} {_events_ms(torch, fn):.4f} ms "
                        f"({_digest(out)})")
                if bare:
                    part += f", kernel alone {_events_ms(torch, lib_call):.4f}"
                parts.append(part)
    return "; ".join(parts)


def rect_family(parent: str | None) -> int:
    """K7 of the checkout and its source variants, and of ``parent``'s
    package."""
    import torch

    sys.path.insert(0, ROOT)
    from parallel_gcn_tpu_torch.ops import _build
    from parallel_gcn_tpu_torch.ops import tile_attention as ta

    join = _start_builds(RECT, RECT_VARIANTS, "rect")
    base = _build.load_library()
    slabs = _rect_inputs(torch)
    libs, errors = join()
    print(f"[rect-variant] base ptxas: {_ptxas(_build.build_info['log'], _PTXAS_K7)}")
    for name, err in errors.items():
        print(f"[rect-variant] {name} not built: {err}")
    # the base against the plain versions (d 41, rate 0)
    for tag, (attn, shapes) in slabs.items():
        bw, _ = shapes[41]
        got = ta.gat_bwd_rect_row(attn.rows, *bw, slope=0.2)
        ref = ta.gat_bwd_rect_row_plain(attn.rows, *bw, slope=0.2)
        e_row = float((got - ref).abs().max() / ref.abs().max())
        got = ta.gat_bwd_rect_col(attn.cols, *bw, slope=0.2)
        ref = ta.gat_bwd_rect_col_plain(attn.cols, *bw, slope=0.2)
        e_col = max(float((a - b).abs().max() / b.abs().max()) for a, b in zip(got, ref))
        print(f"[rect-variant] base vs plain on the {tag} slab [{attn.n_rows}, {attn.n_buf}] "
              f"at D=41: row max err {e_row:.3e}, column {e_col:.3e} of max|ref|; index "
              f"entries {attn.rows.attn_index.col.numel()} (rows), "
              f"{attn.cols.attn_index.col.numel()} (column copy)", flush=True)
    print(f"[rect-variant] base: {_time_rect(torch, ta, slabs, True)}", flush=True)
    for tag, (attn, shapes) in slabs.items():
        bw, _ = shapes[41]
        ms = _events_ms(torch, lambda: ta._rect_bwd_args(*bw))
        print(f"[rect-variant] K7's records and padded g, v rows ({tag}, D=41, shared by "
              f"both sweeps): {ms:.4f} ms", flush=True)
    for name, (path, log) in libs.items():
        _load_variant(path, base, ["pgcn_gat_bwd_rect_row", "pgcn_gat_bwd_rect_col",
                                   "pgcn_pad_heads"])
        print(f"[rect-variant] {name}: {_time_rect(torch, ta, slabs, False)} "
              f"[ptxas: {_ptxas(log, _PTXAS_K7)}]", flush=True)
    _build._lib = base
    print(f"[rect-variant] base again: {_time_rect(torch, ta, slabs, False)}", flush=True)
    if parent:
        del slabs
        torch.cuda.empty_cache()
        return _run_parent("--time-rect", parent) or int(bool(errors))
    return int(bool(errors))


def time_rect_tree(root: str) -> None:
    """K7 of the package under ``root`` (another checkout)."""
    sys.path.insert(0, root)
    import torch

    from parallel_gcn_tpu_torch.ops import _build
    from parallel_gcn_tpu_torch.ops import tile_attention as ta

    assert os.path.abspath(ta.__file__).startswith(os.path.abspath(root)), ta.__file__
    _build.load_library()
    slabs = _rect_inputs(torch)
    print(f"[rect-variant] {root}: {_time_rect(torch, ta, slabs, False)}", flush=True)


def _dropout_inputs(torch):
    gen = torch.Generator().manual_seed(1)
    return {shape: torch.randn(shape, generator=gen).to(torch.bfloat16).cuda()
            for shape in ((233472, 64), (233472, 600))}


def _dropout_device_ms(torch, fn, reps=20) -> float:
    """Device ms per call of ``fn`` in kernels named ``*dropout_kernel*``
    (K1/K2's, and ``F.dropout``'s ``fused_dropout_kernel_vec``)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.device_time_total for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and "dropout_kernel" in e.name) / 1e3 / reps


def _time_dropout(torch, cd, inputs) -> str:
    """K1 and K2 at each input: CUDA events over 20 wrapper calls and the
    kernel's own device time."""
    seed, rate = 0x1234_5678_9ABC, 0.1
    parts = []
    for shape, x in inputs.items():
        for key, fn in (("K1", lambda: cd.dropout(x, seed, rate)),
                        ("K2", lambda: cd.relu_dropout(x, seed, rate))):
            parts.append(f"{key} {list(shape)} {_events_ms(torch, fn, 20):.4f} ms "
                         f"(device {_dropout_device_ms(torch, fn):.4f}; {_digest(fn())})")
    return "; ".join(parts)


def dropout_family(parent: str | None) -> int:
    """K1/K2 of the checkout and its source variants, and of ``parent``'s
    package, beside ``torch.nn.functional.dropout``."""
    import torch

    sys.path.insert(0, ROOT)
    from parallel_gcn_tpu_torch.ops import _build
    from parallel_gcn_tpu_torch.ops import cuda_dropout as cd

    join = _start_builds(DROP, DROP_VARIANTS, "dropout")
    base = _build.load_library()
    inputs = _dropout_inputs(torch)
    libs, errors = join()
    print(f"[drop-variant] base ptxas: {_ptxas(_build.build_info['log'], _PTXAS_K12)}")
    for name, err in errors.items():
        print(f"[drop-variant] {name} not built: {err}")
    for shape, x in inputs.items():
        fn = lambda: torch.nn.functional.dropout(x, 0.1)  # noqa: E731
        print(f"[drop-variant] torch.nn.functional.dropout {list(shape)} bf16 rate 0.1: "
              f"{_events_ms(torch, fn, 20):.4f} ms (device {_dropout_device_ms(torch, fn):.4f})",
              flush=True)
    print(f"[drop-variant] base: {_time_dropout(torch, cd, inputs)}", flush=True)
    # a K1 call's cost by layer at the small shape, where the kernel is short:
    # 200 calls back to back, so each time is the larger of host and device
    import ctypes

    x = inputs[(233472, 64)]
    out = torch.empty_like(x)
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    slot = cd.seed_tensor(0x1234_5678_9ABC, x.device)
    args = (x.data_ptr(), out.data_ptr(), x.numel(), 1, 0, slot.data_ptr(), 0,
            cd.keep_threshold(0.1), cd._inv_keep(0.1, x.dtype), stream)
    layers = {"autograd Function (cd.dropout)": lambda: cd.dropout(x, 0x1234_5678_9ABC, 0.1),
              "wrapper (cd._run)": lambda: cd._run(x, 0x1234_5678_9ABC, 0.1, False),
              "library call alone": lambda: base.pgcn_dropout(*args),
              "torch.empty_like alone": lambda: torch.empty_like(x),
              "torch.nn.functional.dropout": lambda: torch.nn.functional.dropout(x, 0.1)}
    print("[drop-variant] K1 [233472, 64] by layer, ms a call over 200: " + "; ".join(
        f"{k} {_events_ms(torch, fn, 200):.4f}" for k, fn in layers.items()), flush=True)
    for name, (path, log) in libs.items():
        _load_variant(path, base, ["pgcn_dropout"])
        print(f"[drop-variant] {name}: {_time_dropout(torch, cd, inputs)} "
              f"[ptxas: {_ptxas(log, _PTXAS_K12)}]", flush=True)
    _build._lib = base
    print(f"[drop-variant] base again: {_time_dropout(torch, cd, inputs)}", flush=True)
    if parent:
        del inputs
        torch.cuda.empty_cache()
        return _run_parent("--time-dropout", parent) or int(bool(errors))
    return int(bool(errors))


def time_dropout_tree(root: str) -> None:
    """K1/K2 of the package under ``root`` (another checkout)."""
    sys.path.insert(0, root)
    import torch

    from parallel_gcn_tpu_torch.ops import _build
    from parallel_gcn_tpu_torch.ops import cuda_dropout as cd

    assert os.path.abspath(cd.__file__).startswith(os.path.abspath(root)), cd.__file__
    _build.load_library()
    inputs = _dropout_inputs(torch)
    print(f"[drop-variant] {root}: {_time_dropout(torch, cd, inputs)}", flush=True)


def rowsum_family(parent: str | None) -> int:
    """The COO residual's row sums on synth-reddit's residual (its
    row-sorted destinations), at the widths the main paths add: the GCN's
    [E, 41] bf16 and the deferred eval's [E, 82], the GAT's denominators
    [E, 2] and numerators [E, 82] f32. Three ways: ``index_add_`` (the
    port's, atomics), ``index_put_`` with accumulate (sorted) and
    ``torch.segment_reduce`` over the rows: CUDA events over 50 calls,
    whether two calls give the same bits, whether the call captures in a
    CUDA graph."""
    import torch

    from parallel_gcn_tpu_torch.config import default_params_path, load_config
    from parallel_gcn_tpu_torch.data.parser import prepare_device_dataset

    if parent:
        print("[variant] rowsum takes no --parent")
        return 2
    _, dds = prepare_device_dataset(load_config(default_params_path("synth-reddit")),
                                    "synth-reddit", torch.device("cuda"))
    row, n = dds.graph.row, dds.graph.n_nodes
    assert bool((row[1:] >= row[:-1]).all()), "the residual's rows are not sorted"
    lengths = torch.bincount(row, minlength=n)
    gen = torch.Generator().manual_seed(9)
    for width, dtype in ((41, torch.bfloat16), (82, torch.bfloat16), (2, torch.float32),
                         (82, torch.float32)):
        src = torch.randn((row.numel(), width), generator=gen).to(dtype).cuda()
        ways = {
            "index_add_": lambda: torch.zeros((n, width), dtype=dtype,
                                              device="cuda").index_add_(0, row, src),
            "index_put_ accumulate": lambda: torch.zeros((n, width), dtype=dtype,
                                                         device="cuda").index_put_(
                (row,), src, accumulate=True),
            "segment_reduce": lambda: torch.segment_reduce(src, "sum", lengths=lengths,
                                                           axis=0, unsafe=True),
        }
        for name, fn in ways.items():
            same = torch.equal(fn(), fn())
            ms = _events_ms(torch, fn, reps=50)
            graph = torch.cuda.CUDAGraph()
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                fn()
            torch.cuda.current_stream().wait_stream(side)
            with torch.cuda.graph(graph):
                fn()
            graph.replay()
            torch.cuda.synchronize()
            print(f"[variant] rowsum {row.numel()} residual edges into {n} rows, [E, {width}] "
                  f"{dtype}: {name} {ms:.4f} ms, two calls bit-identical {same}, captures "
                  f"in a CUDA graph", flush=True)
    return 0


def main(argv: list[str]) -> int:
    if argv[:1] == ["--time-spmm"]:
        time_spmm_tree(argv[1])
        return 0
    trees = {"--time-attention": time_attention_tree, "--time-rect": time_rect_tree,
             "--time-dropout": time_dropout_tree, "--time-fused": time_fused_tree}
    if argv[:1] and argv[0] in trees:
        trees[argv[0]](argv[1])
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(f"[variant] card: {smi.stdout.strip()}", flush=True)
    parent = argv[argv.index("--parent") + 1] if "--parent" in argv else None
    families = {"spmm": spmm_family, "attention": attention_family, "rect": rect_family,
                "dropout": dropout_family, "fused": fused_family, "rowsum": rowsum_family}
    if argv[:1] and argv[0] in families:
        return families[argv[0]](parent)
    if argv:
        print(f"error: unknown family {argv[0]}; known: {list(families)}")
        return 2
    return spmm_family(None) or fused_family(None)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
