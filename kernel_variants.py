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
The base and ``--parent`` also time K10 over 4 seed lanes ([233472,
4·600] bf16, one launch each way) beside 4 unlaned launches on the lanes'
operands, and the cora-sized f32 lanes (8 lanes, layer 0 over a shared x);
``FUSED_LANE_VARIANTS`` are timed over the lanes. Times
are ``utils.timer.events_ms``, the median of batch means that
``chip_smoke.py`` takes.
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

    python3 kernel_variants.py spmm-f32 [--parent DIR]    # the f32 tile SpMM body
    python3 kernel_variants.py spmm-wide [--parent DIR]   # K4's wgmma body at wide F
    python3 kernel_variants.py sddmm [--parent DIR]       # K8 and the dense f32 SpMM body

K4's wide body (``spmm_pipe_kernel_wgmma``) on synth-reddit's pack at 600
and 602 columns: against its plain version, the threshold sweep against the
pipe body (41 to 600 columns), the source
variants of ``SPMM_WIDE_VARIANTS`` and ``--parent``'s K4 at the same widths.

The f32 body of the tile SpMM (``spmm_walk_kernel`` in
``csrc/bcsr_spmm.cu``, K3/K4 at f32 compute) on synth-reddit's int8 pack at
F=41 (an f32 hybrid run's per-epoch width) and 602 (the set-up Â·X), as K4
and as K3, and on a random pack of the full products run's 28,704 512x512
tiles at F=100: each against its plain version (rtol 1e-4, two runs
bit-identical), at both warp shapes (32 rows × 64 features, 16 × 128), beside
``torch.sparse.mm`` on f32 x, the dense FMA body of this tree and of
``--parent`` (the parent's ``csrc/bcsr_spmm.cu`` built alone and loaded in
this process; parent, change, change, parent), the bound of the index, x and
out; the index's build; segment lengths; ``SPMM_F32_VARIANTS`` (the ring
depth, and the x staging and the FMAs removed, wrong on purpose). K8
(``csrc/sddmm.cu``) on synth-reddit's square 512x512 int8 pack with a, b
[n, 41] f32 and bf16: against its plain version, this tree and the parent's
kernel (its ``csrc/sddmm.cu`` built alone, on the unpadded inputs) in turns,
``torch.bmm`` of the gathered blocks, ``SDDMM_VARIANTS`` (CTAs an SM, the k
loop's unrolling, and the stores or the products removed, wrong on
purpose); and the dense f32 SpMM body at K8's backward shape, this tree and
the parent. Times are ``utils.timer.events_ms``.

    python3 kernel_variants.py segment [--parent DIR]     # the ordered sums: every variant
    python3 kernel_variants.py segment-paths --parent DIR [--only NAME,...]  # paths' ms/epoch
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

The ordered segment sums (``csrc/segment_sum.cu``, ``segment_sum_bf16.cu``
and their header) in the same way: every source variant in
``SEG_VARIANTS`` (items in flight, the item walker's steps and group, CTAs
an SM), every wrapper knob in ``SEG_KNOBS`` (the hub threshold, the
widest vector) and the work list's other order of the rows that are no
hubs, at synth-reddit's residual and flat COO shapes (CUDA events over 10
calls, the kernels' device time by ``torch.profiler``), with hashes of the
outputs, and the flat shapes split into their hub rows, the other rows and
the longest row (``[seg-split]``); ``--parent`` times the parent's kernels
(the old design, its source built alone) in the same process on the same
inputs. ``segment-paths --parent DIR`` runs the ring GCN and the GAT (scan
and eager) and the segment GAT through the CLI of both trees in turns
(``--only`` names some of them).

K1/K2 (``csrc/dropout.cu``) in the same way at the main paths' bf16 shapes
[233472, 64] and [233472, 600], rate 0.1: CUDA events over 20 wrapper calls
and the kernel's device time by ``torch.profiler``, beside
``torch.nn.functional.dropout``, and a K1 call's cost by layer (autograd
Function, wrapper, library call) at the small shape, where the host's share
shows. ``DROP_VARIANTS`` are the design steps:
the vector width (every element through the scalar path), the loads in
flight, the grid, streaming cache hints, and the Philox rounds removed
(wrong on purpose). The base and ``--parent`` also time K1/K2 over seed
lanes as a seed batch runs them (``_time_dropout_lanes``: the parent's
laned kernel and lane copies against the split in the same launch).
``--parent`` times another checkout's K1/K2 (``--time-dropout DIR``).
"""

from __future__ import annotations

import dataclasses
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
_NO_X = [(MM, "      cp_async16(dst, ok ? x + row * ldx + col : x, ok ? 16 : 0);\n    } else {",
          "    } else {")]


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
    "dx-plain-stores": lambda: [(MM, "__stcs(reinterpret_cast<uint2*>(dst),\n"
                                 "                     make_uint2(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3])));",
                                 "*reinterpret_cast<uint2*>(dst) =\n"
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
                             (MM, "                if (col + t < k) dst[t]",
                              "                if (v[t] == 1234.5f) dst[t]")],
    "dx-stores-only": lambda: _DX_KEEP + [(MM, "for (int t = 0; t < 3; ++t) {",
                                           "for (int t = 0; t < 0; ++t) {")],
    "dx-no-pairs": lambda: [(MM, "for (int pr = half; pr < pairs; pr += 2) {",
                             "for (int pr = half; pr < 0; pr += 2) {")],
    "dx-one-term": lambda: [(MM, "for (int t = 0; t < 3; ++t) {", "for (int t = 2; t < 3; ++t) {")],
}
# name -> edits, timed over seed lanes (``_time_fused_lanes``): the laned dX
# with one lane a group (each lane's blocks apart, g's lane columns staged by
# 4-byte copies, a joined row written by 4 blocks at different times), to
# measure what writing whole joined rows from one block is worth
FUSED_LANE_VARIANTS = {
    "dx-lanes-one-a-group": lambda: [
        (MM, "const int group = max(1, min(lanes, optin / 2 / ring_lane));",
         "const int group = 1;")],
    # wrong on purpose: W staged for the first tile's items only (later
    # items compute with stale fragments), to show W's restaging's share
    "dx-lanes-no-w-restage": lambda: [
        (MM, "    if (i < items) {\n      const int rem = i % per_tile;",
         "    if (i < per_tile) {\n      const int rem = i % per_tile;")],
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
# name -> [(text, replacement)] in csrc/bcsr_spmm.cu: the wide body of K4
# (spmm_pipe_kernel_wgmma) at 600 and 602 columns
_WIDE_CHUNK = "        wide_chunk<kNonneg>("
_WIDE_N = "constexpr int kWideN = 208;"
_WIDE_CLUSTER = "constexpr int kWideCluster = 2;"
_WIDE_STAGES = "constexpr int kWideStages = 5;"
_WGMMA_208 = "template <> struct Wgmma<208> {"


def _wgmma_struct(n: int) -> str:
    """The source's Wgmma<n> specialisation (m64nNk16, n / 2 accumulators a
    thread), for a variant of another feature-block width."""
    m = n // 2
    ops = ", ".join(f"%{k}" for k in range(m))
    outs = ", ".join(f'"+f"(d[{k}])' for k in range(m))
    return (f"template <> struct Wgmma<{n}> {{\n"
            f"  __device__ __forceinline__ static void mma(float (&d)[{m}], "
            "const uint32_t (&a)[4], uint64_t desc) {\n"
            f'    asm volatile("{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{m + 5}, 0;\\n"\n'
            f'        "wgmma.mma_async.sync.aligned.m64n{n}k16.f32.bf16.bf16 {{{ops}}}, '
            f'{{%{m}, %{m + 1}, %{m + 2}, %{m + 3}}}, %{m + 4}, p, 1, 1, 1;\\n}}\\n"\n'
            f"        : {outs}\n"
            '        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));\n'
            "  }\n};\n")


SPMM_WIDE_VARIANTS = {
    # 152 features a CTA (four blocks at 600, 41 fewer accumulators a thread)
    "n152": [(_WIDE_N, "constexpr int kWideN = 152;"),
             (_WGMMA_208, _wgmma_struct(152) + _WGMMA_208)],
    # the x chunk shared by 4 CTAs (30 clusters held, 120 SMs), or by none
    "cluster-4": [(_WIDE_CLUSTER, "constexpr int kWideCluster = 4;")],
    "no-multicast": [(_WIDE_CLUSTER, "constexpr int kWideCluster = 1;")],
    "stages-4": [(_WIDE_STAGES, "constexpr int kWideStages = 4;")],
    # wrong on purpose, each removes one cost: the int8 conversion (raw tile
    # words as A), or the conversion and the products (the TMA ring alone)
    "no-convert": [("    a_frag<true, kNonneg>(rlo, dc, ndc, dra, af[s][0], af[s][2]);\n"
                    "    a_frag<true, kNonneg>(rhi, dc, ndc, drb, af[s][1], af[s][3]);\n",
                    "    af[s][0] = rlo.w;\n    af[s][2] = rlo.w ^ 0x1000u;\n"
                    "    af[s][1] = rhi.w;\n    af[s][3] = rhi.w ^ 0x1000u;\n")],
    "loads-only": [(_WIDE_CHUNK, "        if (false) wide_chunk<kNonneg>(")],
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
            path = os.path.join(vdir, os.path.basename(rel))
            with open(path, "w") as f:
                f.write(text)
            if path.endswith(".cu"):  # an edited header is written, not compiled
                paths.append(path)
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
        parts.append(f"{key} {_events_ms(fn, 20):.4f} ms (device "
                     f"{_device_total_ms(torch, fn):.4f}; {_digest(result)})")
    return "; ".join(parts)


def _time_fused_lanes_f32(torch, cf) -> str:
    """The laned f32 K10 of the cora-sized fused batch ([seeds-stop-fused]:
    parameters_cora.txt's 1433 -> 72 -> 7, 8 lanes): layer 0 over the shared
    x [2708, 1433] (fwd, dW), layer 1 over the joined [2708, 8·72] (fwd, dW,
    dX), beside 8 unlaned launches; CUDA events over 20 calls, device time."""
    gen = torch.Generator().manual_seed(2)
    lanes, seed = 8, 0x0F1E_2D3C_4B5A_6978
    slot = torch.tensor([seed + 7919 * s for s in range(lanes)], device="cuda")
    parts = []
    for n, k, m, rate, shared in ((2708, 1433, 72, 0.4, True), (2708, 72, 7, 0.2, False)):
        x = torch.randn((n, k if shared else lanes * k), generator=gen).cuda()
        w = ((torch.rand((lanes, k, m), generator=gen) * 2 - 1) * 0.1).cuda()
        g = (torch.randn((n, lanes * m), generator=gen) / n).cuda()
        xs = [x if shared else x[:, s * k:(s + 1) * k].contiguous() for s in range(lanes)]
        gs = [g[:, s * m:(s + 1) * m].contiguous() for s in range(lanes)]
        calls = {"fwd": (lambda: cf._fwd_lanes(x, w, slot, rate),
                         lambda s: cf._fwd(xs[s], w[s], slot[s], rate)),
                 "dW": (lambda: cf._dw_lanes(x, g, slot, rate, torch.float32, shared),
                        lambda s: cf._dw(xs[s], gs[s], slot[s], rate, torch.float32))}
        if not shared:
            calls["dX"] = (lambda: cf._dx_lanes(g, w, slot, rate, torch.float32),
                           lambda s: cf._dx(gs[s], w[s], slot[s], rate, torch.float32))
        for key, (laned, solo) in calls.items():
            unlaned = lambda: [solo(s) for s in range(lanes)]  # noqa: E731
            parts.append(f"f32 [{n}, {'' if shared else f'{lanes}·'}{k}] x [{lanes}, {k}, {m}] "
                         f"{key} lanes {_events_ms(laned, 20):.4f} ms (device "
                         f"{_device_total_ms(torch, laned):.4f}), {lanes} unlaned "
                         f"{_events_ms(unlaned, 20):.4f} ms; {_digest(laned())}")
    return "; ".join(parts)


def _time_fused_lanes(torch, cf, n: int, lanes: int = 4) -> str:
    """K10 over ``lanes`` seed lanes (``cuda_fused.dropout_matmul_lanes``) at
    the fused GCN's layer 1 of a synth-reddit seed batch, x [n, lanes·600]
    bf16, W [lanes, 600, 41], beside ``lanes`` unlaned launches on the
    lanes' own operands: CUDA events over 20 calls, device time, and
    whether each lane is its unlaned launch bit for bit."""
    gen = torch.Generator().manual_seed(1)
    seed, rate = 0x0F1E_2D3C_4B5A_6978, 0.1
    slot = torch.tensor([seed + 7919 * s for s in range(lanes)], device="cuda")
    x = torch.randn((n, lanes * 600), generator=gen).bfloat16().cuda()
    w = ((torch.rand((lanes, 600, 41), generator=gen) * 2 - 1) * 0.0988).bfloat16().cuda()
    g = (torch.randn((n, lanes * 41), generator=gen) / n).cuda()
    xs = [x[:, s * 600:(s + 1) * 600].contiguous() for s in range(lanes)]
    gs = [g[:, s * 41:(s + 1) * 41].contiguous() for s in range(lanes)]
    calls = {
        "K10 fwd": (lambda: cf._fwd_lanes(x, w, slot, rate),
                    lambda s: cf._fwd(xs[s], w[s], slot[s], rate),
                    lambda t, s: t[:, s * 41:(s + 1) * 41]),
        "K10 dW": (lambda: cf._dw_lanes(x, g, slot, rate, torch.bfloat16),
                   lambda s: cf._dw(xs[s], gs[s], slot[s], rate, torch.bfloat16),
                   lambda t, s: t[s]),
        "K10 dX": (lambda: cf._dx_lanes(g, w, slot, rate, torch.bfloat16),
                   lambda s: cf._dx(gs[s], w[s], slot[s], rate, torch.bfloat16),
                   lambda t, s: t[:, s * 600:(s + 1) * 600]),
    }
    parts = []
    for key, (laned, solo, lane_of) in calls.items():
        got = laned()
        same = all(torch.equal(lane_of(got, s), solo(s)) for s in range(lanes))
        unlaned = lambda: [solo(s) for s in range(lanes)]  # noqa: E731
        parts.append(f"{key} lanes {_events_ms(laned, 20):.4f} ms (device "
                     f"{_device_total_ms(torch, laned):.4f}), {lanes} unlaned "
                     f"{_events_ms(unlaned, 20):.4f} ms (device "
                     f"{_device_total_ms(torch, unlaned):.4f}), lanes = unlaned: {same}")
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
    lane_join = _start_builds((MM, CE), {k: v() for k, v in FUSED_LANE_VARIANTS.items()},
                              "fused-lanes")
    print(f"[fused-variant] base, 4 seed lanes: "
          f"{_time_fused_lanes(torch, cf, inputs['x'].shape[0])}", flush=True)
    print(f"[fused-variant] base, the cora-sized f32 lanes: {_time_fused_lanes_f32(torch, cf)}",
          flush=True)
    lane_libs, lane_errors = lane_join()
    errors.update(lane_errors)
    for name, err in lane_errors.items():
        print(f"[fused-variant] {name} not built: {err}")
    lane_fns = [*fns, "pgcn_dropout_matmul_fwd_lanes", "pgcn_dropout_matmul_dw_lanes",
                "pgcn_dropout_matmul_dx_lanes"]
    for name, (path, _) in lane_libs.items():
        _load_variant(path, base, lane_fns)
        print(f"[fused-variant] {name}, 4 seed lanes: "
              f"{_time_fused_lanes(torch, cf, inputs['x'].shape[0])}", flush=True)
    _build._lib = base
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
    print(f"[fused-variant] {root}, 4 seed lanes: "
          f"{_time_fused_lanes(torch, cf, inputs['x'].shape[0])}", flush=True)
    print(f"[fused-variant] {root}, the cora-sized f32 lanes: "
          f"{_time_fused_lanes_f32(torch, cf)}", flush=True)


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


def _events_ms(fn, reps=10):
    """``utils.timer.events_ms`` of the package on the path (this
    checkout's, or the tree a ``--time-*`` process times): the median of
    batch means of CUDA events, as ``chip_smoke.py`` times."""
    from parallel_gcn_tpu_torch.utils.timer import events_ms

    return events_ms(fn, reps)


def _digest(t):
    return hashlib.sha1(t.detach().float().cpu().numpy().tobytes()).hexdigest()[:10]


def _time_spmm(torch, cb, pack, x41, x600) -> str:
    import dataclasses

    pattern = dataclasses.replace(pack, sym_scale=None)
    parts = []
    for key, pk, x in (("K4 F=41", pack, x41), ("K3 F=41", pattern, x41),
                       ("K3 F=600", pattern, x600)):
        out = cb.bcsr_matmul_impl(pk, x)
        parts.append(f"{key} {_events_ms(lambda: cb.bcsr_matmul_impl(pk, x)):.4f} ms "
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
    xp_ms = _events_ms(lambda: cb.pad_features(x41))
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


def _time_wide(torch, cb, pack, xs) -> str:
    """K4 at each width of ``xs`` (bf16) through the wrapper's dispatch, with
    hashes of the outputs."""
    parts = []
    for x in xs:
        out = cb.bcsr_matmul_impl(pack, x)
        assert torch.equal(out, cb.bcsr_matmul_impl(pack, x)), "two runs differ"
        parts.append(f"K4 F={x.shape[1]} {_events_ms(lambda: cb.bcsr_matmul_impl(pack, x)):.4f} "
                     f"ms ({_digest(out)})")
    return "; ".join(parts)


def spmm_wide_family(parent: str | None) -> int:
    """K4's wide body (``spmm_pipe_kernel_wgmma``) at 600 and 602 columns on
    synth-reddit's pack: this tree against its plain version, beside the
    pipe body at the same widths (``SPMM_WIDE_F`` raised), the threshold's
    sweep (both bodies at 41 to 600 columns), the source variants of
    ``SPMM_WIDE_VARIANTS``, and ``parent``'s K4 at the same widths."""
    import torch

    sys.path.insert(0, ROOT)
    from parallel_gcn_tpu_torch.ops import _build
    from parallel_gcn_tpu_torch.ops import cuda_bcsr as cb

    join = _start_builds(SPMM, SPMM_WIDE_VARIANTS, "spmm-wide")
    base = _build.load_library()
    pack, _, x600 = _spmm_inputs(torch)
    gen = torch.Generator().manual_seed(3)
    x602 = torch.randn((pack.n_nodes, 602), generator=gen).to(torch.bfloat16).cuda()
    libs, errors = join()
    for name, err in errors.items():
        print(f"[spmm-wide] {name} not built: {err}")
    ref = cb.bcsr_matmul_plain(pack, x600)
    err = float((cb.bcsr_matmul_impl(pack, x600) - ref).abs().max() / ref.abs().max())
    print(f"[spmm-wide] base at F=600 against the plain version: {err:.3e} of max|ref|", flush=True)
    del ref
    print(f"[spmm-wide] base: {_time_wide(torch, cb, pack, (x600, x602))}", flush=True)
    wide_f = cb.SPMM_WIDE_F
    for f in (41, 82, 164, 328, 416, 512, 600):
        x = x600[:, :f].contiguous()
        times = {}
        for body, threshold in (("wide", 1), ("pipe", 1 << 30)):
            cb.SPMM_WIDE_F = threshold
            times[body] = _events_ms(lambda: cb.bcsr_matmul_impl(pack, x))
        cb.SPMM_WIDE_F = wide_f
        print(f"[spmm-wide] F={f}: wide body {times['wide']:.4f} ms, pipe body "
              f"{times['pipe']:.4f} ms", flush=True)
    for name, (path, log) in libs.items():
        _load_variant(path, base, ["pgcn_bcsr_spmm", "pgcn_bcsr_spmm_wide"])
        print(f"[spmm-wide] {name}: {_time_wide(torch, cb, pack, (x600, x602))} "
              f"[ptxas: {_ptxas(log, _PTXAS_WIDE)}]", flush=True)
    _build._lib = base
    print(f"[spmm-wide] base again: {_time_wide(torch, cb, pack, (x600, x602))}", flush=True)
    if parent:
        del pack, x600, x602
        torch.cuda.empty_cache()
        return _run_parent("--time-spmm-wide", parent) or int(bool(errors))
    return int(bool(errors))


def time_spmm_wide_tree(root: str) -> None:
    """K4 at 600 and 602 columns of the package under ``root``."""
    sys.path.insert(0, root)
    import torch

    from parallel_gcn_tpu_torch.ops import _build
    from parallel_gcn_tpu_torch.ops import cuda_bcsr as cb

    assert os.path.abspath(cb.__file__).startswith(os.path.abspath(root)), cb.__file__
    _build.load_library()
    pack, _, x600 = _spmm_inputs(torch)
    gen = torch.Generator().manual_seed(3)
    x602 = torch.randn((pack.n_nodes, 602), generator=gen).to(torch.bfloat16).cuda()
    print(f"[spmm-wide] {root}: {_time_wide(torch, cb, pack, (x600, x602))}", flush=True)


_PTXAS_WIDE = (("spmm_pipe_kernel_wgmmaILb1E", "wide"),)


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
            part = (f"{key} D={D} {_events_ms(fn):.4f} ms "
                    f"({_digest(torch.cat([x.reshape(x.shape[0], -1) for x in out], 1))})")
            if bare:
                part += f", kernel alone {_events_ms(_bare_call(ta, key, pack, shapes[D])):.4f}"
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
        ms = _events_ms(lambda: ta._node_records(s, t, m, den, rho))
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
                part = (f"{tag} {sweep} D={D} {_events_ms(fn):.4f} ms "
                        f"({_digest(out)})")
                if bare:
                    part += f", kernel alone {_events_ms(lib_call):.4f}"
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
        ms = _events_ms(lambda: ta._rect_bwd_args(*bw))
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
            parts.append(f"{key} {list(shape)} {_events_ms(fn, 20):.4f} ms "
                         f"(device {_dropout_device_ms(torch, fn):.4f}; {_digest(fn())})")
    return "; ".join(parts)


def _time_dropout_lanes(torch, cd) -> str:
    """K1/K2 over seed lanes as a seed batch runs them, in either tree: K2 at
    [233472, 4·600] bf16 (the joined aggregation in, the lanes' [233472, 600]
    for their GEMMs out, and the backward's joined gradient from the lanes'
    cotangents), K1 at [2708, 8·1433] f32 (the input features to the 8
    lanes); a tree without ``lane_dropout`` (the parent) runs its path: the
    laned kernel on the joined tensor, then the lanes' copies (``_Split``),
    the backward PyTorch's ``where`` and ``cat``, and the input repeated
    once a lane. CUDA events over 20 calls, device time of every kernel."""
    gen = torch.Generator().manual_seed(3)
    fused = hasattr(cd, "lane_dropout")
    parts = []
    for (rows, width), lanes, dtype, rate, relu in (((233472, 600), 4, torch.bfloat16, 0.1, True),
                                                    ((2708, 1433), 8, torch.float32, 0.4, False)):
        slot = torch.tensor([0x1234_5678_9ABC + 7919 * s for s in range(lanes)], device="cuda")
        if relu:
            x = torch.randn((rows, lanes * width), generator=gen).to(dtype).cuda()
            fwd = ((lambda: cd.lane_dropout(x, slot, rate, relu=True)) if fused else
                   (lambda: [p.contiguous() for p in cd.relu_dropout(x, slot, rate).chunk(lanes, 1)]))
        else:
            x = torch.randn((rows, width), generator=gen).to(dtype).cuda()
            fwd = ((lambda: cd.lane_dropout([x] * lanes, slot, rate)) if fused else
                   (lambda: [p.contiguous() for p in
                             cd.dropout(x.repeat(1, lanes), slot, rate).chunk(lanes, 1)]))
        out = [t for t in fwd()]
        parts.append(f"{'K2' if relu else 'K1'} [{rows}, {lanes}·{width}] the lanes' entry "
                     f"{_events_ms(fwd, 20):.4f} ms (device {_device_total_ms(torch, fwd):.4f}; "
                     f"{_digest(torch.cat(out, 1))})")
        if relu:
            g = [torch.randn((rows, width), generator=gen).to(dtype).cuda() for _ in range(lanes)]
            inv = cd._inv_keep(rate, dtype)
            bwd = ((lambda: cd._run_lanes(g, None, rate, 2, 0, lanes, True, aux=out)) if fused else
                   (lambda: torch.where(torch.cat(out, 1) > 0, torch.cat(g, 1) * inv, 0.0)))
            parts.append(f"its backward {_events_ms(bwd, 20):.4f} ms (device "
                         f"{_device_total_ms(torch, bwd):.4f}; {_digest(bwd())})")
        del x, out
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
              f"{_events_ms(fn, 20):.4f} ms (device {_dropout_device_ms(torch, fn):.4f})",
              flush=True)
    print(f"[drop-variant] base: {_time_dropout(torch, cd, inputs)}", flush=True)
    print(f"[drop-variant] base, seed lanes: {_time_dropout_lanes(torch, cd)}", flush=True)
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
        f"{k} {_events_ms(fn, 200):.4f}" for k, fn in layers.items()), flush=True)
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
    print(f"[drop-variant] {root}, seed lanes: {_time_dropout_lanes(torch, cd)}", flush=True)


_SEG_H = "csrc/segment_sum.cuh"
SEG = ("csrc/segment_sum.cu", "csrc/segment_sum_bf16.cu", _SEG_H)


def _seg_const(name: str, value: int) -> tuple:
    """An edit of ``constexpr int name = ...;`` in csrc/segment_sum.cuh."""
    import re

    with open(os.path.join(ROOT, PKG, _SEG_H)) as f:
        line = re.search(rf"constexpr int {name} = [^;]*;", f.read()).group(0)
    return (_SEG_H, line, f"constexpr int {name} = {value};")


# name -> edits: the ordered sums' source variants, built together (both
# translation units, the header edited) and loaded in turn under the
# checkout's wrappers. The design steps: items in flight (a lane's ring in
# the walk kernel and in the hub kernel, the item walker's steps), the item
# walker's group, CTAs an SM (``__launch_bounds__``'s minimum, which caps
# the walk kernel's registers)
SEG_VARIANTS = {
    "ring-8": [_seg_const("kRingRegs", 8)],
    "ring-32": [_seg_const("kRingRegs", 32)],
    "hub-ring-32": [_seg_const("kHubRingRegs", 32)],
    "item-steps-2": [_seg_const("kItemSteps", 2)],
    "item-group-16": [_seg_const("kItemGroup", 16)],
    "min-blocks-6": [_seg_const("kMinBlocks", 6)],
    "min-blocks-8": [_seg_const("kMinBlocks", 8)],
    # the index by a load an item (every lane the same address) instead of
    # the batch's shuffles
    "index-uniform": [(_SEG_H, """        sv[j] = Op::kScale ? __int_as_float(__shfl_sync(mask, cur.y, q0 + j, S)) : 1.f;
        const int qn = q0 + j + D;
        sr[j] = __shfl_sync(mask, qn < S ? cur.x : nxt.x, qn & (S - 1), S);""",
                       """        sv[j] = Op::kScale ? __int_as_float(op.index(begin + k + j).y) : 1.f;
        sr[j] = k + j + D < n ? op.index(begin + k + j + D).x : 0;""")],
    # wrong on purpose: every item's row is row 0 (in L1), to show the
    # gathers' share
    "gather-row-0": [(_SEG_H, "  const T* row = op.row(src);\n#pragma unroll\n  for (int p = 0; p < P",
                      "  const T* row = op.row(0);\n#pragma unroll\n  for (int p = 0; p < P")],
}
# name -> (setting of ops/cuda_segment.py, value): the hub threshold (no
# hubs: every segment walked by the walk kernel; read when the Segments are
# built, so they are built again under the knob), the widest vector, the
# hubs' widest vector, the widest row of half warps
SEG_KNOBS = {
    "hub-128": ("HUB_ITEMS", 128), "hub-256": ("HUB_ITEMS", 256),
    "hub-2048": ("HUB_ITEMS", 2048), "no-hubs": ("HUB_ITEMS", 2**31 - 1),
    "vec-8": ("MAX_VEC_BYTES", 8), "vec-4": ("MAX_VEC_BYTES", 4),
    "hub-vec-16": ("HUB_VEC_BYTES", 16), "hub-vec-4": ("HUB_VEC_BYTES", 4),
    "half-warps-64": ("HALF_WARP_VECS", 64), "warp-1200-bytes": ("WARP_ROW_BYTES", 1200),
}
_SEG_SETUP_KNOBS = ("HUB_ITEMS",)
_PTXAS_SEG = (("cols_walk_kernelI13__nv_bfloat16Li2ELi32ELi2ENS_6Gather", "(a) bf16 F=41"),
              ("cols_hub_kernelI13__nv_bfloat16Li2ENS_6Gather", "(a) bf16 F=41 hubs"),
              ("cols_walk_kernelI13__nv_bfloat16Li16ELi32ELi1ENS_6Gather", "(a) bf16 F=600"),
              ("cols_hub_kernelI13__nv_bfloat16Li8ENS_6Gather", "(a) bf16 F=600 hubs"),
              ("items_walk_kernelIfLi2ENS_5Terms", "(b) f32 W=2"),
              ("cols_walk_kernelIfLi8ELi32ELi2ENS_5Terms", "(b) f32 W=82"))


def _segment_inputs(torch):
    """name -> (kernel, graph, input) at synth-reddit's shapes: the hybrid
    residual's rows (the GCN, SAGE, GIN and GAT paths) and the flat COO's of
    all of Â (the ring, the flat halos, the segment GAT): (a) at 41, 82, 600
    (and on the residual 602 and TP's 150 and 300) bf16, (b) at [E, 2] and
    [E, 2, 41] f32."""
    from parallel_gcn_tpu_torch.config import default_params_path, load_config
    from parallel_gcn_tpu_torch.data.graph import build_graph
    from parallel_gcn_tpu_torch.data.parser import prepare_device_dataset

    dev = torch.device("cuda")
    cfg = load_config(default_params_path("synth-reddit"))
    ds, dds = prepare_device_dataset(cfg, "synth-reddit", dev)
    flat = build_graph(ds.graph, device=dev, node_pad=cfg.tpu.node_pad)
    gen = torch.Generator(device="cuda").manual_seed(8)
    shapes = {}
    for tag, g in (("residual", dds.graph), ("flat", flat)):
        for F in (41, 82, 150, 300, 600, 602) if tag == "residual" else (41, 82, 600):
            shapes[f"{tag} (a) [E, {F}] bf16"] = (
                "a", g, torch.randn((g.n_nodes, F), generator=gen, device=dev).to(torch.bfloat16))
        for shape in ((g.n_edges_pad, 2), (g.n_edges_pad, 2, 41)):
            shapes[f"{tag} (b) [E, {', '.join(map(str, shape[1:]))}] f32"] = (
                "b", g, torch.randn(shape, generator=gen, device=dev))
    return shapes


def _segment_fn(cs, op, seg, t):
    if op == "a":
        return lambda: cs.gather_sum(t, seg)
    return lambda: cs.segment_sum_(t.new_zeros((seg.n, *t.shape[1:])), seg, t)


def _other_order(seg):
    """``seg`` with the live segments that are no hubs in the other order
    than ``segments`` gives them (longest first where it keeps segment
    order, and the reverse; ties in segment order)."""
    import torch

    w = seg.work
    rest = w[seg.n_hub:seg.n_live]
    rest = rest[torch.sort(rest[:, 0]).indices]  # segment order
    if seg.index.numel() >= seg.n:  # segments kept segment order: longest first
        rest = rest[torch.sort((rest[:, 1] - rest[:, 2]).long(), stable=True).indices]
    return dataclasses.replace(seg, work=torch.cat([w[:seg.n_hub], rest,
                                                    w[seg.n_live:]]).contiguous())


def _time_segment(torch, cs, shapes, parent=None, seg_of=None) -> str:
    """Each shape's call (this tree's wrapper, or ``parent``'s kernels from
    ``chip_smoke.parent_segment_sums``; with ``seg_of`` over
    ``seg_of(graph)`` instead of the graph's row segments): CUDA events over
    10 calls, the kernels' device time and the output's hash."""
    parts, built = [], {}
    for name, (op, g, t) in shapes.items():
        seg = g.row_seg
        if seg_of is not None:
            if id(g) not in built:
                built[id(g)] = seg_of(g)
            seg = built[id(g)]
        if parent is None:
            fn = _segment_fn(cs, op, seg, t)
        elif op == "a":
            fn = lambda g=g, t=t: parent[0](t, g.row_seg, g.col, g.val)  # noqa: E731
        else:
            fn = lambda g=g, t=t: parent[1](  # noqa: E731
                t.new_zeros((g.n_nodes, *t.shape[1:])), g.row_seg, t)
        try:
            parts.append(f"{name} {_events_ms(fn, 10):.4f} ms (device "
                         f"{_segment_device_ms(torch, fn):.4f}; {_digest(fn())})")
        except RuntimeError as e:  # a variant whose layout a shape cannot take
            parts.append(f"{name} failed: {e}")
    return "; ".join(parts)


def _segment_device_ms(torch, fn, reps=10) -> float:
    """Device ms a call in the ordered sums' kernels (this tree's and the
    parent's), by ``torch.profiler``: the kernels' own time, which the
    host's cost of a short call hides from the events (the hub and walk
    kernels of one call overlap: their sum)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.device_time_total for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and ("pgcn_seg" in e.name or "sum_kernel" in e.name)) / 1e3 / reps


def _segment_split(torch, cs, parent=None) -> None:
    """What holds the flat shapes: (a) at 41 and 600 bf16 and (b) at [E, 2]
    and [E, 2, 41] f32 over all of Â, over its hub rows alone (``HUB_ITEMS``
    or more items), over the other rows alone and over its longest row
    alone, this tree's kernels and ``parent``'s on the same inputs."""
    import numpy as np

    from parallel_gcn_tpu_torch.config import default_params_path, load_config
    from parallel_gcn_tpu_torch.data.graph import build_graph
    from parallel_gcn_tpu_torch.data.parser import prepare_host_dataset

    cfg = load_config(default_params_path("synth-reddit"))
    g = build_graph(prepare_host_dataset(cfg, "synth-reddit").graph, device=torch.device("cuda"),
                    node_pad=cfg.tpu.node_pad)
    n, ptr = g.n_nodes, g.row_seg.ptr.cpu().numpy()
    lens = np.diff(ptr)
    rows = {"all": None, "hub rows": np.flatnonzero(lens >= cs.HUB_ITEMS),
            "other rows": np.flatnonzero((lens < cs.HUB_ITEMS) & (lens > 0)),
            "longest row": np.argsort(-lens, kind="stable")[:1]}
    parts = {}
    for name, r in rows.items():
        if r is None:
            parts[name] = (g.row_seg, None)
            continue
        items = torch.from_numpy(np.concatenate([np.arange(ptr[i], ptr[i + 1]) for i in r])).cuda()
        parts[name] = (cs.segments(g.row[items], n, g.col[items], g.val[items]), items)
    gen = torch.Generator(device="cuda").manual_seed(9)
    for F in (41, 600):
        x = torch.randn((n, F), generator=gen, device="cuda").to(torch.bfloat16)
        line = []
        for name, (seg, _) in parts.items():
            ms = _events_ms(lambda: cs.gather_sum(x, seg), 10)
            old = "" if parent is None else " (parent {:.4f})".format(
                _events_ms(lambda: parent[0](x, seg, seg.src, seg.val), 10))
            line.append(f"{name} {ms:.4f}{old}")
        print(f"[seg-split] flat (a) [E, {F}] bf16, ms: {'; '.join(line)}", flush=True)
    for shape in ((g.n_edges_pad, 2), (g.n_edges_pad, 2, 41)):
        v = torch.randn(shape, generator=gen, device="cuda")
        line = []
        for name, (seg, items) in parts.items():
            vals = v if items is None else v[items]

            def call(fn, seg=seg, vals=vals):
                return fn(vals.new_zeros((n, *shape[1:])), seg, vals)

            ms = _events_ms(lambda: call(cs.segment_sum_), 10)
            old = "" if parent is None else (
                f" (parent {_events_ms(lambda: call(parent[1]), 10):.4f})")
            line.append(f"{name} {ms:.4f}{old}")
        print(f"[seg-split] flat (b) [E, {', '.join(map(str, shape[1:]))}] f32, ms: "
              f"{'; '.join(line)}", flush=True)
    print(f"[seg-split] rows: {len(rows['hub rows'])} hub rows of {cs.HUB_ITEMS} items or more "
          f"({int(lens[rows['hub rows']].sum())} items), longest {int(lens.max())}")


def segment_family(parent: str | None) -> int:
    """The ordered sums (``csrc/segment_sum.cu``) of the checkout, its
    source variants and wrapper knobs, and ``parent``'s kernels (the old
    kernel: its source built alone and called through its C interface, on
    the same inputs), at synth-reddit's residual and flat shapes."""
    import torch

    sys.path.insert(0, ROOT)
    from chip_smoke import parent_segment_sums
    from parallel_gcn_tpu_torch.ops import _build
    from parallel_gcn_tpu_torch.ops import cuda_segment as cs

    join = _start_builds(SEG, SEG_VARIANTS, "segment")
    base = _build.load_library()
    old = parent_segment_sums(parent)
    shapes = _segment_inputs(torch)
    libs, errors = join()
    print(f"[seg-variant] base ptxas: {_ptxas(_build.build_info['log'], _PTXAS_SEG)}")
    for name, err in errors.items():
        print(f"[seg-variant] {name} not built: {err}")
    if old is not None:
        print(f"[seg-variant] parent {parent}: {_time_segment(torch, cs, shapes, old)}",
              flush=True)
    print(f"[seg-variant] base: {_time_segment(torch, cs, shapes)}", flush=True)
    _segment_split(torch, cs, old)
    print(f"[seg-variant] the other order of the live rows that are no hubs: "
          f"{_time_segment(torch, cs, shapes, seg_of=lambda g: _other_order(g.row_seg))}",
          flush=True)

    def rebuilt(g):
        return cs.segments(g.row, g.n_nodes, g.col, g.val)

    for name, (knob, value) in SEG_KNOBS.items():
        saved = getattr(cs, knob)
        setattr(cs, knob, value)
        cs._plan.cache_clear()
        seg_of = rebuilt if knob in _SEG_SETUP_KNOBS else None
        try:
            print(f"[seg-variant] knob {name} ({knob}={value}): "
                  f"{_time_segment(torch, cs, shapes, seg_of=seg_of)}", flush=True)
        finally:
            setattr(cs, knob, saved)
            cs._plan.cache_clear()
    for name, (path, log) in libs.items():
        _load_variant(path, base, ["pgcn_gather_sum", "pgcn_segment_sum"])
        print(f"[seg-variant] {name}: {_time_segment(torch, cs, shapes)} "
              f"[ptxas: {_ptxas(log, _PTXAS_SEG)}]", flush=True)
    _build._lib = base
    print(f"[seg-variant] base again: {_time_segment(torch, cs, shapes)}", flush=True)
    if old is not None:
        print(f"[seg-variant] parent again: {_time_segment(torch, cs, shapes, old)}",
              flush=True)
    return int(bool(errors))


# name -> (launcher, CLI arguments after the dataset): the paths whose
# ms/epoch the ordered sums move, run as a user runs them, in mode=scan (the
# default) and in mode=eager, where the wrappers' host work is on the
# clock; the ring at one rank through a torchrun world of one
SEG_PATHS = {
    "ring GCN": ("torchrun", ["backend=segment", "halo=ring"]),
    "ring GCN eager": ("torchrun", ["backend=segment", "halo=ring", "mode=eager"]),
    "GAT": ("python", ["model=gat", "heads=2", "hidden_dims=32", "dropouts=0.0,0.1"]),
    "GAT eager": ("python", ["model=gat", "heads=2", "hidden_dims=32", "dropouts=0.0,0.1",
                             "mode=eager"]),
    "segment GAT": ("python", ["model=gat", "backend=segment", "heads=2", "hidden_dims=32",
                               "dropouts=0.0,0.1"]),
}


def segment_paths(parent: str | None, only: list[str] | None = None) -> int:
    """``SEG_PATHS`` (those named in ``only`` when given) through the CLI
    (synth-reddit, 10 epochs) of ``parent`` and of this checkout in turns
    (parent, this, this, parent), each run a process of its own in its
    tree, the generated data shared (``PGCN_CACHE_DIR``): each run's
    ms/epoch, in scan mode over the replays, in eager mode the mean host
    clock of epochs 2-10."""
    import re

    if not parent:
        print("error: segment-paths needs --parent DIR")
        return 2
    paths = {k: v for k, v in SEG_PATHS.items() if only is None or k in only}
    if only is not None and len(paths) != len(only):
        print(f"error: --only takes names of {list(SEG_PATHS)}")
        return 2
    env = dict(os.environ, PGCN_CACHE_DIR=os.path.join(ROOT, ".synth_cache"))
    runs: dict = {}
    for tree in (os.path.abspath(parent), ROOT, ROOT, os.path.abspath(parent)):
        label = "parent" if tree != ROOT else "this tree"
        for name, (launcher, args) in paths.items():
            cmd = ([sys.executable, "-m", PKG] if launcher == "python" else
                   ["torchrun", "--standalone", "--nproc_per_node=1", "-m", PKG])
            t0 = time.perf_counter()
            proc = subprocess.run([*cmd, "synth-reddit", *args, "epochs=10"], cwd=tree, env=env,
                                  capture_output=True, text=True, timeout=900)
            eager = "mode=eager" in args
            steady = [float(t) * 1e3 for t in re.findall(r"^epoch=\d+ .* time=(\S+)$",
                                                          proc.stdout, re.M)][1:]
            found = re.search(r"avg_epoch_time=(\S+) ms", proc.stdout)
            if proc.returncode or not found or (eager and not steady):
                print(f"[seg-path] {label} {name} failed (exit {proc.returncode}):\n"
                      f"{proc.stdout[-2000:]}{proc.stderr[-2000:]}")
                return 1
            ms = sum(steady) / len(steady) if eager else float(found.group(1))
            runs.setdefault((label, name), []).append(ms)
            print(f"[seg-path] {label} {name}: {ms:.3f} ms/epoch "
                  f"({'eager' if eager else 'scan'}, epochs 2-10; run "
                  f"{time.perf_counter() - t0:.1f} s)", flush=True)
    for (label, name), ms in runs.items():
        print(f"[seg-path] {name}, {label}: {', '.join(f'{m:.3f}' for m in ms)} ms/epoch, mean "
              f"{sum(ms) / len(ms):.3f}")
    return 0


# name -> [(text, replacement)] in csrc/bcsr_spmm.cu: the f32 body's design
# steps (its ring depth, window, entry loop) and wrong-on-purpose variants
# that each remove one cost (the x staging; the x reads and FMAs, which
# leaves the index walk)
SPMM_F32_VARIANTS = {
    "as-is": [],  # the checkout's source: its ptxas line
    "f32-stages-2": [("constexpr int kWalkStages = 3;", "constexpr int kWalkStages = 2;")],
    "f32-window-64": [("constexpr int kWalkWin = 128;", "constexpr int kWalkWin = 64;")],
    # 8-warp CTAs (two an SM where the shared memory allows: the 32 × 64 shape)
    "f32-8-warps": [("constexpr int kWalkWarps = 16;", "constexpr int kWalkWarps = 8;"),
                    ("__launch_bounds__(kWalkWarps * 32, 1)", "__launch_bounds__(kWalkWarps * 32, 2)")],
    "f32-entry-loop-unroll-1": [("#pragma unroll 4\n        for (int j = d >> 16; j < b; ++j) {",
                                 "#pragma unroll 1\n        for (int j = d >> 16; j < b; ++j) {")],
    # wrong on purpose: no x staging copies; no x reads or FMAs (the index
    # walk alone)
    "f32-no-staging": [("if (f < fw) cp_async16_x(st + k * kFB + f, src + (size_t)k * ldx + f);",
                        "(void)src;")],
    "f32-walk-only": [("FVec<VEC>::fma(acc[i], __int_as_float(en.x), xv);",
                       "acc[i][0] += __int_as_float(en.x);")],
}
# name -> [(text, replacement)] in csrc/sddmm.cu: K8's design steps and
# wrong-on-purpose variants (no stores; no products)
SDDMM_VARIANTS = {
    "as-is": [],  # the checkout's source: its ptxas line
    "one-cta-an-sm": [("constexpr int kFmaCtas = kNCF == 128 ? 2 : 3;",
                       "constexpr int kFmaCtas = 1;"),
                      ("cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem)",
                       "(per_sm = 1, cudaSuccess)")],
    "fma-unroll-1": [("#pragma unroll 2\n    for (int k = 0; k < kn; ++k) {",
                      "#pragma unroll 1\n    for (int k = 0; k < kn; ++k) {")],
    "fma-unroll-4": [("#pragma unroll 2\n    for (int k = 0; k < kn; ++k) {",
                      "#pragma unroll 4\n    for (int k = 0; k < kn; ++k) {")],
    # f32: 128 × 64 outputs a step, 8 × 4 a thread, three CTAs an SM
    "f32-64-columns": [("constexpr int kNCF = 128;", "constexpr int kNCF = 64;")],
    # the f32 staging's row pitch 128: the k-fastest copies' writes 32 ways
    # conflicting; the bf16 fragments stored straight (8 bytes a lane)
    "f32-pitch-128": [("constexpr int kSF = kBlk + 4;", "constexpr int kSF = kBlk;")],
    "bf16-direct-stores": [("constexpr bool kStoreViaSmem = true;",
                            "constexpr bool kStoreViaSmem = false;")],
    "no-stores": [("    if (p.kc == nkc - 1) {\n      float* dst = out + ((size_t)p.t * tile_r + p.rb * kBlk) * tile_c",
                   "    if (p.kc == nkc - 1 && acc[0][0] == 12345.0f) {\n      float* dst = out + ((size_t)p.t * tile_r + p.rb * kBlk) * tile_c"),
                  ("    if (p.kc == nkc - 1) {\n      if constexpr (kStoreViaSmem) {",
                   "    if (p.kc == nkc - 1 && acc[0][0] == 12345.0f) {\n      if constexpr (kStoreViaSmem) {")],
    "no-products": [("for (int k = 0; k < kn; ++k) {\n      const float4 a0", "for (int k = 0; k < 0; ++k) {\n      const float4 a0"),
                    ("mma_bf16(acc[n], a0, a1, a2, a3, lds32(br), lds32(br + 8));",
                     "acc[n][0] += __uint_as_float(a0 ^ lds32(br));")],
}
_PTXAS_WALK = (("spmm_walk_kernelILi2ELi2EE", "walk 32x64"),
               ("spmm_walk_kernelILi4ELi1EE", "walk 16x128"))
_PTXAS_SDDMM = (("sddmm_fma_kernel", "K8 f32"), ("sddmm_mma_kernel", "K8 bf16"))


def _start_parent_build(parent: str, rel: str, family: str):
    """nvcc of ``parent``'s ``rel`` (one source of its package, with its
    headers) into ``.smoke/variants/<family>/libparent.so``, in a thread;
    returns a function that waits and gives the library's path (None and
    the error printed when the build fails)."""
    import threading

    from parallel_gcn_tpu_torch.ops import _build

    out_dir = os.path.join(ROOT, ".smoke", "variants", family)
    os.makedirs(out_dir, exist_ok=True)
    lib = os.path.join(out_dir, "libparent.so")
    res = {}

    def build():
        try:
            _build._run_nvcc([os.path.join(os.path.abspath(parent), PKG, rel)], lib)
            res["lib"] = lib
        except RuntimeError as e:
            print(f"[variant] the parent's {rel} not built: {e}", flush=True)

    th = threading.Thread(target=build)
    th.start()
    return lambda: (th.join(), res.get("lib"))[1]


def _check(torch, got, ref, rtol) -> float:
    """max |got - ref| after asserting it within rtol·|ref| + 1e-5·max|ref|."""
    err = (got - ref).abs()
    assert bool((err <= rtol * ref.abs() + 1e-5 * ref.abs().max()).all()), float(err.max())
    return float(err.max())


def _parent_spmm(torch, cb, lib, pack, x):
    """The parent's tile SpMM entry (its f32 body: FMAs over every tile
    entry) on ``pack`` and f32 x, called as the parent's wrapper called it."""
    import ctypes

    sched = pack.spmm_schedule
    out = torch.empty((pack.n_rows, x.shape[1]), dtype=torch.float32, device=x.device)
    ws = torch.empty((sched.n_slots, pack.tile_r, x.shape[1]), dtype=torch.float32,
                     device=x.device)
    rc = lib.pgcn_bcsr_spmm(
        pack.tiles.data_ptr(), cb._DTYPE_CODE[pack.tiles.dtype], sched.seg_tile_ptr.data_ptr(),
        sched.seg_row.data_ptr(), sched.seg_slot.data_ptr(), sched.n_seg,
        sched.multi_row.data_ptr(), sched.multi_slot_ptr.data_ptr(), sched.multi_row.shape[0],
        pack.tile_cols.data_ptr(),
        pack.sym_scale.data_ptr() if pack.sym_scale is not None else None, x.data_ptr(), 0,
        out.data_ptr(), ws.data_ptr(), pack.tile_r, pack.tile_c, x.shape[1], x.shape[1],
        int(pack.nonneg_tiles), ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    assert rc == 0, rc
    return out


def _spmm_f32_row(torch, cb, label, pack, x, parent_lib, csr):
    """One case of ``spmm-f32``: the walk at each shape against the plain
    version (two runs bit-identical); the parent's f32 body (its FMA kernel
    over every tile entry, the parent's library loaded in this process) and
    this tree's default in turns (parent, change, change, parent);
    ``torch.sparse.mm`` on f32 x; the bound of the walk's bytes (index, x,
    out)."""
    got = cb.bcsr_matmul_impl(pack, x)
    assert torch.equal(got, cb.bcsr_matmul_impl(pack, x)), f"{label}: two runs differ"
    err = _check(torch, got, cb.bcsr_matmul_plain(pack, x), 1e-4)
    walk = {}
    old = cb.SPMM_WALK_WIDE
    for shape, wide in (("32x64", 1 << 30), ("16x128", 0)):
        cb.SPMM_WALK_WIDE = wide
        o = cb.bcsr_matmul_impl(pack, x)
        assert torch.equal(o, cb.bcsr_matmul_impl(pack, x)), f"{label} {shape}: runs differ"
        _check(torch, o, got, 1e-5)
        walk[shape] = _events_ms(lambda: cb.bcsr_matmul_impl(pack, x))
    cb.SPMM_WALK_WIDE = old
    idx = pack.spmm_index
    default = '16x128' if x.shape[1] > cb.SPMM_WALK_WIDE else '32x64'
    live = idx.ent.shape[0] / (pack.n_tiles * pack.tile_c)
    times = []
    for who in ("parent", "change", "change", "parent"):
        if who == "parent":
            if parent_lib is not None:
                times.append("parent " + format(_events_ms(
                    lambda: _parent_spmm(torch, cb, parent_lib, pack, x), 3), ".4f"))
        else:
            times.append(f"change {_events_ms(lambda: cb.bcsr_matmul_impl(pack, x)):.4f}")
    nbytes = sum(t.numel() * t.element_size() for t in (idx.ent, idx.rptr, x, got))
    lib_ms = _events_ms(lambda: torch.sparse.mm(csr, x)) if csr is not None else float("nan")
    print(f"[spmm-f32] {label}: max_abs_err {err:.3e} (rtol 1e-4), runs bit-identical; walk "
          f"{', '.join(f'{k} {v:.4f}' for k, v in walk.items())} ms (the default: {default}; "
          f"{live:.2f} live entries a tile column); "
          f"{', '.join(times)} ms; torch.sparse.mm f32 {lib_ms:.4f} ms; bound "
          f"{nbytes / 3.35e12 * 1e3:.4f} ms ({nbytes} bytes: index, x, out)", flush=True)
    return got


def spmm_f32_family(parent: str | None) -> int:
    """The f32 tile SpMM body (K3/K4 at f32) of the checkout: the walk at
    both shapes, its source variants and segment lengths, the dense FMA body
    of this tree and of ``parent``, ``torch.sparse.mm``; on synth-reddit's
    pack at F=41 and 602 and on a random products-sized pack at F=100."""
    import dataclasses

    import numpy as np
    import torch

    sys.path.insert(0, ROOT)
    from parallel_gcn_tpu_torch.harness.pack_census import _random_pack
    from parallel_gcn_tpu_torch.ops import _build
    from parallel_gcn_tpu_torch.ops import cuda_bcsr as cb

    torch.backends.cuda.matmul.allow_tf32 = False
    join = _start_builds(SPMM, SPMM_F32_VARIANTS, "spmm-f32")
    parent_join = _start_parent_build(parent, SPMM, "spmm-f32") if parent else (lambda: None)
    base = _build.load_library()
    print(f"[spmm-f32] base ptxas: {_ptxas(_build.build_info['log'], _PTXAS_WALK)}", flush=True)
    from parallel_gcn_tpu_torch.config import default_params_path, load_config
    from parallel_gcn_tpu_torch.data.parser import prepare_device_dataset

    cfg = load_config(default_params_path("synth-reddit"))
    _, dds = prepare_device_dataset(cfg, "synth-reddit", torch.device("cuda"))
    pack = dds.graph.bcsr
    x602 = dds.x.float().contiguous()
    gen = torch.Generator().manual_seed(2)
    x41 = torch.randn((pack.n_nodes, 41), generator=gen).cuda()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    idx = pack.spmm_index
    torch.cuda.synchronize()
    print(f"[spmm-f32] synth-reddit pack: {pack.n_tiles} tiles {pack.tile_r}x{pack.tile_c} "
          f"int8; the index: {idx.ent.shape[0]} entries, {idx.rptr.numel()} row offsets, built in "
          f"{time.perf_counter() - t0:.4f} s; again (events) "
          f"{_events_ms(lambda: cb.spmm_index(pack), 3):.4f} ms", flush=True)
    # how the live entries spread over the walk's units: a step (tile, chunk)
    # of a CTA, its warps' runs (16 and 32 rows), its rows
    cnt = (idx.rptr[1:] - idx.rptr[:-1]).view(pack.n_tiles, -1, pack.tile_r).float()
    for rows in (16, 32):
        g = cnt.view(cnt.shape[0], cnt.shape[1], -1, rows).sum(-1)
        q = torch.quantile(g.flatten()[:1 << 24], torch.tensor([0.5, 0.99], device=g.device))
        print(f"[spmm-f32] entries a warp's run of {rows} rows a chunk: mean "
              f"{float(g.mean()):.1f}, median {float(q[0]):.0f}, p99 {float(q[1]):.0f}, max "
              f"{float(g.max()):.0f}; the busiest warp of a 512-row step: mean "
              f"{float(g.view(g.shape[0], g.shape[1], -1).amax(-1).mean()):.1f}", flush=True)
    print(f"[spmm-f32] entries a row a chunk: max {float(cnt.max()):.0f}, rows with more than "
          f"2: {float((cnt > 2).float().mean()):.4f}", flush=True)
    del cnt
    parent_lib = parent_join()
    if parent_lib is not None:
        import ctypes

        parent_lib = ctypes.CDLL(parent_lib)
        parent_lib.pgcn_bcsr_spmm.argtypes = base.pgcn_bcsr_spmm.argtypes
        parent_lib.pgcn_bcsr_spmm.restype = base.pgcn_bcsr_spmm.restype
    libs, errors = join()
    for name, err in errors.items():
        print(f"[spmm-f32] {name} not built: {err}", flush=True)
    pattern = dataclasses.replace(pack, sym_scale=None)
    cases = [("K4 F=41", pack, x41), ("K4 F=602 (the set-up Â·X)", pack, x602),
             ("K3 F=41", pattern, x41), ("K3 F=602", pattern, x602)]
    import chip_smoke  # the smoke's CSR of a pack, for the library call

    csrs = {id(pack): chip_smoke._pack_csr(pack), id(pattern): chip_smoke._pack_csr(pattern)}
    for label, pk, x in cases:
        _spmm_f32_row(torch, cb, label, pk, x, parent_lib, csrs[id(pk)])
    rows_np = pack.tile_rows.cpu().numpy()
    for tiles in (2, 8):
        sched = cb.tile_schedule(rows_np, pack.n_tile_rows, tiles).to(pack.tiles.device)
        pk = dataclasses.replace(pack, spmm_schedule=sched)
        pk.__dict__["spmm_index"] = idx
        print(f"[spmm-f32] segments of {tiles} tiles: K4 F=41 "
              f"{_events_ms(lambda: cb.bcsr_matmul_impl(pk, x41)):.4f} ms, F=602 "
              f"{_events_ms(lambda: cb.bcsr_matmul_impl(pk, x602)):.4f} ms", flush=True)
    for name, (path, log) in libs.items():
        _load_variant(path, base, ["pgcn_bcsr_spmm", "pgcn_bcsr_spmm_walk"])
        o41, o602 = cb.bcsr_matmul_impl(pack, x41), cb.bcsr_matmul_impl(pack, x602)
        print(f"[spmm-f32] {name}: K4 F=41 {_events_ms(lambda: cb.bcsr_matmul_impl(pack, x41)):.4f}"
              f" ms ({_digest(o41)}), F=602 "
              f"{_events_ms(lambda: cb.bcsr_matmul_impl(pack, x602)):.4f} ms ({_digest(o602)}) "
              f"[ptxas: {_ptxas(log, _PTXAS_WALK)}]", flush=True)
    _build._lib = base
    print(f"[spmm-f32] base digests: F=41 {_digest(cb.bcsr_matmul_impl(pack, x41))}, F=602 "
          f"{_digest(cb.bcsr_matmul_impl(pack, x602))}", flush=True)
    del dds, x602, x41, csrs, pack, pattern, idx
    torch.cuda.empty_cache()
    # products' set-up Â·X at F=100 over a random pack of the full run's 28,704 tiles
    rpack = _random_pack(4784, 512, 6, np.random.default_rng(16)).to(torch.device("cuda"))
    x100 = torch.randn((rpack.n_nodes, 100), device="cuda")
    _spmm_f32_row(torch, cb, f"K4 F=100 over {rpack.n_tiles} random 512x512 tiles", rpack,
                  x100, parent_lib, chip_smoke._pack_csr(rpack))
    return int(bool(errors))


def _sddmm_parent_call(torch, lib, pack, a, b):
    """The parent's K8 entry (same C signature) on unpadded a, b."""
    import ctypes

    out = torch.empty((pack.n_tiles, pack.tile_r, pack.tile_c), dtype=torch.float32,
                      device=a.device)
    rc = lib.pgcn_sddmm(pack.tile_rows.data_ptr(), pack.tile_cols.data_ptr(), pack.n_tiles,
                        a.data_ptr(), b.data_ptr(), 0 if a.dtype == torch.float32 else 1,
                        a.shape[1], out.data_ptr(), pack.tile_r, pack.tile_c,
                        ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    assert rc == 0, rc
    return out


def sddmm_family(parent: str | None) -> int:
    """K8 of the checkout and its source variants, and of ``parent``, on
    synth-reddit's square 512x512 int8 pack with a, b [n, 41] in f32 and
    bf16 (parent, change, change, parent); ``torch.bmm`` of the gathered
    blocks; and the dense f32 SpMM body at K8's backward shape (the score
    cotangent's value tiles · b [n, 41] f32) of this tree and the parent."""
    import ctypes
    import dataclasses

    import torch

    sys.path.insert(0, ROOT)
    from parallel_gcn_tpu_torch.config import default_params_path, load_config
    from parallel_gcn_tpu_torch.data.parser import prepare_host_dataset, to_device
    from parallel_gcn_tpu_torch.ops import _build
    from parallel_gcn_tpu_torch.ops import cuda_bcsr as cb
    from parallel_gcn_tpu_torch.ops import cuda_sddmm as cs

    torch.backends.cuda.matmul.allow_tf32 = False
    join = _start_builds("csrc/sddmm.cu", SDDMM_VARIANTS, "sddmm")
    pj_sddmm = _start_parent_build(parent, "csrc/sddmm.cu", "sddmm") if parent else None
    pj_spmm = _start_parent_build(parent, SPMM, "sddmm-spmm") if parent else None
    base = _build.load_library()
    print(f"[sddmm] base ptxas: {_ptxas(_build.build_info['log'], _PTXAS_SDDMM)}", flush=True)
    cfg = load_config(default_params_path("synth-reddit"))
    ds = prepare_host_dataset(cfg, "synth-reddit")
    pack = to_device(ds, device=torch.device("cuda"), node_pad=cfg.tpu.node_pad, hybrid=True,
                     tile_dtype="int8", tile_size=512, tile_cols=512,
                     tile_budget_mb=cfg.tpu.tile_budget_mb,
                     min_tile_nnz=cfg.tpu.min_tile_nnz).graph.bcsr
    del ds
    n, T, R = pack.n_nodes, pack.n_tiles, pack.tile_r
    print(f"[sddmm] synth-reddit square pack: {T} int8 tiles {R}x{pack.tile_c}", flush=True)
    plib = None
    if pj_sddmm is not None and (path := pj_sddmm()) is not None:
        plib = ctypes.CDLL(path)
        plib.pgcn_sddmm.argtypes = base.pgcn_sddmm.argtypes
        plib.pgcn_sddmm.restype = base.pgcn_sddmm.restype
    libs, errors = join()
    for name, err in errors.items():
        print(f"[sddmm] {name} not built: {err}", flush=True)
    gen = torch.Generator().manual_seed(8)
    rows, cols = pack.tile_rows.long(), pack.tile_cols.long()
    inputs = {}
    for dtype, rtol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-3)):
        a = torch.randn((n, 41), generator=gen).to(dtype).cuda()
        b = torch.randn((n, 41), generator=gen).to(dtype).cuda()
        inputs[dtype] = (a, b)
        out = cs.sddmm_bcsr(pack, a, b)
        assert torch.equal(out, cs.sddmm_bcsr(pack, a, b)), "K8: two runs differ"
        ref = cs.sddmm_plain(pack, a, b)
        err = _check(torch, out, ref, rtol)
        same = torch.equal(out, ref)
        del ref
        times = []
        for who in ("parent", "change", "change", "parent"):
            if who == "parent" and plib is None:
                continue
            fn = ((lambda: _sddmm_parent_call(torch, plib, pack, a, b)) if who == "parent"
                  else (lambda: cs.sddmm_bcsr(pack, a, b)))
            times.append(f"{who} {_events_ms(fn, 6):.4f}")
        a3, b3 = a.view(-1, R, 41), b.view(-1, R, 41)
        bmm = _events_ms(lambda: torch.bmm(a3[rows], b3[cols].transpose(1, 2)), 3)
        flops = 2 * T * R * pack.tile_c * 41
        nbytes = out.numel() * 4 + 2 * a.numel() * a.element_size()
        bound = max(nbytes / 3.35e12, flops / (67e12 if dtype == torch.float32 else 989e12))
        print(f"[sddmm] K8 {dtype}: max_abs_err {err:.3e} (rtol {rtol}; bit-equal to plain: "
              f"{same}), runs bit-identical; {', '.join(times)} ms; torch.bmm {bmm:.4f} ms; "
              f"bound {bound * 1e3:.4f} ms; digest {_digest(out)}", flush=True)
        del out
        torch.cuda.empty_cache()
    for name, (path, log) in libs.items():
        _load_variant(path, base, ["pgcn_sddmm"])
        parts = []
        for dtype, (a, b) in inputs.items():
            out = cs.sddmm_bcsr(pack, a, b)
            parts.append(f"{dtype} {_events_ms(lambda: cs.sddmm_bcsr(pack, a, b), 6):.4f} ms "
                         f"({_digest(out)})")
            del out
        print(f"[sddmm] {name}: {'; '.join(parts)} [ptxas: {_ptxas(log, _PTXAS_SDDMM)}]",
              flush=True)
    _build._lib = base
    # the value-pack route at K8's backward shape: dA = G·b over the pack's
    # positions, G dense f32 value tiles
    a, b = inputs[torch.float32]
    g = torch.randn((T, R, pack.tile_c), device="cuda")
    gpack = dataclasses.replace(pack, sym_scale=None, tiles=g)
    fn = lambda: cb.bcsr_matmul_impl(gpack, b, dense_tiles=True)  # noqa: E731
    got = fn()
    assert torch.equal(got, fn())
    err = _check(torch, got, cb.bcsr_matmul_plain(gpack, b), 1e-4)
    plib2 = pj_spmm() if pj_spmm is not None else None
    times = []
    for who in ("parent", "change", "change", "parent"):
        if who == "parent" and plib2 is None:
            continue
        if who == "parent":
            _load_variant(plib2, base, ["pgcn_bcsr_spmm"])
        times.append(f"{who} {_events_ms(fn, 3):.4f}")
        _build._lib = base
    nbytes = g.numel() * 4 + b.numel() * 4 + got.numel() * 4
    print(f"[sddmm] the dense f32 SpMM body at K8's backward shape ({T} f32 value tiles · "
          f"b [{n}, 41]): max_abs_err {err:.3e} (rtol 1e-4), runs bit-identical; "
          f"{', '.join(times)} ms; bound {nbytes / 3.35e12 * 1e3:.4f} ms (bytes)", flush=True)
    return int(bool(errors))


def main(argv: list[str]) -> int:
    if argv[:1] == ["--time-spmm"]:
        time_spmm_tree(argv[1])
        return 0
    if argv[:1] == ["--time-spmm-wide"]:
        time_spmm_wide_tree(argv[1])
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
                "dropout": dropout_family, "fused": fused_family, "segment": segment_family,
                "segment-paths": segment_paths, "spmm-f32": spmm_f32_family,
                "spmm-wide": spmm_wide_family,
                "sddmm": sddmm_family}
    if argv[:1] == ["segment-paths"] and "--only" in argv:
        return segment_paths(parent, argv[argv.index("--only") + 1].split(","))
    if argv[:1] and argv[0] in families:
        return families[argv[0]](parent)
    if argv:
        print(f"error: unknown family {argv[0]}; known: {list(families)}")
        return 2
    return spmm_family(None) or fused_family(None)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
