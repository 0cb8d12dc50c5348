#!/usr/bin/env python3
"""GPU smoke test of parallel_gcn_tpu_torch on one NVIDIA card.

    python3 chip_smoke.py [--parent DIR]

``--parent DIR``: another checkout (the parent commit unpacked with ``git
archive``), whose ordered sums (``csrc/segment_sum.cu``) are built alone
and timed beside this tree's on the same inputs, bit-equal to them.

Phases, each printed on its own lines:
  1. device: nvidia-smi's name and power limit, torch's device name;
  2. build: compiles the CUDA kernels (csrc/*.cu) in a thread while the
     host sets up synth-reddit, and prints the seconds;
     the native loader (``csrc/loader.cpp``, g++ with OpenMP: a failed build
     fails the run); ``[native]``: its label sweep against the numpy sweep on
     synth-reddit's hub-excluded edges and ``load_dataset_native`` against
     the numpy reader on synth-medium written as reference-format files to a
     temporary directory, equal, both timed;
  3. kernels: each kernel against its plain PyTorch version on the card, at
     the shapes synth-reddit's training gives it (dropout bit-equal, also on
     ragged lengths and on views that are not 16-byte aligned; tile
     SpMM forward and backward within rtol 1e-4 for f32 x and 2e-3 for bf16
     x, atol 1e-5·max|ref| for both; GAT tile attention K5/K6 at heads 2,
     d 32 and 41, bf16 and f32, attention dropout 0 and 0.6, forward within
     rtol 1e-4 (f32) / 2e-3 (bf16) + 1e-5·max|ref|, gradients within rtol
     1e-3 + 1e-4·max|ref|, two runs bit-identical), with CUDA-event times
     and two bounds each (over the pack's live-column index, which K5/K6
     read, and over the tile stream of the earlier design);
     the tile SpMM K4/K3 also at F=600 bf16 with ``torch.sparse.mm`` at
     F=600 beside it, at F=41, 82 and 602 in f32 (the f32 body over the
     pack's live-entry index, its build timed, with ``torch.sparse.mm`` on
     the same f32 x at each width; F=602 is the set-up pre-aggregation's
     call) and as GIN's layer-0 input (the bf16 features scaled by
     sqrt_deg), two runs of each bit-identical, and ``torch.sparse.mm`` at
     the stacked F=82;
     The fused kernels: masked softmax-CE K9 (train and eval variants) at
     synth-reddit's [233472, 41] f32 logits with its train and val masks
     and at ``CE_SHAPES`` (C 7 to 100, int32 and int64 labels, unaligned
     views; loss rtol 1e-5, accuracy exact, gradient rtol 2e-5 + 1e-5·
     max|ref|); dropout⊗matmul K10 forward, dW and dX at layer 1's
     [233472, 600] bf16 × [600, 41] and at ``FUSED_SHAPES`` (ragged n, k
     and m, the configs' other fused layers, f32 and bf16, rates 0.1 to
     0.6; f32 outputs rtol 1e-4, bf16 outputs one bf16 ulp, + 1e-5·
     max|ref|; the mask an identity W recovers bit-equal to K1's; dX's
     byte bound beside the f32-operation bound of a CUDA-core product; K9
     and K10 timed by their device time, ``torch.profiler``).
     Two runs of each are
     bit-identical. The seeded kernels (K1, K2, K5, K6, K7, K10) read their
     seed from a slot on the card, as the trainer passes it; their plain
     versions take the int; K1's and K2's output digests at fixed inputs
     must be the recorded ones (the mask contract's bits); K1 at an element
     offset (the streaming GAT's chunks) bit-equal to the matching slice of
     K1 without one and to its plain version. The ordered
     segment sums (``csrc/segment_sum.cu``) at synth-reddit's residual: the
     gather-sum of the GCN's residual at 41 and 82 columns (bf16) and at 41
     (f32), of SAGE's and GIN's at 600 columns and of GIN's layer-0 input at
     602 (bf16), and the sums of the GAT's per-edge terms [E, 2] and [E, 2, 41]
     (f32) and [E, 2, 41] (bf16), bit-equal to their plain version on the
     CPU in the same dtype (f32 sums in item order, one rounding: the
     kernels' order and accumulation; within rtol 1e-5 + 1e-5·max|ref| as
     the stated tolerance), two runs bit-identical, beside ``index_add_`` on
     the card and ``torch.sparse.mm`` / ``torch.segment_reduce``; and over
     the flat COO of all of Â (``backend=segment``, 11.84M entries, rows of
     up to 30,418): (a) at 41, 82 and 600 bf16, (b) at [E, 2] and [E, 2, 41]
     f32, bit-equal to the plain version over every row (41) or over the
     hub rows and 1,000 seeded rows, with the row-length histogram and (a)
     over the hub rows alone; with ``--parent`` each beside the parent's
     kernel. Beside each
     kernel's time: its plain version's, the
     unfused pair it replaces (K10), and the one PyTorch call that computes
     the same function where there is one (``torch.sparse.mm`` for K3/K4,
     ``torch.nn.functional.dropout`` for K1);
  4. profile: the synth-reddit GCN's, GAT's, fused GCN's
     (``ce_impl=pallas fuse_dropout_matmul=true``), SAGE's and GIN's epochs
     under ``torch.profiler``, eager and as the scan's replay: device time by
     op and the device's idle share (the scan's against the host clock of
     unprofiled replays);
  5. reference: a small hybrid int8 graph trains 3 epochs on the card and on
     the CPU (the plain versions), as a GCN and as a GAT with feature and
     attention dropout, and with the fused kernels (a GCN with both knobs
     and dropouts 0.3/0.3 without pre-aggregation, a GAT with
     ``ce_impl=pallas``), and as SAGE and GIN-0 (learning rate 0.01,
     dropout 0.3 at both layers) over 16 tiles and a COO residual
     (``min_tile_nnz=400``: K4 and kernel (a)); the metrics must agree within
     2e-4. Then the
     dense backend: generated graphs at cora's and citeseer's sizes (2,708
     / 3,327 nodes, 1,433 / 3,703 features, 7 / 6 classes) train the GCN,
     the GAT (2 heads of 8, attention dropout 0.6), SAGE and GIN for 3
     epochs from those datasets' parameter files in f32 on the card and on
     the CPU: metrics within 2e-4;
  6. sddmm: K8 on synth-reddit's int8 pack built with square 512×512 tiles,
     forward at a, b [n, 41] f32 (rtol 1e-5, and bit-equal to its plain
     version) and bf16 (rtol 2e-3) + 1e-5·max|ref| against its plain
     version, the backward through autograd with the pack's tiles as loss
     weights (dA = W·b, dB = W·a within rtol 1e-4 in f32, one bf16 ulp in
     bf16), two runs bit-identical, beside the gathered ``torch.bmm``; the
     backward's SpMM alone (the dense f32 body over f32 value tiles at the
     pack's positions · b [n, 41] f32) timed;
     mesh kernels: K3, K5 and both K7 sweeps over rank 0's slab of
     synth-reddit's mesh partition at one rank (square) and at 4 ranks with
     the boundary halo (rectangular, built on the host), against their
     plain versions with the tolerances of phase 3 (K3 at F 41 and 600 bf16
     and 602 f32, ``torch.sparse.mm`` at 41 and 600; attention at heads 2,
     d 32 and 41, bf16, attention dropout 0 and 0.6, with bounds over the
     slab's live-column index and streaming the slab), two runs
     bit-identical; the ordered sums over the one-rank slab's residual (by
     local row, and the GAT's by source through its permutation); then
     ``fit_parallel`` in a
     world of one on a small graph, on the card (NCCL) and on the CPU
     (gloo), as a GCN over flat and over hybrid int8 slabs and as a GAT over
     ``gat_mesh_pack`` slabs: metrics within 2e-4; halo kernels
     (``[halo-kernels]``): 4 ranks of synth-reddit's flat adaptive and ring
     partitions and of the hub graph's int8 tile adaptive partition
     (233,472 nodes, synth-reddit's tiles) emulated on the card, each rank's
     ring steps, pulled sums, push partials (K3 over the push tiles) and
     ordered receive-adds, the exchanged rows moved by indexing: Â·x at F=41
     and 600 bf16 and 602 f32 against the single-card aggregation
     (``check_halo_case`` states the tolerances), at F=41 against the plain
     versions on the CPU, the gradient through the self-adjoint route, two
     runs bit-identical, each piece's time beside the buffer rows of the
     boundary and all_gather layouts; tensor parallelism
     (``[tp-emulated]``): tp = 2 and 4 feat ranks of one node rank as
     threads of this process taking turns (the feat collectives become
     concatenations and sums in feat-rank order; the node rank's halo runs
     over an NCCL world of one), driving the port's TP layers (``MeshGCN``,
     ``MeshSAGE``, ``MeshGIN`` with an emulated feat group) at synth-reddit's
     602 -> 600 -> 41 on the one-rank int8 slab: one training forward and
     backward against the same model at tp 1 (``phase_tp_emulated`` states
     the tolerances), with the file's dropouts two runs bit-identical (their
     launches counted as a main path's), and K3 and kernel (a) at 300 and 150
     columns against their plain versions;
  7. main paths, each in ``mode=scan`` (the whole-run path: epoch 1, the
     capture of the epoch as one CUDA graph, 9 replays) with the launch
     counts set to 0 just before it:
     ``parallel_gcn_tpu_torch.cli.main(["synth-reddit", "epochs=10"])`` (the
     GCN), ``[main-gcn-f32]`` the same through ``train.fit`` at
     ``compute_dtype=float32`` (every aggregation on K4's f32 body: ms/epoch,
     the set-up pre-aggregation's seconds, the f32 launches), the same with ``model=gat heads=2 hidden_dims=32
     dropouts=0.0,0.1`` (the GAT), with ``ce_impl=pallas
     fuse_dropout_matmul=true`` (the fused GCN), with ``model=sage`` and
     with ``model=gin gin_eps=0`` (602 -> 600 -> 41); the GCN and the GAT
     again through ``train.fit`` with and without ``remat=true`` (bit-equal
     to each other and to the run without it, the peak
     ``max_memory_allocated`` of each); then the mesh trainer
     ``parallel.train_parallel.fit_parallel`` at ``n_devices=1`` (a world of
     one over NCCL) with ``halo=boundary``, as the GCN, the GAT, SAGE and
     GIN, each beside the single-card epoch of this run; then the mesh GCN
     and SAGE over flat COO slabs with ``halo=ring`` and the mesh GCN with
     ``halo=adaptive`` over flat and over int8 tile slabs (one rank: the
     ring is one slab, the adaptive halo falls back to all_gather); the
     segment GAT with attention dropout 0.1 through ``cli.main`` without and
     with ``edge_chunk=1048576`` (train losses within 1e-3, the chunked
     run's peak ``max_memory_allocated`` lower; one layer's chunked
     attention against the unchunked one, ``check_attention_chunked``) and
     the mesh GAT with the same ``edge_chunk``; the losses must be
     finite and fall, except GIN's (at the file's rate its loss rises, as in
     the JAX package: ``GIN_ARGS``); each path's launches a replay (the
     wrappers count a captured epoch once, at its capture) must be its
     schedule's, and its launches (counted plus the replays' beyond the
     first) the epochs' and the evals'. Beside each, without PyTorch's
     deterministic algorithms, the same configuration twice in
     ``mode=scan`` and once in ``mode=eager`` (its ms/epoch): the three runs
     must be one run bit for bit (history, test metrics, weights); then,
     except for the mesh paths (for the time limit), both modes
     again with deterministic algorithms, whose train losses must agree
     within 1e-4;
  8. mesh profiles: the mesh GCN's, GAT's, SAGE's and GIN's epochs under
     ``torch.profiler``, eager and as the scan's replay (phase 4 profiles
     the single-card replays too);
  7b. seed batches (``seeds.fit_seeds``, ``mode=scan``, the launch counts set
     to 0 just before each): ``[seed-lanes]`` (with the kernel checks) holds
     K1 and K2 over seed lanes (one launch, lane s's seed at its solo element
     index; a joined, per-lane or shared input, joined or per-lane output)
     bit-equal to their plain versions at [233472, 4·600] bf16, [2708,
     8·1433] and [3327, 4·3703] f32 and lane by lane to the unlaned kernel,
     and K2's backward over lanes bit-equal to PyTorch's where, beside the
     unlaned kernel over the same bytes; and K10's forward, dW and dX over
     seed lanes (one launch each) at synth-reddit's fused layer 1 ([233472,
     4·600] bf16 x [4, 600, 41]) and the cora-sized graph's layers (the shared
     [2708, 1433] f32 input x [8, 1433, 72], no dX; [2708, 8·72] x [8, 72,
     7]), lane by lane bit-equal to the unlaned K10 on the lane's operands
     and within K10's tolerances of the laned plain version, beside S
     unlaned launches and the byte bound; ``[main-seeds]``: synth-reddit's
     GCN at full width as 4 lanes for 10 epochs, each lane bit-equal to its
     solo ``fit`` (history, test metrics, weights), the batch's replay
     profiled; ``[seeds-sage]``, ``[seeds-gin]`` (GIN-0), ``[seeds-gat]``
     (heads 2 of 32, attention dropout 0.1) and ``[seeds-fused]``
     (``ce_impl=pallas fuse_dropout_matmul=true``): synth-reddit at full width
     as 4 lanes for 10 epochs, each lane bit-equal to its solo ``fit``, the
     launches a replay the solo schedule's over the lanes (the GAT's 4 times
     the solo replay's, the fused GCN's K10 once over the lanes), each
     batch's replay profiled; ``[seeds-medium]``: synth-medium (segment) as
     16 lanes for 30 epochs, lanes 0, 5, 10, 15 bit-equal to their solo runs;
     ``[seeds-stop]``: a cora-sized graph on the dense backend in f32 as 8
     lanes with ``early_stopping=5`` that stop at different epochs, each where
     its solo run stops, histories within 1e-6, and ``[seeds-stop-fused]``
     the same with ``fuse_dropout_matmul=true`` (the f32 laned K10, layer 0
     over the shared input);
  7c. ``[main-products]``: synth-products at full width (100 -> 256 -> 47,
     hybrid, community reorder, 512x512 int8 tiles, the file's tile budget
     and ``min_tile_nnz``, bf16) with its node, edge, community and split
     counts cut to one eighth (``PRODUCTS_EIGHTH``): each set-up stage timed,
     K4 at 47 (bf16) and 100 (f32, beside ``torch.sparse.mm``) columns,
     the residual's gather-sum at 47
     and K2 on [n, 256] against their plain versions, then ``train.fit`` for
     ``PRODUCTS_EPOCHS`` epochs in ``mode=scan`` (the GCN's launches, a
     finite falling loss, ms/epoch, peak memory);
  7d. ``[products-shapes]``: K2, K4 and the residual's gather-sum at the
     full synth-products run's shapes and index widths on random inputs
     (activations [2,449,408, 256], 28,704 int8 tiles past 2^31 bytes,
     23,050,722 residual items with rows of up to 143,437) against their
     plain versions, K4's f32 line at F=100 beside ``torch.sparse.mm``;
  9. resume, after the GCN's, the GAT's and the mesh GCN's main path:
     through ``cli.main`` (the mesh GCN in a torchrun world of one), 10
     epochs with ``early_stopping=0 checkpoint_every=5 checkpoint_dir=``, bit-equal
     to the unchunked scan of phase 7, then ``resume_from=`` its
     ckpt_000005.npz: epochs 6-10, test metrics and final weights bit-equal;
     the seconds to write and load a checkpoint, the chunked ms/epoch.
Then one JSON line with every kernel's launches over all main paths (K3,
K3 f32 and K8, which no main path runs, under ``off_path_kernels``; the
tile SpMM's f32 body as "K4 f32" and "K3 rect f32", with its F=41 numbers
beside), error, times and bound
(the least time the card could take: the larger of the bytes each input
read once and each output written once at 3.35 TB/s, and the operations at
the peak rate of their type, H100 SXM data sheet), and last
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
# the GCN with both opt-in fused kernels (K9, K10)
FUSED_ARGS = ["ce_impl=pallas", "fuse_dropout_matmul=true"]
# the mesh paths (fit_parallel at n_devices=1): the GCN over the params
# file's hybrid int8 slabs and the GAT over gat_mesh_pack slabs
MESH_GCN_ARGS = ["halo=boundary"]
MESH_GAT_ARGS = [*GAT_ARGS, "halo=boundary"]
# GraphSAGE and GIN at synth-reddit's widths 602 -> 600 -> 41, on one card and
# on the mesh
SAGE_ARGS = ["model=sage"]
# GIN-0 at the parameter file's learning rate 0.01: its unnormalised sum over
# a mean degree of 51 makes Adam's first steps raise the train loss, in the
# JAX package as in the port (tests/test_torch_sage.py::
# test_gin_at_synth_reddits_rate_rises_in_both_packages), so its paths check
# finite losses and the card against the CPU (phase 5), not a falling loss
GIN_ARGS = ["model=gin", "gin_eps=0"]
MESH_SAGE_ARGS = [*SAGE_ARGS, "halo=boundary"]
MESH_GIN_ARGS = [*GIN_ARGS, "halo=boundary"]
# generated graphs at cora's and citeseer's sizes (the real files are absent),
# under dense_threshold 8192: the dense backend
DENSE_SETS = {
    "cora": dict(n_nodes=2708, n_edges=5429, input_dim=1433, n_classes=7, n_train=140,
                 n_val=500, feature_nnz_per_row=18, n_communities=7),
    "citeseer": dict(n_nodes=3327, n_edges=4732, input_dim=3703, n_classes=6, n_train=120,
                     n_val=500, feature_nnz_per_row=32, n_communities=6),
}

# the port's utils.timer and utils.profiling, bound by main once the checkout
# is on the path (the script imports nothing of the port before it has a card)
timer = profiling = None

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, FLOP/s by type
HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12}


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _bound(nbytes: int, flops: float = 0.0, kind: str = "bf16") -> dict:
    """The least time for moving ``nbytes`` and doing ``flops`` of ``kind``."""
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOPS[kind] * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def _pack_bytes(pack) -> int:
    """Bytes of a tile pack that a kernel over it reads: tiles, block
    columns, the segment schedule and the int8 pack's scale d."""
    sched = pack.schedule
    return _nbytes(pack.tiles, pack.tile_cols, sched.seg_tile_ptr, sched.seg_row,
                   sched.seg_slot, sched.multi_row, sched.multi_slot_ptr,
                   *([pack.sym_scale] if pack.sym_scale is not None else []))


def _walk_bytes(pack) -> int:
    """Bytes of a pack that the tile SpMM's f32 body reads: its live-entry
    index (``BCSR.spmm_index``), block columns and segment schedule."""
    idx, sched = pack.spmm_index, pack.spmm_schedule
    return _nbytes(idx.ent, idx.rptr, pack.tile_cols, sched.seg_tile_ptr, sched.seg_row,
                   sched.seg_slot, sched.multi_row, sched.multi_slot_ptr)


def _spmm_bound(pack, x, out) -> dict:
    """The tile SpMM's bound: the live entries' products at x's type's
    rate, and the bytes of x, out and what the route reads of the pack (the
    live-entry index for f32 x, the tiles for bf16)."""
    import torch

    nnz = int(pack.live_entries[0].numel())
    f32 = x.dtype == torch.float32
    nbytes = (_walk_bytes(pack) if f32 else _pack_bytes(pack)) + _nbytes(x, out)
    return _bound(nbytes, 2 * nnz * x.shape[1], "f32" if f32 else "bf16")


def _index_bytes(pack) -> int:
    """Bytes of a pack that K5/K6 read: its live-column index and the
    segment schedule's rows and slots."""
    idx, sched = pack.attn_index, pack.schedule
    return _nbytes(idx.ptr, idx.col, sched.seg_row, sched.seg_slot)


def _f32_body(pack) -> str:
    """How the f32 body's lines name it: with the pack's live entries a tile
    column (how many entries each staged x row serves)."""
    live = pack.spmm_index.ent.shape[0] / (pack.n_tiles * pack.tile_c)
    return f"f32 body (live entries, {live:.2f} a tile column)"


def _attn_bounds(pack, io: int, fmas_per: int, H: int, D: int) -> dict:
    """The bound of K5 (``fmas_per`` = 1 f32 FMA per live entry and
    feature) or K6 (3: both dot products and the dv update) over the pack's
    index with ``io`` bytes of inputs and outputs, and, as ``pack_bound_ms``,
    the earlier bound that streams the pack's tiles instead of the index."""
    nnz = int(pack.attn_index.col.numel())
    return dict(**_bound(_index_bytes(pack) + io, 2 * fmas_per * nnz * H * D, "f32"),
                pack_bound_ms=_bound(_pack_bytes(pack) + io)["bound_ms"])


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


def _slot(seed: int, dtype=None):
    """``seed`` in a seed slot on the card, as the trainer hands seeds to the
    kernels (``scan.SeedSlots``: a 0-d view into a device buffer), int64 by
    default (K1, K2, K10), int32 for the attention kernels."""
    import torch

    return torch.tensor([0, seed], dtype=dtype or torch.int64, device="cuda")[1]


def _det_input(shape, dtype):
    """Integer-generated values, the same on every machine and version."""
    import torch

    i = torch.arange(math.prod(shape), dtype=torch.int64)
    return (((i * 2654435761) % 2001 - 1000).to(torch.float32) / 37.0).view(shape).to(dtype)


def _digest(t) -> str:
    import hashlib

    import torch

    bits = t.contiguous().view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)
    return hashlib.sha256(bits.cpu().numpy().tobytes()).hexdigest()[:16]


# sha256 prefixes of K1's and K2's outputs at _det_input, seed 0x123456789ABC:
# the mask contract's bits, recorded from the kernels before their seed
# moved to device memory (tests/test_torch_scan.py holds the plain version
# to the same): (shape, dtype name, rate) -> (K1, K2)
DROPOUT_DIGESTS = {
    ((4099, 600), "bfloat16", 0.1): ("5d86b06a3c58a892", "430f751c272e9819"),
    ((1001, 257), "float32", 0.3): ("f03ceb28303e79c9", "069be357f1fecea1"),
}


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
    """Starts the kernels' build (one nvcc a source) in a thread, so that the
    host's set-up of the dataset runs beside it; returns a function that
    waits for the build, raises its error if it failed and prints its
    lines."""
    import threading

    from parallel_gcn_tpu_torch.ops import _build

    res: dict = {}

    def build():
        t0 = time.perf_counter()
        try:
            _build.load_library()
        except BaseException as e:  # raised again in the main thread
            res["error"] = e
        res["secs"] = time.perf_counter() - t0

    th = threading.Thread(target=build)
    th.start()

    def finish():
        th.join()
        if "error" in res:
            raise res["error"]
        print(f"[build] kernels built and loaded in {res['secs']:.2f} s, beside the dataset's "
              f"set-up ({os.path.basename(_build.build_info['path'])})")
        for line in _build.build_info["log"].splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {line.strip()}")

    return finish


def check_dropout(results: dict) -> None:
    """K1, K2 and K1's backward bit-equal to the plain version at the main
    paths' shapes, on lengths n ≡ 0…7 (mod 8) and on views whose data is not
    16-byte aligned; their times (CUDA events over wrapper calls, and the
    kernel's own device time) beside ``F.dropout``'s on the same input."""
    import torch

    from parallel_gcn_tpu_torch.ops import cuda_dropout as cd

    gen = torch.Generator().manual_seed(1)
    seed = 0x1234_5678_9ABC
    slot = _slot(seed)  # the kernels read the seed here; the plain versions take the int
    for (shape, dtype_name, rate), want in DROPOUT_DIGESTS.items():
        x = _det_input(shape, getattr(torch, dtype_name)).cuda()
        got = (_digest(cd.dropout(x, slot, rate)), _digest(cd.relu_dropout(x, slot, rate)))
        assert got == want, f"K1/K2 output digests {got} at {shape} {dtype_name}, not {want}"
    print(f"[kernels] K1, K2 output digests through the seed slot = the recorded ones: "
          f"{DROPOUT_DIGESTS}")
    # the kernel's scalar path: ragged lengths and storage offsets
    for dtype in (torch.bfloat16, torch.float32):
        for r in range(8):
            for offset in (0, 1, 3):
                n = 8 * 100_003 + r
                x = torch.randn(offset + n, generator=gen).to(dtype).cuda()[offset:]
                g = torch.randn(offset + n, generator=gen).to(dtype).cuda()[offset:]
                assert torch.equal(cd.dropout(x, slot, 0.1), cd.dropout_plain(x, seed, 0.1)), \
                    f"K1 != plain at n={n} offset {offset} {dtype}"
                assert torch.equal(cd.relu_dropout(x, slot, 0.1),
                                   cd.dropout_plain(x, seed, 0.1, relu=True)), \
                    f"K2 != plain at n={n} offset {offset} {dtype}"
                xr = x.clone().requires_grad_(True)
                cd.dropout(xr, slot, 0.1).backward(g)
                assert torch.equal(xr.grad, cd.dropout_plain(g, seed, 0.1)), \
                    f"K1 backward != plain at n={n} offset {offset} {dtype}"
    print("[kernels] K1, K2 and K1 backward (seed slot) bit-equal to plain (int seed) on "
          "n = 800024 + r, r = 0..7, at storage offsets 0, 1 and 3 elements (bf16 and f32)")
    # K2's shape on the GCN path, K1's on the GAT path (layer 1's input),
    # and a ragged f32 one
    for shape, dtype, rate in (((233472, 600), torch.bfloat16, 0.1),
                               ((233472, 64), torch.bfloat16, 0.1),
                               ((1001, 257), torch.float32, 0.3)):
        x = torch.randn(shape, generator=gen).to(dtype).cuda()
        g = torch.randn(shape, generator=gen).to(dtype).cuda()
        k1 = cd.dropout(x, slot, rate)
        p1 = cd.dropout_plain(x, seed, rate)
        assert torch.equal(k1, p1), f"K1 != plain at {shape} {dtype}"
        assert torch.equal(k1, cd.dropout(x, seed, rate)), "K1: slot != int seed"
        k2 = cd.relu_dropout(x, slot, rate)
        p2 = cd.dropout_plain(x, seed, rate, relu=True)
        assert torch.equal(k2, p2), f"K2 != plain at {shape} {dtype}"
        assert torch.equal(k2, cd.dropout(torch.relu(x), slot, rate)), "K2 != K1(relu)"
        keep = float((k1 != 0).float().mean())
        assert abs(keep - (1 - rate)) < 5e-3, f"keep-rate {keep}"
        # backward: K1 reruns on the cotangent, K2 reads its output
        xr = x.clone().requires_grad_(True)
        cd.dropout(xr, slot, rate).backward(g)
        assert torch.equal(xr.grad, cd.dropout_plain(g, seed, rate)), "K1 backward"
        xr = x.clone().requires_grad_(True)
        out = cd.relu_dropout(xr, slot, rate)
        out.backward(g)
        inv = torch.tensor(1 / (1 - rate), dtype=dtype).cuda()
        want = torch.where(out > 0, g * inv, torch.zeros((), dtype=dtype, device="cuda"))
        assert torch.equal(xr.grad, want), "K2 backward"
        ms1 = timer.events_ms(lambda: cd.dropout(x, slot, rate), 20)
        dev1 = profiling.kernel_ms(lambda: cd.dropout(x, slot, rate), 20, "dropout_kernel")
        pms1 = timer.events_ms(lambda: cd.dropout_plain(x, seed, rate), 3)
        ms2 = timer.events_ms(lambda: cd.relu_dropout(x, slot, rate), 20)
        dev2 = profiling.kernel_ms(lambda: cd.relu_dropout(x, slot, rate), 20, "dropout_kernel")
        pms2 = timer.events_ms(lambda: cd.dropout_plain(x, seed, rate, relu=True), 3)
        # the one PyTorch call for inverted dropout (another mask, from
        # PyTorch's generator; never on the port's path)
        lib_ms = timer.events_ms(lambda: torch.nn.functional.dropout(x, rate), 20)
        lib_dev = profiling.kernel_ms(lambda: torch.nn.functional.dropout(x, rate), 20, "dropout")
        bound = _bound(2 * _nbytes(x))
        for key, name, ms, dev, pms, what in (
                ("K1", "dropout", ms1, dev1, pms1, "fwd and bwd"),
                ("K2", "relu_dropout", ms2, dev2, pms2, "and to K1(relu), fwd and bwd")):
            print(f"[kernels] {key} {name} {list(shape)} {dtype} rate {rate}: seed slot "
                  f"bit-equal to plain {what}; keep-rate {keep:.6f}; kernel {ms:.4f} ms (device "
                  f"{dev:.4f}), plain {pms:.4f} ms, bound {bound['bound_ms']:.4f} ms "
                  f"({bound['bound_by']}), torch.nn.functional.dropout {lib_ms:.4f} ms (device "
                  f"{lib_dev:.4f})")
        if shape[1] == 64:
            results["K1"] = dict(err=0.0, ms=ms1, plain_ms=pms1, library_ms=lib_ms, **bound)
        elif dtype == torch.bfloat16:
            results["K2"] = dict(err=0.0, ms=ms2, plain_ms=pms2, **bound)


def check_dropout_offset() -> None:
    """K1 at an element offset (the streaming GAT's chunks): each slice,
    taken at a multiple of 4 elements, bit-equal to the matching slice of K1
    over the whole tensor without an offset, and to the plain version at
    that offset, through a view (the scalar path where the view is not
    16-byte aligned) and through a copy (the vector path), bf16 and f32;
    K1's backward at the offset too. Offsets that are not multiples of 4
    are refused."""
    import torch

    from parallel_gcn_tpu_torch.ops import cuda_dropout as cd

    gen = torch.Generator().manual_seed(11)
    seed, rate = 0x0DDB_A11C_0FFE, 0.1
    slot = _slot(seed)
    E, H = 2_500_003, 2  # [E, heads] attention weights, as a chunk slices them
    for dtype in (torch.bfloat16, torch.float32):
        x = torch.randn((E, H), generator=gen).to(dtype).cuda()
        whole = cd.dropout(x, slot, rate)
        for start in (4, 1_048_576, 1_048_576 * 2 - 4, E - 7):
            o = start * H
            want = whole[start:]
            for part in (x[start:], x[start:].clone()):
                got = cd.dropout(part, slot, rate, offset=o)
                assert torch.equal(got, want), f"K1 at offset {o} != the whole call's slice"
                assert torch.equal(got.cpu(), cd.dropout_plain(part.cpu(), seed, rate,
                                                                offset=o)), \
                    f"K1 at offset {o} != plain"
            xr = x[start:].clone().requires_grad_(True)
            cd.dropout(xr, slot, rate, offset=o).backward(torch.ones_like(xr))
            assert torch.equal(xr.grad, cd.dropout(torch.ones_like(x), slot, rate)[start:]), \
                f"K1 backward at offset {o}"
    try:
        cd.dropout(x[1:], slot, rate, offset=2)
        raise AssertionError("K1 took an offset that is not a multiple of 4")
    except ValueError:
        pass
    print(f"[kernels] K1 with an element offset ([{E}, {H}] bf16 and f32, chunks from edges 4, "
          f"1048576, 2097148 and {E - 7}): bit-equal to the slice of K1 without one and to "
          f"its plain version, through views and copies, backward included; an offset not "
          f"a multiple of 4 is refused")


# K1/K2 over seed lanes at the seed phases' shapes: ([rows, F], lanes, dtype,
# rate, the input's layout): synth-reddit's layer 1 entry (K2) at
# [main-seeds]' 4 lanes from the joined aggregation, the cora-sized input
# dropout (K1) at [seeds-stop]'s 8 lanes from the shared features, and a
# citeseer-wide one (3,703 f32 columns: no whole 16-byte vector a row) at 4
LANE_SHAPES = (((233472, 600), 4, "bfloat16", 0.1, "joined"),
               ((2708, 1433), 8, "float32", 0.4, "shared"),
               ((3327, 3703), 4, "float32", 0.5, "shared"))


def _lane_inputs(layout: str, x, lanes: int):
    """The laned kernel's input from the joined ``x`` [rows, S·F] (shared:
    its first lane, S times)."""
    if layout == "joined":
        return x
    parts = [p.contiguous() for p in x.chunk(lanes, dim=1)]
    return [parts[0]] * lanes if layout == "shared" else parts



def check_seed_lanes(results: dict) -> None:
    """``[seed-lanes]``: K1 and K2 over S seed lanes (``dropout_lanes_kernel``,
    one launch, lane s's seed at lane s's solo element index r·F + c), every
    input layout (joined, the lanes' own tensors, a shared input) to every
    output layout (the lanes' tensors: the split in the same launch; joined),
    bit-equal to their plain versions and, lane by lane, to the unlaned
    kernel on the lane's own [rows, F] (the solo run's mask); K2's backward
    over lanes (``dropout_lanes_bwd_kernel``) bit-equal to PyTorch's
    ``where(out > 0, g·(1/keep), 0)`` in each layout; the lanes of 41 columns
    and K1 at an element offset too. Times of the main paths' calls (K2:
    joined in, lanes out; K1: the shared input to the lanes; the backward:
    lanes in, joined out) beside the bound (each byte read and written once),
    the unlaned kernel over the same bytes, S unlaned launches with the
    parent's copy of the split, and ``F.dropout``."""
    import torch

    from parallel_gcn_tpu_torch.ops import cuda_dropout as cd

    gen = torch.Generator().manual_seed(5)
    base = 0x1234_5678_9ABC
    layouts = ("joined", "lanes", "shared")
    for (rows, width), lanes, dtype_name, rate, main_in in LANE_SHAPES:
        dtype = getattr(torch, dtype_name)
        seeds = [base + 7919 * s for s in range(lanes)]
        # the seeds as the trainer holds them: a device slot of one int64 a lane
        slot = torch.tensor(seeds, dtype=torch.int64, device="cuda")
        x = torch.randn(rows, lanes * width, generator=gen).to(dtype).cuda()
        inv = cd._inv_keep(rate, dtype)
        for relu in (False, True):
            key = "K2 lanes" if relu else "K1 lanes"
            wants = {}  # the plain version of each joined input (the lanes' is x's)
            for layout in layouts:
                xin = _lane_inputs(layout, x, lanes)
                joined_in = (torch.cat(xin, 1) if isinstance(xin, list) else xin)
                shared = layout == "shared"
                if shared not in wants:
                    wants[shared] = cd.lane_dropout_plain([joined_in], seeds, rate, int(relu),
                                                          0, lanes, True)
                    # lane by lane, the unlaned kernel on the lane's own columns
                    got = torch.cat(cd.lane_dropout(xin, slot, rate, relu=relu), 1)
                    for s in range(lanes):
                        solo = (cd.relu_dropout if relu else cd.dropout)(
                            joined_in[:, s * width:(s + 1) * width].contiguous(), slot[s], rate)
                        assert torch.equal(got[:, s * width:(s + 1) * width], solo), \
                            f"{key} {layout}: lane {s} != the unlaned kernel on its own columns"
                for join in (False, True):
                    got = cd.lane_dropout(xin, slot, rate, relu=relu, join=join)
                    got_j = got if join else torch.cat(got, 1)
                    assert torch.equal(got_j, wants[shared]), \
                        f"{key} {layout} -> {'joined' if join else 'lanes'} != plain at " \
                        f"[{rows}, {lanes}·{width}] {dtype_name}"
                if relu and layout != "shared":
                    # the backward: the cotangent in the output's layout, the
                    # gradient in the input's
                    out = cd.lane_dropout(xin, slot, rate, relu=True)
                    g = [torch.randn(rows, width, generator=gen).to(dtype).cuda()
                         for _ in range(lanes)]
                    dx = cd._run_lanes(g, None, rate, 2, 0, lanes, layout == "joined",
                                       aux=list(out))
                    ref = [torch.where(o > 0, gs * inv, 0.0) for o, gs in zip(out, g)]
                    dx_j = dx if layout == "joined" else torch.cat(dx, 1)
                    assert torch.equal(dx_j, torch.cat(ref, 1)), \
                        f"K2 lanes backward ({layout}) != torch.where(out > 0, g * inv, 0)"
        # the main path's calls, timed
        xin = _lane_inputs(main_in, x, lanes)
        relu = main_in == "joined"
        key = "K2 lanes" if relu else "K1 lanes"
        fn = lambda: cd.lane_dropout(xin, slot, rate, relu=relu)  # noqa: E731
        ms = timer.events_ms(fn, 20)
        dev = profiling.kernel_ms(fn, 20, "dropout_lanes_kernel")
        joined_in = torch.cat(xin, 1) if isinstance(xin, list) else xin
        pms = timer.events_ms(lambda: cd.lane_dropout_plain(
            [joined_in], seeds, rate, int(relu), 0, lanes, False), 3)
        # the unlaned kernel over the same bytes (one seed for the tensor), and
        # the parent's path: the laned mask joined, then the lanes' copies
        one = (cd.relu_dropout if relu else cd.dropout)
        one_ms = timer.events_ms(lambda: one(joined_in, base, rate), 20)
        unlaned = [joined_in[:, s * width:(s + 1) * width].contiguous() for s in range(lanes)]
        each_ms = timer.events_ms(lambda: [one(u, slot[s], rate) for s, u in enumerate(unlaned)],
                                  20)
        lib_ms = timer.events_ms(lambda: torch.nn.functional.dropout(joined_in, rate), 20)
        in_bytes = _nbytes(xin) if not isinstance(xin, list) else (
            _nbytes(xin[0]) if main_in == "shared" else _nbytes(*xin))
        bound = _bound(in_bytes + _nbytes(joined_in))
        print(f"[seed-lanes] {key} [{rows}, {lanes}·{width}] {dtype_name} rate {rate}, every "
              f"layout in ({', '.join(layouts)}) and out (lanes, joined): bit-equal to plain and "
              f"lane by lane to the unlaned kernel; the main path's call ({main_in} in, the lanes "
              f"out) {ms:.4f} ms (device {dev:.4f}), unlaned kernel at the same bytes "
              f"{one_ms:.4f} ms, {lanes} unlaned launches {each_ms:.4f} ms, plain {pms:.4f} ms, "
              f"bound {bound['bound_ms']:.4f} ms ({bound['bound_by']}), "
              f"torch.nn.functional.dropout {lib_ms:.4f} ms")
        if (rows, width) != (3327, 3703):
            results[key] = dict(err=0.0, ms=ms, plain_ms=pms, library_ms=lib_ms,
                                unlaned_ms=one_ms, **bound)
        if relu:  # the backward: lanes in (cotangents, saved outputs), joined out
            out = list(cd.lane_dropout(xin, slot, rate, relu=True))
            g = [torch.randn(rows, width, generator=gen).to(dtype).cuda() for _ in range(lanes)]
            bwd = lambda: cd._run_lanes(g, None, rate, 2, 0, lanes, True, aux=out)  # noqa: E731
            bms = timer.events_ms(bwd, 20)
            bdev = profiling.kernel_ms(bwd, 20, "dropout_lanes_bwd_kernel")
            torch_ms = timer.events_ms(lambda: torch.cat(
                [torch.where(o > 0, gs * inv, 0.0) for o, gs in zip(out, g)], 1), 20)
            bbound = _bound(3 * _nbytes(joined_in))
            print(f"[seed-lanes] K2 lanes backward [{rows}, {lanes}·{width}] {dtype_name}: "
                  f"{bms:.4f} ms (device {bdev:.4f}), PyTorch's where and cat {torch_ms:.4f} ms, "
                  f"bound {bbound['bound_ms']:.4f} ms ({bbound['bound_by']})")
            results["K2 lanes bwd"] = dict(err=0.0, ms=bms, plain_ms=torch_ms, library_ms=None,
                                           **bbound)
            del out, g
        del x, xin, joined_in, unlaned
    # the lanes of 41 columns (no whole 16-byte vector a row), bf16 and f32,
    # K1 at an element offset; 70 lanes (64 a launch, then the rest)
    for (rows, width), lanes in (((1001, 41), 3), ((257, 41), 70)):
        seeds = [base + s for s in range(lanes)]
        slot = torch.tensor(seeds, dtype=torch.int64, device="cuda")
        for dtype in (torch.bfloat16, torch.float32):
            x = torch.randn(rows, lanes * width, generator=gen).to(dtype).cuda()
            for relu, offset in ((False, 0), (True, 0), (False, 8)):
                want = cd.lane_dropout_plain([x], seeds, 0.3, int(relu), offset, lanes, True)
                for join in (True, False):
                    got = cd.lane_dropout(x, slot, 0.3, relu=relu, join=join, offset=offset)
                    assert torch.equal(got if join else torch.cat(got, 1), want), \
                        f"{lanes} lanes of {width} columns != plain ({dtype}, relu={relu}, " \
                        f"offset {offset}, join={join})"
    print("[seed-lanes] K1, K2 over 3 lanes of [1001, 41] (vectors across row ends) and 70 "
          "lanes of [257, 41] (two launches), joined and split, bit-equal to plain in bf16 and "
          "f32, K1 at element offset 8 too")
    check_fused_lanes(results)


# the laned K10 at the seed phases' shapes: ([n, k, m], lanes, dtype, rate,
# shared x): synth-reddit's fused layer 1 at [seeds-fused]' 4 lanes, and the
# cora-sized graph's layer 0 (the shared input, no dX) and layer 1 at
# [seeds-stop-fused]' 8 lanes (parameters_cora.txt: 1433 -> 72 -> 7, dropouts
# 0.4 / 0.2); 1,433 f32 columns put every lane but the first off 16 bytes
FUSED_LANE_SHAPES = (((233472, 600, 41), 4, "bfloat16", 0.1, False),
                     ((2708, 1433, 72), 8, "float32", 0.4, True),
                     ((2708, 72, 7), 8, "float32", 0.2, False))
FUSED_LANE_KERNELS = {"K10 fwd lanes": ("fwd_mma_lanes_kernel", "fwd_fma_lanes_kernel",
                                        "fwd_fma_shared_kernel"),
                      "K10 dW lanes": ("dw_mma_lanes_kernel", "dw_fma_lanes_kernel",
                                       "reduce_splits_lanes_kernel"),
                      "K10 dX lanes": ("dx_mma_lanes_kernel", "dx_lanes_kernel<",
                                       "dx_wfrag_kernel")}


def check_fused_lanes(results: dict) -> None:
    """``[seed-lanes]``: K10's forward, dW and dX over S seed lanes (one
    launch each, ``cuda_fused.dropout_matmul_lanes``) at FUSED_LANE_SHAPES,
    the seeds in a device slot: lane by lane bit-equal to the unlaned K10 on
    the lane's own operands (its columns of a joined x, or the shared x; its
    W and seed), within ``check_fused``'s tolerances of the laned plain
    version (f32 outputs rtol 1e-4, bf16 one bf16 ulp, + 1e-5·max|ref|), two
    runs bit-identical; times (CUDA events and device time) beside the byte
    bound and beside S unlaned launches on the lanes' operands."""
    import torch

    from parallel_gcn_tpu_torch.ops import cuda_fused as cf

    gen = torch.Generator().manual_seed(9)
    base = 0x2468_ACE0_1357
    for (n, k, m), lanes, dtype_name, rate, shared in FUSED_LANE_SHAPES:
        dtype = getattr(torch, dtype_name)
        seeds = [base + 7919 * s for s in range(lanes)]
        slot = torch.tensor(seeds, dtype=torch.int64, device="cuda")
        x = torch.randn(n, k if shared else lanes * k, generator=gen).to(dtype).cuda()
        r = (6.0 / (k + m)) ** 0.5  # Glorot range, as the layers' weights
        w = ((torch.rand((lanes, k, m), generator=gen) * 2 - 1) * r).to(dtype).cuda()
        g = (torch.randn((n, lanes * m), generator=gen) / n).cuda()
        xs = [x if shared else x[:, s * k:(s + 1) * k].contiguous() for s in range(lanes)]
        gs = [g[:, s * m:(s + 1) * m].contiguous() for s in range(lanes)]
        rtol_out = 2.0**-7 if dtype == torch.bfloat16 else 1e-4
        calls = {
            "K10 fwd lanes": (lambda: cf._fwd_lanes(x, w, slot, rate),
                              lambda: cf.dropout_matmul_lanes_plain(x, w, seeds, rate),
                              lambda s: cf._fwd(xs[s], w[s], slot[s], rate),
                              lambda t, s: t[:, s * m:(s + 1) * m], 1e-4, (x, w)),
            "K10 dW lanes": (lambda: cf._dw_lanes(x, g, slot, rate, dtype, shared),
                             lambda: cf.dropout_matmul_lanes_dw_plain(x, g, seeds, rate, dtype,
                                                                      shared),
                             lambda s: cf._dw(xs[s], gs[s], slot[s], rate, dtype),
                             lambda t, s: t[s], rtol_out, (x, g)),
        }
        if not shared:
            calls["K10 dX lanes"] = (lambda: cf._dx_lanes(g, w, slot, rate, dtype),
                                     lambda: cf.dropout_matmul_lanes_dx_plain(g, w, seeds, rate,
                                                                              dtype),
                                     lambda s: cf._dx(gs[s], w[s], slot[s], rate, dtype),
                                     lambda t, s: t[:, s * k:(s + 1) * k], rtol_out, (g, w))
        flops = 2 * n * k * m * lanes
        kind = "bf16" if dtype == torch.bfloat16 else "f32"
        for key, (kernel, plain, solo, lane_of, rtol, ins) in calls.items():
            got, again = kernel(), kernel()
            assert torch.equal(got, again), f"{key}: two runs differ"
            for s in range(lanes):
                assert torch.equal(lane_of(got, s), solo(s)), \
                    f"{key} [{n}, {lanes}·{k}] x [{k}, {m}] {dtype_name}: lane {s} != the " \
                    f"unlaned K10 on its own operands"
            err = _max_err(got, plain(), rtol)
            ms = timer.events_ms(kernel, 20)
            dev = profiling.kernel_ms(kernel, 20, *FUSED_LANE_KERNELS[key])
            pms = timer.events_ms(plain, 2)
            unlaned_ms = timer.events_ms(lambda: [solo(s) for s in range(lanes)], 20)
            # dX's f32 product runs as three bf16 passes (g split into exact terms)
            bound = _bound(_nbytes(*ins, got),
                           3 * flops if key == "K10 dX lanes" and kind == "bf16" else flops, kind)
            print(f"[seed-lanes] {key} [{n}, {lanes}·{k}{' shared' if shared else ''}] x "
                  f"[{lanes}, {k}, {m}] {dtype_name} rate {rate}: bit-equal lane by lane to the "
                  f"unlaned K10, max_abs_err {err:.3e} against plain (rtol {rtol:.3g}), runs "
                  f"bit-identical; kernel {ms:.4f} ms (device {dev:.4f}), {lanes} unlaned "
                  f"launches {unlaned_ms:.4f} ms, plain {pms:.4f} ms, bound "
                  f"{bound['bound_ms']:.4f} ms ({bound['bound_by']})")
            if key not in results or dtype == torch.bfloat16:
                results[key] = dict(err=err, ms=ms, plain_ms=pms, unlaned_ms=unlaned_ms,
                                    library_ms=None, **bound)
            results[key]["err"] = max(results[key]["err"], err)
        del x, w, g, xs, gs
    torch.cuda.empty_cache()


def _check_stacked(tag: str, spmm, a, b, bound: dict | None = None) -> None:
    """The deferred-eval schedule's call: ``spmm`` of ``[a | b]`` at twice
    the width against two calls at the width of one. Prints whether each
    column's sums are bitwise those of the narrow call, else the largest
    difference, and the times, with the wide call's ``bound`` when given."""
    import torch

    c = a.shape[1]
    both = spmm(torch.cat([a, b], dim=1))
    one = (spmm(a), spmm(b))
    same = torch.equal(both[:, :c], one[0]) and torch.equal(both[:, c:], one[1])
    diff = max(float((both[:, :c] - one[0]).abs().max()), float((both[:, c:] - one[1]).abs().max()))
    wide = timer.events_ms(lambda: spmm(torch.cat([a, b], dim=1)), 10)
    narrow = timer.events_ms(lambda: spmm(a), 10)
    print(f"[kernels] {tag} stacked F={2 * c} (the deferred eval's train | val halves): "
          f"columns bitwise those of two F={c} calls: {same} (max difference {diff:.3e}); "
          f"{wide:.4f} ms with the concatenation, against 2 x {narrow:.4f} ms"
          + (f"; bound of the wide call {bound['bound_ms']:.4f} ms ({bound['bound_by']})"
             if bound else ""))


def check_bcsr(results: dict, bcsr_pack, x602, gin602) -> None:
    """K4 and K3 against their plain versions at 41, 600 and 602 columns:
    ``x602`` the features in f32, ``gin602`` GIN's layer-0 input (the
    bf16 features scaled by sqrt_deg, what its sum aggregation passes)."""
    import dataclasses

    import torch

    from parallel_gcn_tpu_torch.ops import cuda_bcsr as cb

    gen = torch.Generator().manual_seed(2)
    n = bcsr_pack.n_nodes
    pack_nnz = int(bcsr_pack.live_entries[0].numel())
    x41 = torch.randn((n, 41), generator=gen).to(torch.bfloat16).cuda()
    g41 = torch.randn((n, 41), generator=gen).cuda()
    x600 = torch.randn((n, 600), generator=gen).to(torch.bfloat16).cuda()
    x41f = torch.randn((n, 41), generator=gen).cuda()  # an f32 hybrid run's per-epoch width
    # the deferred schedule's stacked forward of an f32 run ([main-gcn-f32])
    x82f = torch.cat([x41f, g41], dim=1)
    # K3: the same tiles as a plain pattern pack (no d scaling)
    pattern = dataclasses.replace(bcsr_pack, sym_scale=None)
    for key, pack in (("K4", bcsr_pack), ("K3", pattern)):
        errs = []
        csr = _pack_csr(pack)  # the library calls' CSR of the same matrix
        t0 = time.perf_counter()
        idx = pack.spmm_index
        torch.cuda.synchronize()
        print(f"[kernels] {key} the f32 body's live-entry index: {idx.ent.shape[0]} entries, "
              f"{idx.rptr.numel()} row offsets, {_nbytes(idx.ent, idx.rptr)} bytes, built on "
              f"the card in {time.perf_counter() - t0:.4f} s")
        for x, rtol in ((x41, 2e-3), (x600, 2e-3), (x41f, 1e-4), (x82f, 1e-4), (x602, 1e-4),
                        (gin602, 2e-3)):
            got = cb.bcsr_matmul_impl(pack, x)
            assert torch.equal(got, cb.bcsr_matmul_impl(pack, x)), f"{key}: two runs differ"
            ref = cb.bcsr_matmul_plain(pack, x)
            errs.append(_max_err(got, ref, rtol))
            ms = timer.events_ms(lambda: cb.bcsr_matmul_impl(pack, x), 10)
            pms = timer.events_ms(lambda: cb.bcsr_matmul_plain(pack, x), 2)
            bound = _spmm_bound(pack, x, got)
            body = (_f32_body(pack) if x.dtype == torch.float32 else
                    f"{cb.spmm_body(pack.tiles.dtype, pack.sym_scale is not None, x.shape[1])} "
                    "bf16 body")
            print(f"[kernels] {key} bcsr fwd F={x.shape[1]} {x.dtype}, {body}: max_abs_err "
                  f"{errs[-1]:.3e} (rtol {rtol}), runs bit-identical; kernel {ms:.4f} ms, "
                  f"plain {pms:.4f} ms, bound {bound['bound_ms']:.4f} ms ({bound['bound_by']})")
            if body.startswith("wide"):
                # K4's wide body: SAGE's 600 columns the JSON line's numbers,
                # GIN's 602 under its width
                r = dict(ms=ms, plain_ms=pms, err=errs[-1], **bound)
                rec = results.setdefault("K4 wide", {})
                if x is x600:
                    rec.update(r)
                else:
                    rec[f"F={x.shape[1]}"] = r
            if x.dtype == torch.float32:
                # the library call at the same width on the same f32 x
                lib_ms = timer.events_ms(lambda: torch.sparse.mm(csr, x), 10)
                print(f"[kernels] {key} library torch.sparse.mm (CSR f32, f32 x) "
                      f"F={x.shape[1]}: {lib_ms:.4f} ms")
                r = dict(ms=ms, plain_ms=pms, library_ms=lib_ms, err=errs[-1], **bound)
                rec = results.setdefault(f"{key} f32", {})
                if x is x602:  # the set-up pre-aggregation's width: the JSON line's numbers
                    rec.update(r)
                else:
                    rec[f"F={x.shape[1]}"] = r
            if x is x600:
                # the library call at the wide width: cuSPARSE on f32 x
                x32 = x.float()
                lib_ms = timer.events_ms(lambda: torch.sparse.mm(csr, x32), 10)
                print(f"[kernels] {key} library torch.sparse.mm (CSR f32) F=600: "
                      f"{lib_ms:.4f} ms")
                if key == "K4":
                    results["K4 wide"]["library_ms"] = lib_ms
                del x32
            if x is x41:
                out_bytes = x.shape[0] * x.shape[1] * 4
                flops = 2 * pack_nnz * x.shape[1]  # the live entries' products
                results[key] = dict(ms=ms, plain_ms=pms, **_bound(
                    _pack_bytes(pack) + _nbytes(x) + out_bytes, flops))
                # the one PyTorch call that computes A·x: cuSPARSE SpMM on a
                # CSR of the same matrix (f32 values and x; the port never
                # calls it)
                x32 = x.float()
                lib = torch.sparse.mm(csr, x32)
                rel = float(((lib - got).abs().max() / got.abs().max()))
                results[key]["library_ms"] = timer.events_ms(lambda: torch.sparse.mm(csr, x32), 10)
                print(f"[kernels] {key} library torch.sparse.mm (CSR f32, "
                      f"{csr.values().numel()} nnz) F={x.shape[1]}: "
                      f"{results[key]['library_ms']:.4f} ms, max diff to the kernel "
                      f"{rel:.3e} of max|out| (the kernel rounds the scaled tile to bf16)")
                del lib, x32
        # backward through autograd: the same kernel on the cotangent
        for x, g in ((x41.float(), g41), (x602, torch.randn(x602.shape, generator=gen).cuda())):
            grads = []
            for _ in range(2):
                xr = x.clone().requires_grad_(True)
                cb.bcsr_matmul(pack, xr).backward(g)
                grads.append(xr.grad)
            assert torch.equal(*grads), f"{key} backward: two runs differ"
            errs.append(_max_err(xr.grad, cb.bcsr_matmul_plain(pack, g), 1e-4))
            print(f"[kernels] {key} bcsr bwd F={x.shape[1]} {x.dtype}: max_abs_err "
                  f"{errs[-1]:.3e} (rtol 1e-4), runs bit-identical")
        # negative int8 entries take the kernel's general (signed) conversion
        signed = dataclasses.replace(pack, tiles=pack.tiles.neg())
        assert not signed.nonneg_tiles
        got = cb.bcsr_matmul_impl(signed, x41)
        assert torch.equal(got, cb.bcsr_matmul_impl(signed, x41)), f"{key} signed: runs differ"
        errs.append(_max_err(got, cb.bcsr_matmul_plain(signed, x41), 2e-3))
        print(f"[kernels] {key} bcsr fwd F=41 bf16 on the negated pack (signed bytes): "
              f"max_abs_err {errs[-1]:.3e} (rtol 2e-3), runs bit-identical")
        del signed, got
        results[key]["err"] = max(errs)
        rec = results[f"{key} f32"]
        rec["err"] = max(rec["err"], rec["F=41"]["err"], rec["F=82"]["err"])
        if key == "K4":
            # the wide call's bound: the pack, x [n, 82] bf16 in, [n, 82] f32 out
            x41b = torch.randn((n, 41), generator=gen).to(torch.bfloat16).cuda()
            _check_stacked("K4", lambda x: cb.bcsr_matmul_impl(pack, x), x41, x41b,
                           _bound(_pack_bytes(pack) + n * 82 * (2 + 4), 2 * pack_nnz * 82))
            x82 = torch.cat([x41, x41b], dim=1).float()
            lib_ms = timer.events_ms(lambda: torch.sparse.mm(csr, x82), 10)
            results["K4"]["stacked_library_ms"] = lib_ms
            print(f"[kernels] K4 library torch.sparse.mm (CSR f32) at the stacked F=82: "
                  f"{lib_ms:.4f} ms")
            del x41b, x82
        del csr


def _segment_case(results: dict, key: str, label: str, fn, ref, plain, library,
                  nbytes: int, flops: float, kind: str, parent=None,
                  per_item_bound_ms: float | None = None) -> dict:
    """One ordered-sum shape: ``fn()`` (the kernel) twice bit-identical and
    bit-equal to ``ref`` (its plain version on the CPU in the kernel's
    dtype, f32 or bf16: float32 sums in item order, one rounding, the
    kernel's order and accumulation; or a callable that holds the output to
    it on the rows it covers), within rtol 1e-5 + 1e-5·max|ref| of it;
    beside it ``plain()`` (the plain version on the card: ``index_add_``'s
    atomics), ``library()`` (the one PyTorch call for the same sum) and,
    with ``parent``, the parent tree's kernel on the same inputs (bit-equal
    to this one), timed by CUDA events, and the kernels' device time
    (``torch.profiler``; a call's hub and walk kernels overlap: their sum);
    the bound from ``nbytes`` and ``flops``. Returns the shape's numbers."""
    import torch

    got = fn()
    assert torch.equal(got, fn()), f"{label}: two runs differ"
    if callable(ref):
        err = ref(got)
    else:
        got_cpu = got.cpu()
        assert torch.equal(got_cpu, ref.to(got.dtype)), f"{label}: not bit-equal to the CPU order"
        err = _max_err(got_cpu, ref.to(got.dtype), 1e-5)
    card = plain()
    card_diff = float((card.float() - got.float()).abs().max())
    del card
    ms = timer.events_ms(fn, 20)
    plain_ms = timer.events_ms(plain, 20)
    library_ms = timer.events_ms(library, 20)
    bound = _bound(nbytes, flops, kind)
    row = dict(err=err, ms=ms, plain_ms=plain_ms, library_ms=library_ms, **bound)
    row["device_ms"] = device = profiling.kernel_ms(fn, 10, "pgcn_seg::")
    extra = f", device {device:.4f} ms"
    if per_item_bound_ms is not None:
        extra += f", bound counting a gathered row an item {per_item_bound_ms:.4f} ms"
    before = ""
    if parent is not None:
        assert torch.equal(parent(), got), f"{label}: the parent's kernel gives other bits"
        row["parent_ms"] = timer.events_ms(parent, 20)
        before = f", the parent's kernel {row['parent_ms']:.4f} ms (bit-equal)"
    print(f"[kernels] ordered sum {label}: bit-equal to the plain version on the CPU (max_abs_err "
          f"{err:.3e}), runs bit-identical; the plain version on the card (index_add_) differs "
          f"by {card_diff:.3e}; kernel {ms:.4f} ms{before}, plain {plain_ms:.4f} ms, library "
          f"{library_ms:.4f} ms, bound {bound['bound_ms']:.4f} ms ({bound['bound_by']}){extra}",
          flush=True)
    if key:
        results[key] = row
    return row


def parent_segment_sums(parent: str | None):
    """The parent tree's ordered sums, to time them beside this tree's on
    the same inputs: its ``csrc/segment_sum.cu`` built alone by nvcc into
    ``.smoke/`` and called through its C interface (PRs 10-13's: CSR
    offsets, permutation, live list in segment order (this tree's work
    list's live entries, sorted once a ``Segments``), int64 src and f32
    val; (a)'s output zeroed first, as its wrapper did). Returns
    (gather_sum(x, seg, src, val), segment_sum_(out, seg, values)) over this
    tree's ``Segments``, or None without a parent tree."""
    if not parent:
        return None
    import ctypes

    import torch

    from parallel_gcn_tpu_torch.ops import _build

    repo = os.path.dirname(os.path.abspath(__file__))
    src = os.path.join(parent, "parallel_gcn_tpu_torch", "csrc", "segment_sum.cu")
    os.makedirs(os.path.join(repo, ".smoke"), exist_ok=True)
    path = os.path.join(repo, ".smoke", "parent_segment_sum.so")
    t0 = time.perf_counter()
    _build._run_nvcc([src], path)
    lib = ctypes.CDLL(path)
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.pgcn_gather_sum.argtypes = [p, p, p, i32, p, p, p, i32, p, i32, p]
    lib.pgcn_segment_sum.argtypes = [p, p, p, i32, p, i32, p, i64, i32, p]
    print(f"[kernels] the parent's ordered sums ({src}) built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    code = {torch.float32: 0, torch.bfloat16: 1}

    lives = {}

    def head(seg):
        if id(seg) not in lives:
            lives[id(seg)] = (seg, torch.sort(seg.work[:seg.n_live, 0]).values.contiguous())
        live = lives[id(seg)][1]
        return [seg.ptr.data_ptr(), None if seg.perm is None else seg.perm.data_ptr(),
                live.data_ptr(), live.numel()]

    def stream():
        return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)

    def gather_sum(x, seg, src, val):
        out = torch.zeros((seg.n, x.shape[1]), dtype=x.dtype, device=x.device)
        rc = lib.pgcn_gather_sum(*head(seg), src.data_ptr(), val.data_ptr(), x.data_ptr(),
                                 code[x.dtype], out.data_ptr(), x.shape[1], stream())
        _build.check(rc, "the parent's gather-sum")
        return out

    def segment_sum_(out, seg, values):
        rc = lib.pgcn_segment_sum(*head(seg), values.data_ptr(), code[out.dtype],
                                  out.data_ptr(), out.stride(0), out[0].numel(), stream())
        _build.check(rc, "the parent's segment sum")
        return out

    return gather_sum, segment_sum_


def check_segment_gather(results: dict, key: str, label: str, x, seg, parent=None, ref=None,
                         plain_chunks: int = 1) -> dict:
    """Kernel (a) ``gather_sum`` over ``seg`` (built with its src and val)
    against its plain version (``ref``: on the CPU over every row when
    None, in ``plain_chunks`` item chunks); library call:
    ``torch.sparse.mm`` of the same rows as a CSR (f32 values and x);
    ``parent``: the parent tree's sums (``parent_segment_sums``)."""
    import torch

    from parallel_gcn_tpu_torch.ops import cuda_segment as cs

    n, F, src, val = seg.n, x.shape[1], seg.src, seg.val
    if ref is None:
        ref = cs.gather_sum_plain(x.cpu(), seg.index.cpu(), src.cpu(), val.cpu(), n,
                                  plain_chunks)
    order = seg.perm.long() if seg.perm is not None else slice(None)
    csr = torch.sparse_csr_tensor(seg.ptr.long(), src[order], val[order].float(),
                                  size=(n, x.shape[0]))
    x32 = x.float()
    # each input read once: the index (the packed items, 8 bytes an item,
    # and the offsets), the rows of x that it gathers (each once), out
    # written once; beside it the bound that counts a gathered row for
    # every item
    index_bytes = _nbytes(seg.items, seg.ptr)
    row = F * x.element_size()
    nbytes = index_bytes + int(torch.unique(src).numel()) * row + n * row
    per_item = _bound(index_bytes + seg.index.numel() * row + n * row)["bound_ms"]
    return _segment_case(
        results, key, f"(a) gather_sum {label} [E={seg.index.numel()}, {F}] {x.dtype}",
        lambda: cs.gather_sum(x, seg), ref,
        lambda: cs.gather_sum_plain(x, seg.index, src, val, n, plain_chunks),
        lambda: torch.sparse.mm(csr, x32), nbytes, 2.0 * seg.index.numel() * F, "f32",
        parent=parent and (lambda: parent[0](x, seg, src, val)), per_item_bound_ms=per_item)


def check_segment_sum(results: dict, key: str, label: str, values, seg, parent=None,
                      ref=None) -> dict:
    """Kernel (b) ``segment_sum_`` into zeros against its plain version
    (``ref``: on the CPU over every row when None); library call:
    ``torch.segment_reduce`` over the same offsets (the items taken in
    segment order beforehand where the index is not sorted); ``parent``: the
    parent tree's sums."""
    import torch

    from parallel_gcn_tpu_torch.ops import cuda_segment as cs

    n, shape = seg.n, values.shape[1:]
    if ref is None:
        ref = cs.segment_sum_(torch.zeros((n, *shape), dtype=values.dtype), seg.index.cpu(),
                              values.cpu())
    ordered = values if seg.perm is None else values.index_select(0, seg.perm.long())
    offsets = seg.ptr.long()
    # the rows of the segments with items are read and written
    nbytes = (_nbytes(seg.ptr, values, *([seg.perm] if seg.perm is not None else []))
              + 2 * seg.n_live * values[0].numel() * values.element_size())
    return _segment_case(
        results, key, f"(b) segment_sum {label} [E={values.shape[0]}, "
        f"{', '.join(map(str, shape))}] {values.dtype}",
        lambda: cs.segment_sum_(values.new_zeros((n, *shape)), seg, values), ref,
        lambda: values.new_zeros((n, *shape)).index_add_(0, seg.index, values),
        lambda: torch.segment_reduce(ordered, "sum", offsets=offsets, axis=0),
        nbytes, float(values.numel()), "f32",
        parent=parent and (lambda: parent[1](values.new_zeros((n, *shape)), seg, values)))


def check_segment(results: dict, graph, gin602, parent=None) -> None:
    """The ordered sums at synth-reddit's residual shapes: the GCN's
    hybrid residual at 41 columns and stacked at 82 (bf16, kernel (a), and
    at 41 in f32), SAGE's layer 0 and GIN's layer 1 at 600 columns and GIN's
    layer 0 at 602 (``gin602``, its input) in bf16, the GAT's per-edge
    denominators [E, 2] and numerators
    [E, 2, 41] (f32, kernel (b), and the numerators in bf16), all by
    destination over the graph's row segments; each bit-equal to its plain
    version in its own dtype, and to the parent tree's kernel (``parent``,
    ``parent_segment_sums``) where given."""
    import torch

    gen = torch.Generator().manual_seed(3)
    n, seg = graph.n_nodes, graph.row_seg
    e = seg.index.numel()
    print(f"[kernels] synth-reddit's COO residual: {e} padded edges over {n} rows, "
          f"{seg.n_live} rows with edges, at most "
          f"{int((seg.ptr[1:] - seg.ptr[:-1]).max())} in a row")
    for F, key, dtype in ((41, "ordered gather_sum", torch.bfloat16), (82, None, torch.bfloat16),
                          (41, None, torch.float32)):
        x = torch.randn((n, F), generator=gen).to(dtype).cuda()
        check_segment_gather(results, key, "GCN residual", x, seg, parent)
    x = torch.randn((n, 600), generator=gen).to(torch.bfloat16).cuda()
    check_segment_gather(results, None, "SAGE/GIN residual", x, seg, parent)
    del x
    check_segment_gather(results, None, "GIN layer-0 input", gin602, seg, parent)
    for shape, key, dtype in (((e, 2), None, torch.float32),
                              ((e, 2, 41), "ordered segment_sum", torch.float32),
                              ((e, 2, 41), None, torch.bfloat16)):
        values = torch.randn(shape, generator=gen).to(dtype).cuda()
        check_segment_sum(results, key, "GAT residual", values, seg, parent)


def check_segment_flat(ds, cfg, parent=None) -> None:
    """The ordered sums over the single card's flat COO (``backend=segment``:
    all of synth-reddit's Â, ``graph.row_seg``, the rows of the ring and
    flat halos at one rank): (a) at 41, 82 and 600 bf16 and (b) at [E, 2]
    and [E, 2, 41] f32, each twice bit-identical, (a) at 41 bit-equal to its
    plain version on the CPU over every row (in 16 item chunks), the others
    over the hub rows (more than 1,000 items) and 1,000 rows drawn with a
    seed; beside each the parent tree's kernel (bit-equal), ``index_add_``
    and the library call; the row-length histogram; and (a) over the hub
    rows alone, which shows whether their chains set the time."""
    import numpy as np
    import torch

    from parallel_gcn_tpu_torch.data.graph import build_graph
    from parallel_gcn_tpu_torch.ops import cuda_segment as cs

    t0 = time.perf_counter()
    graph = build_graph(ds.graph, device=torch.device("cuda"), node_pad=cfg.tpu.node_pad)
    seg, n, e = graph.row_seg, graph.n_nodes, graph.n_edges_pad
    lengths = np.diff(seg.ptr.cpu().numpy())
    real = np.diff(ds.graph.indptr)
    hubs = np.flatnonzero(real > 1000)
    print(f"[kernels] synth-reddit's flat COO (backend=segment) built in "
          f"{time.perf_counter() - t0:.1f} s: {e} padded entries over {n} rows "
          f"({e - ds.graph.nnz} padding entries on the last); entries a row: mean "
          f"{real.mean():.1f}, p99 {np.percentile(real, 99):.0f}, p99.9 "
          f"{np.percentile(real, 99.9):.0f}, max {real.max()}; {len(hubs)} rows above 1,000 "
          f"holding {int(real[hubs].sum())}", flush=True)
    rng = np.random.default_rng(14)
    rows = np.union1d(hubs, rng.choice(np.flatnonzero(lengths > 0), 1000, replace=False))
    ptr = seg.ptr.cpu().numpy()
    items = torch.from_numpy(np.concatenate([np.arange(ptr[r], ptr[r + 1]) for r in rows])).cuda()
    sub_index = torch.from_numpy(np.repeat(np.arange(len(rows)), lengths[rows]))
    rows_t = torch.from_numpy(rows).cuda()

    def on_rows(want):
        """Hold an output to ``want`` on the sampled rows, bit for bit."""
        def check(got):
            sub = got[rows_t].cpu()
            assert torch.equal(sub, want), "not bit-equal to the CPU order on the sampled rows"
            return _max_err(sub, want, 1e-5)
        return check

    gen = torch.Generator(device="cuda").manual_seed(5)
    src_s, val_s = graph.col[items].cpu(), graph.val[items].cpu()
    for F in (41, 82, 600):
        x = torch.randn((n, F), generator=gen, device="cuda").to(torch.bfloat16)
        ref = None if F == 41 else on_rows(
            cs.gather_sum_plain(x.cpu(), sub_index, src_s, val_s, len(rows)))
        check_segment_gather({}, None, "flat COO (all of A)", x, seg, parent, ref,
                             plain_chunks=16)
        del x
    for shape in ((e, 2), (e, 2, 41)):
        values = torch.randn(shape, generator=gen, device="cuda")
        want = torch.zeros((len(rows), *shape[1:])).index_add_(0, sub_index,
                                                                values[items].cpu())
        check_segment_sum({}, None, "flat COO (all of A)", values, seg, parent, on_rows(want))
        del values
    # the hub rows alone: their items as a residual of their own
    hub_items = torch.cat([torch.arange(int(ptr[r]), int(ptr[r + 1])) for r in hubs]).cuda()
    hub_seg = cs.segments(graph.row[hub_items], n, graph.col[hub_items], graph.val[hub_items])
    for F in (41, 600):
        x = torch.randn((n, F), generator=gen, device="cuda").to(torch.bfloat16)
        ms = timer.events_ms(lambda: cs.gather_sum(x, hub_seg), 20)
        print(f"[kernels] (a) over the {len(hubs)} hub rows alone ({hub_items.numel()} entries, "
              f"at most {int(real.max())} a row) F={F} bf16: {ms:.4f} ms", flush=True)
        del x
    del graph, seg, hub_seg
    torch.cuda.empty_cache()


def check_segment_slab(gcn, attn) -> None:
    """The ordered sums over rank 0's slab: the mesh GCN's residual by
    local row (kernel (a), bf16 at 41 columns) and the mesh GAT's dt [E, 2]
    and dv [E, 2, 41] by source through the slab's source-sorted
    permutation (kernel (b))."""
    import torch

    gen = torch.Generator().manual_seed(4)
    res_seg = gcn.res
    x = torch.randn((gcn.n_buf, 41), generator=gen).to(torch.bfloat16).cuda()
    check_segment_gather({}, None, "mesh GCN slab residual", x, res_seg)
    if attn.residual is None:
        print("[mesh-kernels] the GAT slab has no residual: no ordered sum by source")
        return
    col_seg = attn.residual[4]
    for shape in ((col_seg.index.numel(), 2), (col_seg.index.numel(), 2, 41)):
        check_segment_sum({}, None, "mesh GAT slab residual by source (permuted)",
                          torch.randn(shape, generator=gen).cuda(), col_seg)


def _pack_csr(pack):
    """The pack's matrix as a torch sparse CSR (f32 values; the int8 pack's
    entries scaled by d_r·d_c)."""
    import torch

    rows, cols, vals = [], [], []
    step = max(64, (1 << 28) // (pack.tile_r * pack.tile_c))  # about 256 MB of int8 tiles
    for b0 in range(0, pack.n_tiles, step):
        blk = pack.tiles[b0 : b0 + step]
        t, r, c = (blk != 0).nonzero(as_tuple=True)
        v = blk[t, r, c].float()
        rows.append(pack.tile_rows[t + b0].long() * pack.tile_r + r)
        cols.append(pack.tile_cols[t + b0].long() * pack.tile_c + c)
        if pack.sym_scale is not None:
            v = v * pack.sym_scale[cols[-1]] * pack.sym_scale[rows[-1]]
        vals.append(v)
    idx = torch.stack([torch.cat(rows), torch.cat(cols)])
    return torch.sparse_coo_tensor(idx, torch.cat(vals), (pack.n_rows, pack.n_nodes)
                                   ).coalesce().to_sparse_csr()


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
                # the kernels read the seed from a slot, the plain versions take the int
                kw = dict(slope=0.2, rate=rate, seed=_slot(0x2468ACE, torch.int32))
                pkw = dict(kw, seed=0x2468ACE)
                fwd = ta.gat_fwd_tiles(pack, s, t, v, **kw)
                again = ta.gat_fwd_tiles(pack, s, t, v, **kw)
                assert all(map(torch.equal, fwd, again)), "K5: two runs differ"
                assert all(map(torch.equal, fwd, ta.gat_fwd_tiles(pack, s, t, v, **pkw))), \
                    "K5: slot != int seed"
                acc, m, den = ta.gat_fwd_tiles_plain(pack, s, t, v, **pkw)
                live = den > 0  # rows with edges; the others keep m = -1e9
                assert torch.equal(fwd[1][~live], m[~live]), "K5: m of empty rows"
                e5 = max(_max_err(fwd[0], acc, rtol), _max_err(fwd[2], den, rtol),
                         _max_err(fwd[1][live], m[live], 1e-6))
                rho = (g * acc / den.clamp(min=1e-16)[:, :, None]).sum(-1)
                bwd = ta.gat_bwd_tiles(pack, s, t, v, g, m, den, rho, **kw)
                again = ta.gat_bwd_tiles(pack, s, t, v, g, m, den, rho, **kw)
                assert all(map(torch.equal, bwd, again)), "K6: two runs differ"
                ref = ta.gat_bwd_tiles_plain(pack, s, t, v, g, m, den, rho, **pkw)
                e6 = max(_max_err(a, b, 1e-3, atol_frac=1e-4) for a, b in zip(bwd, ref))
                errs["K5"].append(e5)
                errs["K6"].append(e6)
                ms5 = timer.events_ms(lambda: ta.gat_fwd_tiles(pack, s, t, v, **kw), 10)
                pms5 = timer.events_ms(lambda: ta.gat_fwd_tiles_plain(pack, s, t, v, **pkw), 2)
                ms6 = timer.events_ms(
                    lambda: ta.gat_bwd_tiles(pack, s, t, v, g, m, den, rho, **kw), 10)
                pms6 = timer.events_ms(
                    lambda: ta.gat_bwd_tiles_plain(pack, s, t, v, g, m, den, rho, **pkw), 2)
                b5 = _attn_bounds(pack, _nbytes(s, t, v, *fwd), 1, H, D)
                b6 = _attn_bounds(pack, _nbytes(s, t, v, g, m, den, rho, *bwd), 3, H, D)
                for key, e, ms, pms, b, tol in (("K5 gat_fwd", e5, ms5, pms5, b5, rtol),
                                                ("K6 gat_bwd", e6, ms6, pms6, b6, 1e-3)):
                    print(f"[kernels] {key} H={H} D={D} {dtype} rate {rate}: max_abs_err "
                          f"{e:.3e} (rtol {tol}), runs bit-identical; kernel {ms:.4f} ms, "
                          f"plain {pms:.4f} ms, bound {b['bound_ms']:.4f} ms over the index "
                          f"({b['bound_by']}), {b['pack_bound_ms']:.4f} ms streaming the pack")
                if (D, dtype, rate) == (41, torch.bfloat16, 0.0):  # layer 1 of the main path
                    results["K5"] = dict(ms=ms5, plain_ms=pms5, **b5)
                    results["K6"] = dict(ms=ms6, plain_ms=pms6, **b6)
    for key in errs:
        results[key]["err"] = max(errs[key])


def check_ce(results: dict, dds) -> None:
    """K9 against its plain version at synth-reddit's [n, 41] f32 logits,
    with the train mask (train variant, as the train step) and the val mask
    (eval variant, as the val eval)."""
    import torch

    from parallel_gcn_tpu_torch.data.parser import TRAIN, VAL
    from parallel_gcn_tpu_torch.ops import cuda_ce as ce

    gen = torch.Generator().manual_seed(4)
    n = dds.labels.shape[0]
    logits = (3 * torch.randn((n, 41), generator=gen)).cuda()
    labels = dds.labels
    errs = []
    for split, key in ((TRAIN, "K9 train"), (VAL, "K9 eval")):
        mask = dds.split == split
        num = dds.split_counts[split]
        train = key == "K9 train"
        got = ce._run(logits, labels, mask, num, train)
        again = ce._run(logits, labels, mask, num, train)
        assert all(torch.equal(a, b) for a, b in zip(got, again) if a is not None), \
            f"{key}: two runs differ"
        ref = ce.masked_softmax_xent_fused_plain(logits, labels, mask, num, train)
        errs.append(_max_err(got[0], ref[0], 1e-5, atol_frac=0.0))
        assert float(got[1]) == float(ref[1]), f"{key}: accuracy {got[1]} != {ref[1]}"
        if train:
            errs.append(_max_err(got[2], ref[2], 2e-5))
        kernel = lambda: ce._run(logits, labels, mask, num, train)  # noqa: E731
        ms = profiling.kernel_ms(kernel, 20, "ce_kernel")
        call_ms = timer.events_ms(kernel, 20)
        pms = timer.events_ms(
            lambda: ce.masked_softmax_xent_fused_plain(logits, labels, mask, num, train), 5)
        outs = [t for t in got if t is not None]
        results[key] = dict(err=max(errs), ms=ms, plain_ms=pms,
                            **_bound(_nbytes(logits, labels, mask, *outs)))
        print(f"[kernels] {key} masked CE [{n}, 41] f32, {num} masked rows: loss "
              f"{float(got[0]):.6f} (plain {float(ref[0]):.6f}), accuracy equal, "
              f"max_abs_err {max(errs):.3e}, runs bit-identical; kernel {ms:.4f} ms "
              f"device time ({call_ms:.4f} ms a call by CUDA events, host launch "
              f"included), plain {pms:.4f} ms, bound {results[key]['bound_ms']:.4f} ms")
    check_ce_shapes(results, gen)


# K9's odd shapes: classes (staged rows up to 64, the looped path past
# them), label dtypes, and a logits view that is not 16-byte aligned
CE_SHAPES = ((1001, 7, "int64", False), (1001, 16, "int32", False),
             (777, 41, "int64", True), (1001, 47, "int32", False),
             (513, 72, "int64", False), (1001, 100, "int32", True))


def check_ce_shapes(results: dict, gen) -> None:
    """K9 train and eval against the plain version at CE_SHAPES: loss rtol
    1e-5, accuracy exact, gradient rtol 2e-5 + 1e-5·max|ref|, two runs
    bit-identical."""
    import torch

    from parallel_gcn_tpu_torch.ops import cuda_ce as ce

    for n, c, label_dtype, unaligned in CE_SHAPES:
        base = torch.randn((n * c + 1,), generator=gen).cuda()
        logits = (base[1:] if unaligned else base[:-1]).view(n, c)
        labels = torch.randint(0, c, (n,), generator=gen).to(getattr(torch, label_dtype)).cuda()
        mask = (torch.rand(n, generator=gen) < 0.5).cuda()
        num = max(int(mask.sum()), 1)
        errs = []
        for train, key in ((True, "K9 train"), (False, "K9 eval")):
            got = ce._run(logits, labels, mask, num, train)
            again = ce._run(logits, labels, mask, num, train)
            assert all(torch.equal(a, b) for a, b in zip(got, again) if a is not None), \
                f"{key} C={c}: two runs differ"
            ref = ce.masked_softmax_xent_fused_plain(logits, labels, mask, num, train)
            errs.append(_max_err(got[0], ref[0], 1e-5, atol_frac=0.0))
            assert float(got[1]) == float(ref[1]), f"{key} C={c}: accuracy differs"
            if train:
                errs.append(_max_err(got[2], ref[2], 2e-5))
            results[key]["err"] = max(results[key]["err"], *errs)
        print(f"[kernels] K9 masked CE [{n}, {c}] f32 {label_dtype} labels"
              f"{', unaligned view' if unaligned else ''} "
              f"({'staged rows' if c <= 64 else 'looped path'}): max_abs_err {max(errs):.3e}, "
              f"accuracy equal, runs bit-identical")


# K10's odd shapes (n, k, m, dtype, rate): ragged rows, columns not a
# multiple of 4 or 8, W chunked (citeseer's layer 0: [3327, 3703] x [3703,
# 16]; m > 64), m on either side of 16, 48 and 64, and the configs' other
# fused layers (synth-products' [., 256] x [256, 47], pubmed's k = 8,
# citeseer's layer 1, cora's f32 layer 0)
FUSED_SHAPES = (
    (1001, 600, 41, "bfloat16", 0.1), (517, 602, 7, "bfloat16", 0.6),
    (777, 257, 16, "bfloat16", 0.1), (333, 1433, 47, "bfloat16", 0.6),
    (1001, 600, 72, "bfloat16", 0.1), (3327, 3703, 16, "bfloat16", 0.6),
    (5003, 256, 47, "bfloat16", 0.1), (700, 8, 3, "bfloat16", 0.2),
    (3327, 16, 6, "bfloat16", 0.6), (1001, 257, 24, "float32", 0.3),
    (2708, 1433, 72, "float32", 0.4), (517, 602, 41, "float32", 0.1),
    (333, 600, 7, "float32", 0.6),
)


def _fused_inputs(gen, n, k, m, dtype):
    import torch

    x = torch.randn((n, k), generator=gen).to(dtype).cuda()
    r = (6.0 / (k + m)) ** 0.5  # Glorot range, as the layer's weight
    w = ((torch.rand((k, m), generator=gen) * 2 - 1) * r).to(dtype).cuda()
    g = (torch.randn((n, m), generator=gen) / n).cuda()  # a mean loss's scale
    return x, w, g


def _fused_calls(x, w, g, seed, rate):
    """K10's three kernels (the seed in a slot) and their plain versions
    (the int seed), with the output's tolerance: rtol 1e-4 for f32 outputs,
    one bf16 ulp for bf16 ones."""
    import torch

    from parallel_gcn_tpu_torch.ops import cuda_fused as cf

    dtype = x.dtype
    slot = _slot(seed)
    rtol_out = 2.0**-7 if dtype == torch.bfloat16 else 1e-4
    return {
        "K10 fwd": (lambda: cf._fwd(x, w, slot, rate),
                    lambda: cf.dropout_matmul_plain(x, w, seed, rate), 1e-4),
        "K10 dW": (lambda: cf._dw(x, g, slot, rate, dtype),
                   lambda: cf.dropout_matmul_dw_plain(x, g, seed, rate, dtype), rtol_out),
        "K10 dX": (lambda: cf._dx(g, w, slot, rate, dtype),
                   lambda: cf.dropout_matmul_dx_plain(g, w, seed, rate, dtype), rtol_out),
    }


def _check_mask(x, seed, rate) -> None:
    """The mask an identity W recovers from the forward equals K1's."""
    import torch

    from parallel_gcn_tpu_torch.ops import cuda_dropout as cd
    from parallel_gcn_tpu_torch.ops import cuda_fused as cf

    rows = min(x.shape[0], 4096)
    eye = torch.eye(x.shape[1], dtype=x.dtype, device="cuda")
    rec = cf._fwd(x[:rows], eye, _slot(seed), rate)
    assert torch.equal(rec, cd.dropout(x, _slot(seed), rate)[:rows].float()), \
        f"K10 {tuple(x.shape)}: recovered mask != K1's"


def check_fused(results: dict) -> None:
    """K10 forward, dW and dX against their plain versions at layer 1's
    shapes (bf16) and at FUSED_SHAPES; the mask an identity W recovers
    equals K1's bit for bit; two runs bit-identical; beside the kernels,
    the unfused pair they replace: relu_dropout (K2) then the matmul
    forward, the matmul's weight gradient, and the matmul's input gradient
    then K1."""
    import torch

    from parallel_gcn_tpu_torch.ops import cuda_dropout as cd

    gen = torch.Generator().manual_seed(5)
    seed = 0x0F1E_2D3C_4B5A_6978
    n, k, m, rate = 233472, 600, 41, 0.1
    x, w, g = _fused_inputs(gen, n, k, m, torch.bfloat16)
    _check_mask(x, seed, rate)
    hd = cd.relu_dropout(x, seed, rate)
    gd = g.to(torch.bfloat16)
    unfused = {
        "K10 fwd": lambda: torch.matmul(cd.relu_dropout(x, seed, rate), w),
        "K10 dW": lambda: torch.matmul(hd.T, gd),
        "K10 dX": lambda: cd.dropout(torch.matmul(gd, w.T), seed, rate),
    }
    flops = 2 * n * k * m
    names = {"K10 fwd": ("fwd_mma_kernel",), "K10 dW": ("dw_mma_kernel", "reduce_splits_kernel"),
             "K10 dX": ("dx_mma_kernel",)}
    for key, (kernel, plain, rtol) in _fused_calls(x, w, g, seed, rate).items():
        got, again = kernel(), kernel()
        assert torch.equal(got, again), f"{key}: two runs differ"
        err = _max_err(got, plain(), rtol)
        # device time, as the [profile] lines and K9 read it; a call's time
        # by CUDA events beside it
        ms = profiling.kernel_ms(kernel, 20, *names[key])
        call_ms = timer.events_ms(kernel, 20)
        pms = timer.events_ms(plain, 2)
        ums = profiling.kernel_ms(unfused[key], 20, "")  # every kernel of the pair
        ins = {"K10 fwd": (x, w), "K10 dW": (x, g), "K10 dX": (g, w)}[key]
        # dX's f32 product runs as three bf16 passes (g split into exact terms)
        bound = _bound(_nbytes(*ins, got), 3 * flops if key == "K10 dX" else flops)
        extra = ""
        if key == "K10 dX":
            bound["f32_ops_bound_ms"] = flops / PEAK_FLOPS["f32"] * 1e3
            extra = (f"; the f32 product on CUDA cores would be bound by its operations at "
                     f"{bound['f32_ops_bound_ms']:.4f} ms")
        print(f"[kernels] {key} [{n}, {k}] x [{k}, {m}] bf16 rate {rate}: "
              f"max_abs_err {err:.3e} (rtol {rtol:.3g}), runs bit-identical, mask = K1's; "
              f"kernel {ms:.4f} ms device time ({call_ms:.4f} ms a call by CUDA events), "
              f"plain {pms:.4f} ms, unfused pair {ums:.4f} ms device time, "
              f"bound {bound['bound_ms']:.4f} ms ({bound['bound_by']}){extra}")
        results[key] = dict(err=err, ms=ms, plain_ms=pms, unfused_ms=ums, **bound)
    del x, w, g, hd, gd
    check_fused_shapes(results, gen, seed)


def check_fused_shapes(results: dict, gen, seed: int) -> None:
    """K10 at FUSED_SHAPES with the tolerances of check_fused."""
    import torch

    for n, k, m, dtype_name, rate in FUSED_SHAPES:
        dtype = getattr(torch, dtype_name)
        x, w, g = _fused_inputs(gen, n, k, m, dtype)
        _check_mask(x, seed, rate)
        errs = []
        for key, (kernel, plain, rtol) in _fused_calls(x, w, g, seed, rate).items():
            got, again = kernel(), kernel()
            assert torch.equal(got, again), f"{key} {(n, k, m)} {dtype_name}: two runs differ"
            errs.append(_max_err(got, plain(), rtol))
            results[key]["err"] = max(results[key]["err"], errs[-1])
        print(f"[kernels] K10 [{n}, {k}] x [{k}, {m}] {dtype_name} rate {rate}: fwd, dW, dX "
              f"max_abs_err {', '.join(f'{e:.3e}' for e in errs)}, mask = K1's, "
              f"runs bit-identical")


def check_sddmm(results: dict, ds, cfg) -> None:
    """K8 on synth-reddit's int8 pack built with square 512×512 tiles: the
    forward at a, b [n, 41] in f32 (rtol 1e-5) and bf16 (rtol 2e-3), + 1e-5·
    max|ref|, against ``sddmm_plain``; the backward through autograd with
    the loss weights set to the pack's tiles (tests/test_sddmm.py), whose
    gradients are W·b and W·a for the symmetric pattern W (the plain SpMM
    on the int8 tiles, rtol 1e-4 in f32, one bf16 ulp in bf16); two runs
    bit-identical. Beside the
    kernel: its plain version and the gathered batched product ``torch.bmm``
    (cuBLAS) that computes the same tiles."""
    import dataclasses

    import torch

    from parallel_gcn_tpu_torch.data.parser import to_device
    from parallel_gcn_tpu_torch.ops import cuda_bcsr as cb
    from parallel_gcn_tpu_torch.ops import cuda_sddmm as cs

    t0 = time.perf_counter()
    pack = to_device(ds, device=torch.device("cuda"), node_pad=cfg.tpu.node_pad, hybrid=True,
                     tile_dtype="int8", tile_size=512, tile_cols=512,
                     tile_budget_mb=cfg.tpu.tile_budget_mb,
                     min_tile_nnz=cfg.tpu.min_tile_nnz).graph.bcsr
    assert pack.mirror_perm is not None, "the square pack has no mirror_perm"
    T, R, n = pack.n_tiles, pack.tile_r, pack.n_nodes
    print(f"[sddmm] synth-reddit square pack: {T} int8 tiles {R}x{pack.tile_c}, "
          f"mirror_perm set, built in {time.perf_counter() - t0:.1f} s")
    gen = torch.Generator().manual_seed(8)
    errs = []
    for dtype, rtol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-3)):
        a = torch.randn((n, 41), generator=gen).to(dtype).cuda()
        b = torch.randn((n, 41), generator=gen).to(dtype).cuda()
        out = cs.sddmm_bcsr(pack, a, b)
        assert torch.equal(out, cs.sddmm_bcsr(pack, a, b)), "K8: two runs differ"
        ref = cs.sddmm_plain(pack, a, b)
        errs.append(_max_err(out, ref, rtol))
        # f32: exact FMAs in k order from 0, as the plain cuBLAS product
        same = torch.equal(out, ref)
        assert same or dtype != torch.float32, "K8 f32 is not bit-equal to its plain version"
        del ref
        ms = timer.events_ms(lambda: cs.sddmm_bcsr(pack, a, b), 10)
        pms = timer.events_ms(lambda: cs.sddmm_plain(pack, a, b), 2)
        a3, b3 = a.view(-1, R, 41), b.view(-1, R, 41)
        rows, cols = pack.tile_rows.long(), pack.tile_cols.long()
        lib = lambda: torch.bmm(a3[rows], b3[cols].transpose(1, 2))  # noqa: E731
        lib_ms = timer.events_ms(lib, 5)
        kind = "bf16" if dtype == torch.bfloat16 else "f32"
        bound = _bound(_nbytes(a, b, pack.tile_rows, pack.tile_cols, out),
                       2 * T * R * R * 41, kind)
        print(f"[sddmm] K8 fwd a, b [{n}, 41] {dtype}: max_abs_err {errs[-1]:.3e} (rtol "
              f"{rtol}), bit-equal to plain: {same}, runs bit-identical; kernel {ms:.4f} ms, "
              f"plain {pms:.4f} ms, torch.bmm of the gathered blocks {lib_ms:.4f} ms, bound "
              f"{bound['bound_ms']:.4f} ms ({bound['bound_by']}, {_nbytes(out)} output bytes)")
        r = dict(ms=ms, plain_ms=pms, library_ms=lib_ms, err=errs[-1], **bound)
        if dtype == torch.float32:
            results["K8"] = r
        else:
            results["K8"]["bf16"] = r
        del out
        torch.cuda.empty_cache()
        # backward: L = sum(out ⊙ W), W the pack's tiles; dA = W·b, dB = Wᵀ·a = W·a
        w = pack.tiles.float()
        grads = []
        for _ in range(2):
            ar, br = a.clone().requires_grad_(True), b.clone().requires_grad_(True)
            cs.sddmm_bcsr(pack, ar, br).backward(w)
            grads.append((ar.grad, br.grad))
            torch.cuda.empty_cache()
        assert all(map(torch.equal, *grads)), "K8 backward: two runs differ"
        # W's entries are small integers, exact in bf16; bf16 gradients are
        # rounded once more, so they agree within one bf16 ulp
        pattern = dataclasses.replace(pack, sym_scale=None)
        rtol = 1e-4 if dtype == torch.float32 else 2.0**-7
        e = max(_max_err(grads[0][0], cb.bcsr_matmul_plain(pattern, b).to(dtype), rtol),
                _max_err(grads[0][1], cb.bcsr_matmul_plain(pattern, a).to(dtype), rtol))
        errs.append(e)
        print(f"[sddmm] K8 bwd {dtype}: dA = W·b and dB = W·a within rtol {rtol:.3g}, "
              f"max_abs_err {e:.3e}, runs bit-identical")
        del w, grads, ar, br
        torch.cuda.empty_cache()
        if dtype == torch.float32:
            # the backward's SpMM alone: the dense f32 body over f32 value
            # tiles (a score cotangent at the pack's positions) times b
            g = torch.randn((T, R, pack.tile_c), device="cuda",
                            generator=torch.Generator(device="cuda").manual_seed(9))
            gpack = dataclasses.replace(pattern, tiles=g)
            got = cb.bcsr_matmul_impl(gpack, b, dense_tiles=True)
            assert torch.equal(got, cb.bcsr_matmul_impl(gpack, b, dense_tiles=True))
            e = _max_err(got, cb.bcsr_matmul_plain(gpack, b), 1e-4)
            ms = timer.events_ms(lambda: cb.bcsr_matmul_impl(gpack, b, dense_tiles=True), 3)
            bound = _bound(_nbytes(g, b, got), 2 * g.numel() * 41, "f32")
            print(f"[sddmm] the dense f32 SpMM body at K8's backward shape ({T} f32 value "
                  f"tiles · b [{n}, 41] f32): max_abs_err {e:.3e} (rtol 1e-4), runs "
                  f"bit-identical; kernel {ms:.4f} ms, bound {bound['bound_ms']:.4f} ms "
                  f"({bound['bound_by']})")
            del g, gpack, got
            torch.cuda.empty_cache()
    results["K8"]["err"] = max(errs)
    del pack
    torch.cuda.empty_cache()


def mesh_slabs(ds, n_dev: int, args: list[str] = ()):
    """Rank 0's share of ``ds`` partitioned ``n_dev`` ways as the mesh paths
    partition it (synth-reddit's hybrid int8 tiles, ``args`` over the params
    file, the boundary halo; at one rank it falls back to the all_gather
    layout), on the card: the GCN's slab (K3) and the GAT's packs (K5, K7)."""
    import torch

    from parallel_gcn_tpu_torch.parallel import partition
    from parallel_gcn_tpu_torch.parallel import train_parallel as tpl

    t0 = time.perf_counter()
    cfg = _config(["halo=boundary", *args], 1)
    hsg = tpl.partition_for(cfg, ds, n_dev, "boundary")
    gcn = tpl.rank_graph(hsg, 0, torch.device("cuda"))
    mp = partition.gat_mesh_pack(hsg)
    attn = tpl.rank_graph(mp, 0, torch.device("cuda")).attn
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    n_idx = attn.rows.attn_index.col.numel()
    torch.cuda.synchronize()
    t_idx = time.perf_counter() - t1
    n_cidx = attn.cols.attn_index.col.numel()
    torch.cuda.synchronize()
    t_cidx = time.perf_counter() - t1 - t_idx
    halo = "boundary" if hsg.send_idx is not None else "all_gather (boundary fell back)"
    print(f"[mesh-kernels] {n_dev}-way partition, rank 0: [{hsg.n_local}, {hsg.n_buf}] "
          f"slab, halo {halo}; GCN slab {gcn.slab.n_tiles} live of {hsg.tiles.shape[1]} "
          f"tiles {gcn.slab.tile_r}x{gcn.slab.tile_c}; GAT rows {attn.rows.n_tiles} and "
          f"transposed columns {attn.cols.n_tiles} live of {mp.tiles_c.shape[1]} tiles "
          f"{attn.rows.tile_r}x{attn.rows.tile_c}; built in {time.perf_counter() - t0:.1f} s, "
          f"the GAT rows' live-column index ({n_idx} entries) in {t_idx:.4f} s, the "
          f"column copy's ({n_cidx} entries) in {t_cidx:.4f} s")
    return gcn, attn


def check_bcsr_rect(results: dict, slab, tag: str, record: bool) -> None:
    """K3 over a mesh rank's slab against its plain version at the mesh GCN's
    feature widths (41 and 600 bf16, the f32 input pre-aggregation's 602);
    two runs bit-identical. ``record``: this slab's F=41 numbers go to the
    JSON line."""
    import torch

    from parallel_gcn_tpu_torch.ops import cuda_bcsr as cb

    gen = torch.Generator().manual_seed(6)
    errs = []
    csr = _pack_csr(slab) if record else None
    for F, dtype, rtol in ((41, torch.bfloat16, 2e-3), (600, torch.bfloat16, 2e-3),
                           (602, torch.float32, 1e-4)):
        x = torch.randn((slab.n_nodes, F), generator=gen).to(dtype).cuda()
        got = cb.bcsr_matmul_rect(slab, x)
        assert torch.equal(got, cb.bcsr_matmul_rect(slab, x)), "K3 rect: two runs differ"
        errs.append(_max_err(got, cb.bcsr_matmul_plain(slab, x), rtol))
        ms = timer.events_ms(lambda: cb.bcsr_matmul_rect(slab, x), 10)
        pms = timer.events_ms(lambda: cb.bcsr_matmul_plain(slab, x), 2)
        bound = _spmm_bound(slab, x, got)
        body = _f32_body(slab) if dtype == torch.float32 else "bf16 body"
        print(f"[mesh-kernels] K3 rect {tag} F={F} {dtype}, {body}: max_abs_err "
              f"{errs[-1]:.3e} (rtol {rtol}), runs bit-identical; kernel {ms:.4f} ms, plain "
              f"{pms:.4f} ms, bound {bound['bound_ms']:.4f} ms ({bound['bound_by']})")
        if record:
            x32 = x.float()
            lib_ms = timer.events_ms(lambda: torch.sparse.mm(csr, x32), 10)
            print(f"[mesh-kernels] K3 rect {tag} library torch.sparse.mm (CSR f32, "
                  f"{csr.values().numel()} nnz) F={F}: {lib_ms:.4f} ms")
            if F == 602:  # the mesh's set-up pre-aggregation
                results["K3 rect f32"] = dict(ms=ms, plain_ms=pms, library_ms=lib_ms,
                                              err=errs[-1], **bound)
            if F == 41:
                results["K3 rect"] = dict(ms=ms, plain_ms=pms, library_ms=lib_ms, **bound)
                _check_stacked(f"K3 rect {tag}", lambda h: cb.bcsr_matmul_rect(slab, h), x,
                               torch.randn(x.shape, generator=gen).to(dtype).cuda())
            del x32
    del csr
    r = results.setdefault("K3 rect", {})
    r["err"] = max(r.get("err", 0.0), *errs)


def check_attention_rect(results: dict, attn, tag: str, record: bool) -> None:
    """Rect K5 and the K7 row and column sweeps against their plain versions
    on a mesh rank's packs at the GAT's shapes (heads 2; d 32 and 41; bf16;
    attention dropout 0 and 0.6), the K5/K6 phase's tolerances, two runs
    bit-identical. ``record``: this slab's d=41, rate-0 numbers go to the
    JSON line."""
    import torch

    from parallel_gcn_tpu_torch.ops import tile_attention as ta

    gen = torch.Generator().manual_seed(7)
    n, nb, H = attn.n_rows, attn.n_buf, 2
    errs = {"K5 rect": [], "K7 row": [], "K7 col": []}
    for D in (32, 41):
        s = torch.randn((n, H), generator=gen).to(torch.bfloat16).cuda()
        t = torch.randn((nb, H), generator=gen).to(torch.bfloat16).cuda()
        v = torch.randn((nb, H, D), generator=gen).to(torch.bfloat16).cuda()
        g = torch.randn((n, H, D), generator=gen).cuda()
        for rate in (0.0, 0.6):
            # the kernels read the seed from a slot, the plain versions take the int
            kw = dict(slope=0.2, rate=rate, seed=_slot(0x2468ACE, torch.int32))
            pkw = dict(kw, seed=0x2468ACE)
            fwd = ta.gat_fwd_rect(attn.rows, s, t, v, **kw)
            assert all(map(torch.equal, fwd, ta.gat_fwd_rect(attn.rows, s, t, v, **kw))), \
                "K5 rect: two runs differ"
            acc, m, den = ta.gat_fwd_tiles_plain(attn.rows, s, t, v, **pkw)
            live = den > 0  # rows with entries; the others keep m = -1e9
            assert torch.equal(fwd[1][~live], m[~live]), "K5 rect: m of empty rows"
            errs["K5 rect"].append(max(_max_err(fwd[0], acc, 2e-3), _max_err(fwd[2], den, 2e-3),
                                       _max_err(fwd[1][live], m[live], 1e-6)))
            rho = (g * acc / den.clamp(min=1e-16)[:, :, None]).sum(-1)
            bw = (s, t, v, g, m, den, rho)
            row = ta.gat_bwd_rect_row(attn.rows, *bw, **kw)
            assert torch.equal(row, ta.gat_bwd_rect_row(attn.rows, *bw, **kw)), \
                "K7 row: two runs differ"
            col = ta.gat_bwd_rect_col(attn.cols, *bw, **kw)
            assert all(map(torch.equal, col, ta.gat_bwd_rect_col(attn.cols, *bw, **kw))), \
                "K7 col: two runs differ"
            errs["K7 row"].append(_max_err(
                row, ta.gat_bwd_rect_row_plain(attn.rows, *bw, **pkw), 1e-3, atol_frac=1e-4))
            errs["K7 col"].append(max(
                _max_err(a, b, 1e-3, atol_frac=1e-4)
                for a, b in zip(col, ta.gat_bwd_rect_col_plain(attn.cols, *bw, **pkw))))
            # f32 FMAs per live entry, head and feature: the weighted row sums
            # Σ w·v (K5), Σ A·v (row sweep), Σ an·g and Σ C·g (column sweep)
            calls = {
                "K5 rect": (lambda: ta.gat_fwd_rect(attn.rows, s, t, v, **kw),
                            lambda: ta.gat_fwd_tiles_plain(attn.rows, s, t, v, **pkw),
                            attn.rows, (s, t, v, *fwd), 1),
                "K7 row": (lambda: ta.gat_bwd_rect_row(attn.rows, *bw, **kw),
                           lambda: ta.gat_bwd_rect_row_plain(attn.rows, *bw, **pkw),
                           attn.rows, (*bw, row), 1),
                "K7 col": (lambda: ta.gat_bwd_rect_col(attn.cols, *bw, **kw),
                           lambda: ta.gat_bwd_rect_col_plain(attn.cols, *bw, **pkw),
                           attn.cols, (*bw, *col), 2),
            }
            for key, (kernel, plain, pack, tensors, fmas) in calls.items():
                ms = timer.events_ms(kernel, 10)
                pms = timer.events_ms(plain, 2)
                # over the slab's (K7 col: its column copy's) live-column
                # index, which all three walk, and streaming its tiles
                bound = _attn_bounds(pack, _nbytes(*tensors), fmas, H, D)
                print(f"[mesh-kernels] {key} {tag} H={H} D={D} bf16 rate {rate}: "
                      f"max_abs_err {errs[key][-1]:.3e}, runs bit-identical; kernel "
                      f"{ms:.4f} ms, plain {pms:.4f} ms, bound {bound['bound_ms']:.4f} ms over "
                      f"the index ({bound['bound_by']}), {bound['pack_bound_ms']:.4f} ms "
                      f"streaming the slab")
                if record and (D, rate) == (41, 0.0):  # layer 1 of the main path
                    results[key] = dict(ms=ms, plain_ms=pms, **bound)
    for key, e in errs.items():
        r = results.setdefault(key, {})
        r["err"] = max(r.get("err", 0.0), *e)


def check_reference_mesh() -> None:
    """``fit_parallel`` in a world of one on a small graph, on the card (NCCL)
    and on the CPU (gloo, the plain versions): the GCN over flat COO slabs
    (all_gather halo), over hybrid int8 slabs with the boundary halo kept at
    one rank (an all_to_all of one), and the GAT over ``gat_mesh_pack``
    slabs with feature and attention dropout; the metrics must agree within
    2e-4 and the mesh kernels launch on the card only."""
    import torch

    from parallel_gcn_tpu_torch.config import Config
    from parallel_gcn_tpu_torch.data.synthetic import make_synthetic_dataset
    from parallel_gcn_tpu_torch.ops import cuda_bcsr, tile_attention
    from parallel_gcn_tpu_torch.parallel.train_parallel import fit_parallel

    ds = make_synthetic_dataset(
        "smoke", n_nodes=2000, n_edges=40_000, input_dim=64, n_classes=8,
        n_train=1200, n_val=300, feature_nnz_per_row=16, n_communities=20,
    )

    def config(backend, halo, gat=False):
        cfg = Config()
        cfg.gcn.hidden_dims, cfg.gcn.dropouts, cfg.gcn.epochs = (32,), (0.0, 0.1), 3
        cfg.train.verbose = False
        cfg.tpu.backend, cfg.tpu.halo, cfg.tpu.halo_fallback = backend, halo, False
        cfg.tpu.tile_dtype, cfg.tpu.tile_size, cfg.tpu.tile_cols = "int8", 128, 256
        if gat:
            cfg.gcn.model, cfg.gcn.heads, cfg.gcn.hidden_dims = "gat", 2, (8,)
            cfg.gcn.dropouts, cfg.gcn.attn_dropout = (0.0, 0.3), 0.3
        return cfg

    runs = {
        "GCN flat all_gather": (config("segment", "all_gather"), []),
        "GCN hybrid int8 boundary": (config("hybrid", "boundary"),
                                     [(cuda_bcsr.launches, "bcsr_rect_f32")]),
        "GAT mesh pack boundary": (config("hybrid", "boundary", gat=True),
                                   [(tile_attention.launches, k) for k in
                                    ("gat_fwd_rect", "gat_bwd_rect_row", "gat_bwd_rect_col")]),
    }
    for name, (cfg, watch) in runs.items():
        hist = {}
        for dev in ("cuda", "cpu"):
            before = [d[k] for d, k in watch]
            hist[dev] = fit_parallel(cfg, ds, n_devices=1, device=dev).history
            for (d, k), b in zip(watch, before):
                assert (d[k] > b) == (dev == "cuda"), f"{name}: {k} launched on {dev}: {d[k] - b}"
        diff = float(abs(hist["cuda"] - hist["cpu"]).max())
        print(f"[reference-mesh] {name}: fit_parallel, a world of one, 2000-node graph, "
              f"3 epochs: card (NCCL) vs CPU (gloo, plain) max metric diff {diff:.3e}")
        assert diff < 2e-4, f"{name}: card and CPU trajectories differ by {diff}"


HALO_RANKS = 4


def hub_csr(n: int, w: int = 2, n_hubs: int = 3):
    """The JAX package's power-law test fixture (``tests/test_parallel.py``
    ``_hub_csr``) at ``n`` nodes: a band of width ``w`` plus ``n_hubs`` nodes
    adjacent to every node, with self-loops, built with the port's CSR
    builder."""
    import numpy as np

    from parallel_gcn_tpu_torch.data.graph import add_self_loops_csr

    band, hubs, every = np.arange(-w, w + 1), np.arange(n_hubs), np.arange(n)
    lists = []
    for i in range(n):
        nb = np.delete(every, i) if i < n_hubs else np.union1d(hubs, np.clip(i + band, 0, n - 1))
        lists.append(nb[nb != i].astype(np.int32))
    return add_self_loops_csr(lists)


def _emulate(sg, graphs, xs):
    """Â·x of a partition's ranks, each rank's half on the card
    (``parallel.train_parallel``'s ``ring_step``, ``pull_sum``,
    ``push_partials``, ``receive_add``, the ordered sums) and the rows the
    collectives carry moved between the ranks by indexing, with no NCCL.
    ``xs``: each rank's rows. Returns each rank's output rows."""
    import torch

    from parallel_gcn_tpu_torch.ops.cuda_segment import gather_sum
    from parallel_gcn_tpu_torch.parallel import train_parallel as tpl

    n = sg.n_dev

    def all_to_all(slabs):  # chunk d of rank b's rows goes to rank d, in rank order
        s = slabs[0].shape[0] // n
        return [torch.cat([slabs[b][d * s:(d + 1) * s] for b in range(n)]) for d in range(n)]

    if graphs[0].ring is not None:
        accs, blks = [None] * n, list(xs)
        for s in range(n):
            accs = [tpl.ring_step(accs[d], blks[d], graphs[d].ring[s]) for d in range(n)]
            blks = [blks[(d - 1) % n] for d in range(n)]  # rank d gets rank d − 1's block
        return accs
    scale = [g.d for g in graphs]
    if scale[0] is not None:  # int8 pattern slabs: d before any exchange
        xs = [(d[:, None] * x.float()).to(x.dtype) for d, x in zip(scale, xs)]
    if sg.send_idx is None:
        bufs = [torch.cat(xs)] * n
    else:
        recv = all_to_all([x.index_select(0, g.send.index) for x, g in zip(xs, graphs)])
        bufs = [torch.cat([x, r]) for x, r in zip(xs, recv)]
    outs = []
    for g, buf in zip(graphs, bufs):
        if g.coo is not None:
            outs.append(gather_sum(buf, g.coo[3]))
        else:
            outs.append(tpl.pull_sum(buf, g.slab, g.res))
    if graphs[0].push is not None:
        recv = all_to_all([tpl.push_partials(x, g.push) for x, g in zip(xs, graphs)])
        outs = [tpl.receive_add(o, r, g.push) for o, r, g in zip(outs, recv, graphs)]
    if scale[0] is not None:
        outs = [(d[:, None] * o).to(o.dtype) for d, o in zip(scale, outs)]
    return outs


def phase_halo_kernels(ds) -> dict:
    """The ring and adaptive halos' rank-local halves on the card, 4 ranks
    emulated on one card (``_emulate``): synth-reddit's flat adaptive
    partition (push pairs, from its community reorder), its ring, and the
    hybrid int8 adaptive partition of the hub fixture at synth-reddit's node
    count and tile settings (push pairs), each checked by
    ``check_halo_case``. Returns each case's buffer rows and piece times."""
    cfg = _config([], 1)
    n = HALO_RANKS
    t0 = time.perf_counter()
    hub = hub_csr(232_965 + 507)  # 233,472 nodes: the padded synth-reddit count
    t_hub = time.perf_counter() - t0
    tiles = dict(tile_r=cfg.tpu.tile_size, tile_c=cfg.tpu.tile_cols, tile_dtype="int8",
                 tile_budget_bytes=cfg.tpu.tile_budget_mb * 1024 * 1024,
                 min_tile_nnz=cfg.tpu.min_tile_nnz or None, node_pad=cfg.tpu.node_pad)
    t0 = time.perf_counter()
    cases = halo_cases(ds.graph, hub, n, tiles)
    print(f"[halo-kernels] the hub graph ({hub.n_rows} nodes, {hub.nnz} entries) built in "
          f"{t_hub:.1f} s; the {n}-way adaptive, ring and boundary partitions in "
          f"{time.perf_counter() - t0:.1f} s")
    return {name: check_halo_case(name, *case, "cuda") for name, case in cases.items()}


def halo_cases(graph, hub, n: int, tiles: dict) -> dict:
    """name -> (CSR, partition, the boundary layout's partition or None):
    ``graph``'s flat adaptive and ring partitions, ``hub``'s int8 tile
    adaptive one (``tiles``: partition_graph_hybrid's tile settings); both
    adaptive ones must push."""
    from parallel_gcn_tpu_torch.parallel import partition

    with warnings_ignored():
        cases = {
            "flat adaptive, synth-reddit": (
                graph, partition.partition_graph(graph, n, adaptive=True),
                partition.partition_graph(graph, n, boundary=True)),
            "ring, synth-reddit": (graph, partition.partition_graph_ring(graph, n), None),
            "hybrid int8 adaptive, hub graph": (
                hub, partition.partition_graph_hybrid(hub, n, adaptive=True, **tiles),
                partition.partition_graph_hybrid(hub, n, boundary=True, **tiles)),
        }
    assert cases["flat adaptive, synth-reddit"][1].push_slab > 0
    assert cases["hybrid int8 adaptive, hub graph"][1].push_slab > 0
    return cases


def check_halo_case(name: str, csr, sg, sgb, device: str) -> dict:
    """One partition's ranks emulated on ``device`` (``_emulate``): Â·x at
    F=41 and F=600 bf16 and F=602 f32 against the single-card ``graphsum``
    of the same graph on the device (f32: rtol 1e-4 + 1e-5·max|ref|, phase
    3's; bf16: 2^-6 of each row's Σ|Â_ij x_j| + 1e-5·max|ref|, since the
    pipeline rounds each ring step's and each push partial's sum to bf16
    where the single-card path rounds once: the bound of those roundings)
    and at F=41 bf16 against the same pipeline's plain versions on the CPU
    (phase 3's bf16 tolerance; the plain gather-sum's [E, F] f32 products at
    F=600 would take 28 GB of host memory); the gradient through the
    self-adjoint route (the pipeline on a cotangent) against the single
    card's autograd at F=41 f32; two runs bit-identical. Prints each
    piece's time on the first rank that pushes tiles (else rank 0) beside
    the buffer rows of the boundary and all_gather layouts."""
    import torch

    from parallel_gcn_tpu_torch.data.graph import build_graph
    from parallel_gcn_tpu_torch.ops.cuda_segment import gather_sum
    from parallel_gcn_tpu_torch.ops.graphsum import graphsum
    from parallel_gcn_tpu_torch.parallel import train_parallel as tpl

    n = sg.n_dev
    dev, cpu = torch.device(device), torch.device("cpu")
    gen = torch.Generator().manual_seed(12)
    graphs = [tpl.rank_graph(sg, r, dev) for r in range(n)]
    single = build_graph(csr, device=dev, n_nodes_pad=sg.n_nodes_pad)
    perm = getattr(sg, "node_perm", None)
    perm = None if perm is None else torch.from_numpy(perm).to(dev)
    n_real = csr.n_rows

    def split(x):
        x = x if perm is None else x[perm]
        return list(x.split(sg.n_local))

    def reference(x):  # the single-card Â·x in the partition's row order
        y = graphsum(x, single, backend="segment")
        return y if perm is None else y[perm]

    errs = []
    for F, dtype in ((41, torch.bfloat16), (600, torch.bfloat16), (602, torch.float32)):
        x = torch.zeros((sg.n_nodes_pad, F), dtype=dtype, device=dev)
        x[:n_real] = torch.randn((n_real, F), generator=gen).to(dtype).to(dev)
        got = torch.cat(_emulate(sg, graphs, split(x)))
        assert torch.equal(got, torch.cat(_emulate(sg, graphs, split(x)))), \
            f"{name}: two runs differ"
        ref = reference(x)
        if dtype == torch.float32:
            errs.append(_max_err(got, ref, 1e-4))
        else:
            scale = reference(x.abs().float())
            err = (got.float() - ref.float()).abs()
            assert bool((err <= 2.0**-6 * scale + 1e-5 * ref.abs().max()).all()), \
                f"{name} F={F}: beyond the bf16 rounding bound"
            errs.append(float(err.max()))
        if F == 41:
            cgraphs = [tpl.rank_graph(sg, r, cpu) for r in range(n)]
            plain = torch.cat(_emulate(sg, cgraphs, [t.cpu() for t in split(x)]))
            cpu_err = _max_err(got, plain.to(dev), 2e-3)
            del cgraphs, plain
        del x, got, ref
    # the gradient: the same pipeline on the cotangent (self-adjoint)
    g = torch.zeros((sg.n_nodes_pad, 41), device=dev)
    g[:n_real] = torch.randn((n_real, 41), generator=gen).to(dev)
    xr = torch.zeros_like(g).requires_grad_(True)
    graphsum(xr, single, backend="segment").backward(g)
    want = xr.grad if perm is None else xr.grad[perm]
    grad_err = _max_err(torch.cat(_emulate(sg, graphs, split(g))), want, 1e-4)
    del g, xr, want

    # each piece's time on one rank, at 41 and 600 bf16
    r = next((r for r, g in enumerate(graphs) if g.push is not None and g.push.tiles is not None),
             0)
    g0 = graphs[r]
    pieces = {}
    for F in (41, 600):
        x0 = torch.randn((sg.n_local, F), generator=gen).to(torch.bfloat16).to(dev)
        if g0.ring is not None:
            pieces[f"ring step 0 (local slab) F={F}"] = timer.events_ms(
                lambda: tpl.ring_step(None, x0, g0.ring[0]), 5)
            pieces[f"ring steps 1-{n - 1} F={F}"] = sum(timer.events_ms(
                lambda s=s: tpl.ring_step(None, x0, g0.ring[s]), 5) for s in range(1, n))
            continue
        buf = torch.randn((sg.n_buf, F), generator=gen).to(torch.bfloat16).to(dev)
        if g0.coo is not None:
            pieces[f"pull gather-sum F={F}"] = timer.events_ms(
                lambda: gather_sum(buf, g0.coo[3]), 5)
        else:
            pieces[f"pull K3 + residual F={F}"] = timer.events_ms(
                lambda: tpl.pull_sum(buf, g0.slab, g0.res), 5)
        if g0.push.tiles is not None:
            pieces[f"push K3 alone F={F}"] = timer.events_ms(
                lambda: tpl.bcsr_matmul_rect(g0.push.tiles, x0), 5)
            pieces[f"push K3 bound F={F}"] = _spmm_bound(
                g0.push.tiles, x0, tpl.bcsr_matmul_rect(g0.push.tiles, x0))["bound_ms"]
        part = tpl.push_partials(x0, g0.push)
        pieces[f"push partial slab F={F}"] = timer.events_ms(
            lambda: tpl.push_partials(x0, g0.push), 5)
        out = torch.zeros((sg.n_local, F), dtype=torch.bfloat16, device=dev)
        pieces[f"receive-add F={F}"] = timer.events_ms(
            lambda: tpl.receive_add(out, part, g0.push), 5)
        del buf, part, out
    rows = {"this layout": sg.n_local if getattr(sg, "ring", False) else sg.n_buf,
            "boundary": None if sgb is None else sgb.n_buf, "all_gather": sg.n_nodes_pad}
    push = f"push_slab {sg.push_slab}, pull halo {sg.halo_size}, " if sg.push_slab else ""
    if hasattr(sg, "ptiles") and sg.push_slab:
        push += (f"tiles a rank {sg.tiles.shape[1]} pulled + {sg.ptiles.shape[1]} pushed "
                 f"(boundary layout {sgb.tiles.shape[1]}), ")
    print(f"[halo-kernels] {name}, {n} ranks emulated on the card: {push}buffer rows a rank "
          f"{json.dumps(rows)}; Â·x at F=41/600 bf16 and F=602 f32 against the single-card "
          f"graphsum, max_abs_err {', '.join(f'{e:.3e}' for e in errs)}; F=41 bf16 against "
          f"the plain versions on the CPU {cpu_err:.3e}; gradient (the pipeline on the "
          f"cotangent) against the single card's autograd {grad_err:.3e}; two runs "
          f"bit-identical; rank {r}'s pieces, ms: "
          f"{json.dumps({k: round(v, 4) for k, v in pieces.items()})}")
    return dict(rows=rows, push_slab=sg.push_slab, ms=pieces)


# tensor parallelism emulated on one card: the feat widths of synth-reddit's
# 600-wide hidden layer at tp 2 and 4
TP_SIZES = (2, 4)
TP_FAMILIES = {"GCN": [], "SAGE": SAGE_ARGS, "GIN": GIN_ARGS}


class _Lockstep:
    """``size`` feat ranks of one node rank, each a thread of this process,
    taking turns: a rank runs until it reaches a feat collective, leaves its
    tensor and hands the turn on; the last rank combines the tensors
    (``combine``, differentiable torch ops in feat-rank order) and hands the
    turn back to rank 0, and each rank takes its share of the result when
    its turn comes again. One rank runs at a time, in rank order, so two
    runs launch the same kernels in the same order."""

    def __init__(self, size: int):
        import threading

        self.size, self.turn, self.error = size, 0, None
        self.cv = threading.Condition()
        self.slots: list = [None] * size
        self.out: list = []

    def wait(self, r: int) -> None:
        with self.cv:
            if not self.cv.wait_for(lambda: self.turn == r or self.error is not None, 300):
                raise TimeoutError(f"feat rank {r} waited 300 s for its turn")
            if self.error is not None:
                raise RuntimeError("another emulated feat rank failed") from self.error

    def hand_on(self, r: int) -> None:
        with self.cv:
            self.turn = (r + 1) % self.size
            self.cv.notify_all()

    def fail(self, error: BaseException) -> None:
        with self.cv:
            self.error = error
            self.cv.notify_all()

    def exchange(self, r: int, x, combine):
        self.slots[r] = x
        if r == self.size - 1:
            self.out, self.slots = combine(self.slots), [None] * self.size
        self.hand_on(r)
        self.wait(r)
        return self.out[r]


class _EmulatedFeat:
    """Feat rank ``rank`` of a ``_Lockstep`` grid, with the methods of
    ``collectives.FeatGroup`` that the TP layers call: the collectives are
    concatenations and sums in feat-rank order. The ranks' forwards build
    one autograd graph, so one backward of one rank's loss runs every
    transpose (a psum's sum hands each partial the cotangent; the column
    gather's concatenation hands each block its slice; a replicated tensor
    sums the cotangents of the ranks that read it, which is Megatron's f,
    so ``copy_in`` is the identity)."""

    def __init__(self, lock: _Lockstep, rank: int):
        self.lock, self.rank, self.size = lock, rank, lock.size

    @staticmethod
    def _sum(xs):
        acc = xs[0]
        for x in xs[1:]:
            acc = acc + x
        return acc

    def psum(self, x):
        return self.lock.exchange(self.rank, x, lambda xs: [self._sum(xs)] * self.size)

    all_reduce = psum

    def psum_scatter(self, x):
        return self.lock.exchange(self.rank, x, lambda xs: [
            c.contiguous() for c in self._sum(xs).chunk(self.size, dim=1)])

    def gather_cols(self, x):
        import torch

        return self.lock.exchange(self.rank, x,
                                  lambda xs: [torch.cat(xs, dim=1)] * self.size)

    def copy_in(self, x):
        return x


def _tp_emulated_step(models, x, graph, labels, mask, n_train: int, seeds: list):
    """One training forward and backward of ``models`` (one a feat rank,
    ``_EmulatedFeat`` grids; one model alone: tp 1) on the card: (rank 0's
    logits, every rank's weight gradients in rank order, the loss's
    cotangent of the logits)."""
    import threading

    import torch

    from parallel_gcn_tpu_torch.ops.loss import masked_softmax_xent_sums

    out: list = [None] * len(models)
    if len(models) == 1:
        out[0] = models[0](x, graph, training=True, seeds=seeds[0])
    else:
        lock = models[0].feat.lock

        def rank(r):
            try:
                lock.wait(r)
                out[r] = models[r](x, graph, training=True, seeds=seeds[r])
                lock.hand_on(r)
            except BaseException as e:  # the other ranks wait on this one
                lock.fail(e)
                raise

        threads = [threading.Thread(target=rank, args=(r,)) for r in range(len(models))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert all(o is not None for o in out), "an emulated feat rank failed"
    logits, weights = out[0], [w for m in models for w in m.weights]
    loss = masked_softmax_xent_sums(logits, labels, mask)[0] / float(n_train)
    (cot,) = torch.autograd.grad(loss, [logits], retain_graph=True)
    grads = torch.autograd.grad(logits, weights, cot)
    return logits.detach(), [g.detach() for g in grads], cot


def _tp_models(cfg, sg, weights, tp: int, device="cuda"):
    """The mesh model of ``cfg`` at tp 1, or its ``tp`` feat ranks over one
    ``_Lockstep`` grid, on ``device``."""
    from parallel_gcn_tpu_torch.parallel import train_parallel as tpl

    if tp == 1:
        return [tpl.build_mesh_model(cfg, sg, weights, device)]
    lock = _Lockstep(tp)
    return [tpl.build_mesh_model(cfg, sg, weights, device, feat=_EmulatedFeat(lock, r))
            for r in range(tp)]


def _full_grads(grads, cfg, tp: int):
    """The TP ranks' gradient shards (rank-major) put back into full arrays."""
    import torch

    from parallel_gcn_tpu_torch.parallel import train_parallel as tpl

    n = len(grads) // tp
    kinds = tpl.leaf_kinds(n, cfg.gcn.model)
    return [torch.cat([grads[r * n + i] for r in range(tp)], dim=1 if kinds[i] == "col" else 0)
            for i in range(n)]


def check_tp_kernels(graph, results: dict) -> None:
    """K3 over the one-rank slab and kernel (a) over its residual at the
    TP widths 300 and 150 bf16 (synth-reddit's 600 over tp 2 and 4, padded
    to 304 and 160 by ``pad_features``) against their plain versions, with
    phase 3's tolerances, two runs bit-identical."""
    import torch

    from parallel_gcn_tpu_torch.ops import cuda_bcsr as cb

    gen = torch.Generator().manual_seed(13)
    slab, res_seg = graph.slab, graph.res
    nnz = int(slab.live_entries[0].numel())
    for F in (600 // t for t in TP_SIZES):
        x = torch.randn((slab.n_nodes, F), generator=gen).to(torch.bfloat16).cuda()
        got = cb.bcsr_matmul_rect(slab, x)
        assert torch.equal(got, cb.bcsr_matmul_rect(slab, x)), "K3 rect: two runs differ"
        err = _max_err(got, cb.bcsr_matmul_plain(slab, x), 2e-3)
        ms = timer.events_ms(lambda: cb.bcsr_matmul_rect(slab, x), 10)
        pms = timer.events_ms(lambda: cb.bcsr_matmul_plain(slab, x), 2)
        bound = _bound(_pack_bytes(slab) + _nbytes(x, got), 2 * nnz * F)
        print(f"[tp-emulated] K3 rect one-rank slab F={F} bf16 (x padded to "
              f"{cb.pad_features(x).shape[1]}): max_abs_err {err:.3e} (rtol 2e-3), runs "
              f"bit-identical; kernel {ms:.4f} ms, plain {pms:.4f} ms, bound "
              f"{bound['bound_ms']:.4f} ms ({bound['bound_by']})")
        results[f"K3 rect F={F}"] = dict(err=err, ms=ms, plain_ms=pms, **bound)
        check_segment_gather(results, None, f"one-rank slab residual (tp width {F})",
                             x[: graph.n_buf], res_seg)
        del x, got


def phase_tp_emulated(ds) -> dict:
    """Tensor parallelism on one card: tp = 2 and 4 feat ranks of one node
    rank emulated in this process (``_Lockstep``, ``_EmulatedFeat``: the
    feat collectives become concatenations and sums in feat-rank order),
    driving the port's own TP layers (``MeshGCN``, ``MeshSAGE``, ``MeshGIN``
    built by ``build_mesh_model`` with the emulated group) over synth-reddit
    at 602 -> 600 -> 41 on the params file's hybrid int8 slab at one node
    rank. For each family and tp: one training forward and backward (the
    GCN without input pre-aggregation, so layer 0 aggregates its 600/tp
    columns) with dropouts 0, the logits and every weight gradient against
    the same mesh model at tp 1: in f32 within rtol 1e-4 + 1e-5·max|ref|;
    in bf16 the logits within 2·L·(12 + tp) roundings of 2^-9 of Σ|terms|
    (the same forward on |x| and |W| in f32: every intermediate bounds its
    term, and no path pair rounds more often) + 1e-5·max|ref|, the GCN's
    and SAGE's gradients within 2^-4·max|ref|; every family's bf16
    gradients at tp 1, 2 and 4 against the f32 ones at tp 1 within the same
    count of roundings of their Σ|terms| (the |x|, |W| model's gradients of
    |f32 cotangent|), plus the bf16 cotangent's change carried back by that
    model. GIN-0's gradients cancel: a leaf's Σ|terms| reach 300-4000 times
    its max|g|, so one rounding of one term moves an entry by whole units
    at tp 1 as at tp 4, and only this bound holds them; then with the
    file's dropouts in bf16, two runs bit-identical, the launch counts set to 0 just before the
    first and read after it. K3 and kernel (a) at 300 and 150 columns
    against their plain versions (``check_tp_kernels``). Returns the
    launches and the checks' errors."""
    import torch

    from parallel_gcn_tpu_torch.models.gcn import set_matmul_precision
    from parallel_gcn_tpu_torch.parallel import collectives
    from parallel_gcn_tpu_torch.parallel import train_parallel as tpl

    t0 = time.perf_counter()
    cfg0 = _config(["halo=boundary"], 1)
    with warnings_ignored():
        sg = tpl.partition_for(cfg0, ds, 1, "boundary")
    graph = tpl.rank_graph(sg, 0, torch.device("cuda"), tpl.sharded_sqrt_deg(ds, sg))
    data = tpl.rank_data(ds, sg, 0, torch.device("cuda"))
    print(f"[tp-emulated] synth-reddit's one-rank int8 slab and rows on the card in "
          f"{time.perf_counter() - t0:.1f} s: {graph.slab.n_tiles} tiles, {sg.n_local} rows")
    results: dict = {}
    check_tp_kernels(graph, results)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    bf16_red = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    set_matmul_precision("highest")
    counts: dict = {}
    errs: dict = {}
    # the node rank's aggregation runs its halo over a world of one (NCCL)
    with collectives.world(1, torch.device("cuda", 0)):
        _tp_families(ds, sg, graph, data, counts, errs)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = bf16_red
    del graph, data
    torch.cuda.empty_cache()
    print(f"[tp-emulated] done in {time.perf_counter() - t0:.1f} s")
    return dict(counts=counts, errs=errs, kernels=results)


def _tp_families(ds, sg, graph, data, counts: dict, errs: dict) -> None:
    """``phase_tp_emulated``'s checks of each family and tp."""
    import torch

    from parallel_gcn_tpu_torch.data.parser import TRAIN
    from parallel_gcn_tpu_torch.parallel import train_parallel as tpl
    from parallel_gcn_tpu_torch.train import init_weights

    mask = data.split == TRAIN
    n_train = int(mask.sum())
    for fam, args in TP_FAMILIES.items():
        cfg = _config(args, 1)
        L = len(cfg.gcn.dropouts)
        full = init_weights(cfg, ds.input_dim, ds.output_dim)
        no_seeds = [[0] * L]

        def step(dtype: str, tp: int):
            c = _config([*args, f"compute_dtype={dtype}",
                         "dropouts=" + ",".join(["0.0"] * L)], 1)
            logits, grads, cot = _tp_emulated_step(_tp_models(c, sg, full, tp), data.x,
                                                   graph, data.labels, mask, n_train,
                                                   no_seeds * tp)
            return logits, _full_grads(grads, c, tp), cot

        l32, g32, cot32 = step("float32", 1)
        for tp in TP_SIZES:
            logits, grads, _ = step("float32", tp)
            e_l = _max_err(logits, l32, 1e-4)
            e_g = max(_max_err(g, r, 1e-4) for g, r in zip(grads, g32))
            errs[f"{fam} tp={tp} float32"] = (e_l, e_g)
            print(f"[tp-emulated] {fam} tp={tp} float32, dropouts 0: logits max_abs_err "
                  f"{e_l:.3e}, weight gradients max abs_err {e_g:.3e} against tp=1, shards "
                  f"{[list(w.shape) for w in tpl.shard_weights(full, tp, 0, cfg.gcn.model)]}")
            del logits, grads
        # the same forward on |x| and |W| in f32: its logits bound every term
        # of the logits; its gradients of |f32 cotangent| are each gradient
        # entry's Σ|terms|, of a cotangent's change what the change carries
        # back (every product and sum on magnitudes, every ReLU passing)
        a = _config([*args, "compute_dtype=float32", "dropouts=" + ",".join(["0.0"] * L)], 1)
        abs_model = _tp_models(a, sg, [w.abs() for w in full], 1)[0]
        abs_logits = abs_model(data.x.abs(), graph, training=True, seeds=no_seeds[0])
        scale = abs_logits.detach()
        terms = torch.autograd.grad(abs_logits, abs_model.weights, cot32.abs(),
                                    retain_graph=True)
        l1, g1, cot1 = step("bfloat16", 1)
        for tp in (1, *TP_SIZES):
            logits, grads, cot = (l1, g1, cot1) if tp == 1 else step("bfloat16", tp)
            rounds = 2 * L * (12 + tp) * 2.0**-9
            carried = torch.autograd.grad(abs_logits, abs_model.weights, (cot - cot32).abs(),
                                          retain_graph=True)
            units = 0.0  # the largest |g - g32| / Σ|terms|, in roundings (2^-9)
            for g, r, t, b in zip(grads, g32, terms, carried):
                assert bool(torch.isfinite(g).all()), f"{fam} tp={tp} bf16 gradient"
                err = (g - r).abs()
                assert bool((err <= rounds * t + (1 + rounds) * b
                             + 1e-5 * r.abs().max()).all()), \
                    f"{fam} tp={tp} bf16 gradient beyond the rounding bound of the f32 one"
                units = max(units, float((err / t.clamp_min(1e-30)).max()) * 2.0**9)
            e_32 = max(float((g - r).abs().max() / r.abs().max()) for g, r in zip(grads, g32))
            if tp == 1:
                cancel = max(float(t.max() / r.abs().max()) for t, r in zip(terms, g32))
                print(f"[tp-emulated] {fam} tp=1 bfloat16, dropouts 0: weight gradients "
                      f"against f32 max err / max|g32| {e_32:.3e}, at most {units:.3f} "
                      f"roundings of an entry's Σ|terms| (bound {rounds * 2**9:.0f}); a "
                      f"leaf's largest Σ|terms| up to {cancel:.1f} times its max|g32|")
                continue
            err = (logits - l1).abs()
            bound = rounds * scale + 1e-5 * l1.abs().max()
            assert bool((err <= bound).all()), f"{fam} tp={tp} bf16 logits beyond the bound"
            e_l = float(err.max())
            e_g = 0.0
            for g, r in zip(grads, g1):
                gerr = float((g - r).abs().max())
                assert fam == "GIN" or gerr <= 2.0**-4 * float(r.abs().max()), \
                    f"{fam} tp={tp} bf16 gradient off by {gerr}"
                e_g = max(e_g, gerr / float(r.abs().max()))
            errs[f"{fam} tp={tp} bfloat16"] = (e_l, e_g)
            print(f"[tp-emulated] {fam} tp={tp} bfloat16, dropouts 0: logits max_abs_err "
                  f"{e_l:.3e}, weight gradients max err / max|ref| {e_g:.3e} against tp=1; "
                  f"against f32 {e_32:.3e}, at most {units:.3f} roundings of an entry's "
                  f"Σ|terms| (bound {rounds * 2**9:.0f}), shards "
                  f"{[list(w.shape) for w in tpl.shard_weights(full, tp, 0, cfg.gcn.model)]}")
            del logits, grads, cot, carried
        del l32, g32, cot32, l1, g1, cot1, abs_model, abs_logits, scale, terms
        # the file's dropouts in bf16: launches at the feat widths, two runs bit-identical
        seeds0 = [int(s) for s in torch.randint(0, 2**62, (L,),
                                                generator=torch.Generator().manual_seed(5))]
        for tp in TP_SIZES:
            models = _tp_models(cfg, sg, full, tp)
            seeds = [tpl.rank_seeds(seeds0, 0, False, r, m.feat_sharded_inputs())
                     for r, m in enumerate(models)]
            _reset_counts()
            first = _tp_emulated_step(models, data.x, graph, data.labels, mask, n_train,
                                      [[_slot(s) for s in r] for r in seeds])[:2]
            torch.cuda.synchronize()
            launched = _read_counts()
            for k, v in launched.items():
                counts[k] = counts.get(k, 0) + v
            models = _tp_models(cfg, sg, full, tp)
            again = _tp_emulated_step(models, data.x, graph, data.labels, mask, n_train,
                                      [[_slot(s) for s in r] for r in seeds])[:2]
            assert torch.equal(first[0], again[0]) and all(
                torch.equal(a, b) for a, b in zip(first[1], again[1])), \
                f"{fam} tp={tp}: two runs differ"
            assert bool(torch.isfinite(first[0]).all())
            print(f"[tp-emulated] {fam} tp={tp} bf16, dropouts {cfg.gcn.dropouts}: one "
                  f"training forward and backward, two runs bit-identical; launches "
                  f"{ {k: v for k, v in launched.items() if v} }")
            del models, first, again


GAT_CHUNK = 1_048_576  # edges a chunk of the streaming attention
GAT_SEGMENT_ARGS = ["model=gat", "backend=segment", "heads=2", "hidden_dims=32",
                    "dropouts=0.0,0.1", "attn_dropout=0.1"]


def check_attention_chunked(ds) -> int:
    """One GAT layer's attention on synth-reddit's whole COO (2 heads of 32,
    attention dropout 0.1 through a seed slot) streamed in chunks of
    ``GAT_CHUNK`` edges against the unchunked segment softmax with the same
    mask: f32 within rtol 1e-5 + 1e-5·max|ref|; bf16 within 2^-5 of each
    output's Σ_j α_ij·|hw_j| (the same attention in f32 over |hw|) +
    1e-5·max|ref|, because the two paths round at different points in bf16:
    the unchunked one rounds the denominator, α = w/den, α/keep and each
    α·hw to bf16, the chunked one w/keep and each w·hw, then divides its
    f32 sums; six roundings of at most 2^-9 of the terms, not of their sum
    (2^-5 leaves room for the exp's own bf16 rounding; a 3000-node CPU run
    reaches 0.0141); two runs bit-identical. Returns the number of chunks."""
    import torch

    from parallel_gcn_tpu_torch.data.graph import build_graph
    from parallel_gcn_tpu_torch.models.gat import GATModel, attend_chunked, edge_chunks

    graph = build_graph(ds.graph, device=torch.device("cuda"))
    n = graph.n_nodes
    t0 = time.perf_counter()
    chunks = edge_chunks(graph.row, graph.col, graph.val, n, n, GAT_CHUNK)
    torch.cuda.synchronize()
    t_chunks = time.perf_counter() - t0
    model = GATModel([torch.zeros(1)] * 6, (0.0, 0.0), heads=2, attn_dropout=0.1,
                     backend="segment")
    gen = torch.Generator().manual_seed(13)
    slot = _slot(0x5EED, torch.int32)  # an attention seed slot, as the trainer's
    for dtype, rtol in ((torch.float32, 1e-5), (torch.bfloat16, None)):
        s, t = (torch.randn((n, 2), generator=gen).to(dtype).cuda() for _ in range(2))
        hw = torch.randn((n, 2, 32), generator=gen).to(dtype).cuda()
        ref = model._attend_segment(graph, hw, s, t, slot, training=True)
        got = attend_chunked(chunks, s, t, hw, slot, 0.1)
        assert torch.equal(got, attend_chunked(chunks, s, t, hw, slot, 0.1)), "two runs differ"
        if dtype == torch.float32:
            err = _max_err(got, ref, rtol)
            tol = f"rtol {rtol}"
        else:
            scale = model._attend_segment(graph, hw.abs().float(), s.float(), t.float(), slot,
                                          training=True)
            diff = (got.float() - ref.float()).abs()
            assert bool((diff <= 2.0**-5 * scale + 1e-5 * ref.abs().max()).all()), \
                "bf16 chunked attention beyond the rounding bound"
            err = float(diff.max())
            tol = (f"within 2^-5 of Σα|hw|, at most "
                   f"{float((diff / scale.clamp(min=1e-30)).max()):.3e} of it")
            del scale, diff
        ms = timer.events_ms(lambda: attend_chunked(chunks, s, t, hw, slot, 0.1), 3)
        ref_ms = timer.events_ms(lambda: model._attend_segment(graph, hw, s, t, slot, True), 3)
        print(f"[main-gat-chunk] one layer's attention over {graph.n_edges_pad} edges in "
              f"{len(chunks)} chunks of {GAT_CHUNK} (their Segments built in {t_chunks:.2f} s), "
              f"{dtype}, attention dropout 0.1: against the unchunked softmax max_abs_err "
              f"{err:.3e} ({tol}), runs bit-identical; {ms:.3f} ms against {ref_ms:.3f}")
        del s, t, hw, ref, got
    n_chunks = len(chunks)
    del graph, chunks
    torch.cuda.empty_cache()
    return n_chunks


def phase_gat_chunk(ds) -> dict:
    """[main-gat-chunk]: ``cli.main`` of the segment GAT on synth-reddit with
    attention dropout, in ``mode=scan``, without and with
    ``edge_chunk=GAT_CHUNK``, each with the peak ``max_memory_allocated``
    above what this process held before it: the 10 train losses within
    1e-3 (the chunked sums round in another order; the masks are the same,
    K1's offset) and the chunked peak below the unchunked one. Returns the
    two runs' main-path records."""
    import torch

    argv = ["synth-reddit", *GAT_SEGMENT_ARGS, f"epochs={EPOCHS}"]
    runs = {}
    for tag, extra in (("main-gat-segment", []), ("main-gat-chunk", [f"edge_chunk={GAT_CHUNK}"])):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        runs[tag] = phase_main_path(tag, [*argv, *extra])
        runs[tag]["peak"] = torch.cuda.max_memory_allocated() - held
    plain, chunked = runs["main-gat-segment"], runs["main-gat-chunk"]
    diff = max(abs(a - b) for a, b in zip(plain["losses"], chunked["losses"]))
    print(f"[main-gat-chunk] segment GAT, attention dropout 0.1: train losses of the chunked "
          f"run within {diff:.3e} of the unchunked; peak max_memory_allocated above the "
          f"resident {chunked['peak']} bytes chunked against {plain['peak']} unchunked; "
          f"{chunked['ms']:.3f} ms/epoch against {plain['ms']:.3f}")
    assert diff <= 1e-3, f"chunked and unchunked train losses differ by {diff}"
    assert chunked["peak"] < plain["peak"], "the chunked run's peak memory is not lower"
    return runs


@contextlib.contextmanager
def warnings_ignored():
    """The partitions' UserWarnings (imbalance, a buffer that does not pay
    off) are expected here: the lines this script prints carry the sizes."""
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        yield


def phase_mesh_path(tag: str, args: list[str], ds, single: dict,
                    deterministic: bool = True, falls: bool = True) -> dict:
    """``fit_parallel`` of synth-reddit with ``args`` over the params file,
    ``n_devices=1`` (a world of one over NCCL), ``mode=scan`` with every
    launch count set to 0 just before it, then one more scan and
    ``mode=eager`` for the comparison (``_compare_modes``, this run the first
    of its two scans); checks the losses (as
    ``phase_main_path``) and returns the
    scan's launches, ms/epoch and captured epoch. Prints the halo
    used and both epochs beside ``single``'s (the single-card path's scan and
    eager ms/epoch of this run): the sharding tax."""
    import torch

    from parallel_gcn_tpu_torch.parallel.train_parallel import fit_parallel

    cfg = _config(args, EPOCHS)
    cfg.train.verbose = True
    buf = io.StringIO()
    _reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        res = fit_parallel(cfg, ds, n_devices=1, device="cuda")
    secs = time.perf_counter() - t0
    counts = _read_counts(res.replays, res.graph_launches)
    out = buf.getvalue()
    for line in out.splitlines():
        print(f"[{tag}] {line}")
    losses = [float(v) for v in res.history[:, 0]]
    assert len(losses) == EPOCHS, f"expected {EPOCHS} epochs, got {len(losses)}"
    assert res.replays == EPOCHS - 1, f"{res.replays} replays for {EPOCHS} epochs"
    assert all(math.isfinite(v) for v in losses), losses
    assert not falls or losses[-1] < losses[0], f"train loss did not fall: {losses}"
    assert math.isfinite(res.test_acc), res.test_acc
    halo = re.search(r"halo=(\S+),", out).group(1)
    ms = res.avg_epoch_time_s * 1e3

    def run(mode, verbose):
        cfg = _config([*args, f"mode={mode}"], EPOCHS)
        cfg.train.verbose = verbose
        return fit_parallel(cfg, ds, n_devices=1, device="cuda")

    # the run above is the first of the two scans compared
    eager_ms, scan_run = _compare_modes(tag, run, losses, ms, deterministic, first=res)
    per_replay = _per_replay(res.graph_launches)
    calls = {k: v for k, v in res.graph_launches.items()
             if k not in KERNEL_KEYS.values() and k not in HUB_KEYS.values()}
    single_eager = single.get("eager_ms")
    eager_tax = (f" against the single card's {single_eager:.3f} "
                 f"({eager_ms / single_eager:.3f}x)" if single_eager else "")
    print(f"[{tag}] fit_parallel {' '.join(args)}, n_devices=1 (NCCL world of one) on "
          f"{torch.cuda.get_device_name(0)} in {secs:.1f} s: halo {halo}; mode=scan "
          f"{ms:.3f} ms/epoch over the {res.replays} replays of epochs 2-{EPOCHS} (set-up "
          f"{res.setup_time_s:.3f} s) against the single-card scan's {single['ms']:.3f} "
          f"(sharding tax {ms / single['ms']:.3f}x); mode=eager {eager_ms:.3f}{eager_tax}; "
          f"train loss {losses[0]:.5f} -> {losses[-1]:.5f}, test_acc {res.test_acc:.5f}; "
          f"a replay launches {per_replay} and calls the collectives {calls}; launches "
          f"{counts}")
    return dict(counts=counts, ms=ms, per_replay=per_replay, collectives=calls,
                scan_run=scan_run)


def _config(args: list[str], epochs: int):
    from parallel_gcn_tpu_torch.config import (default_params_path, load_config,
                                               parse_override)

    overrides = dict(a.split("=", 1) for a in args)
    cfg = load_config(default_params_path("synth-reddit"),
                      {k: parse_override(v) for k, v in overrides.items()})
    cfg.gcn.epochs, cfg.train.verbose = epochs, False
    return cfg


def _profile_epochs(label: str, epoch) -> None:
    """Device time by op over 3 calls of ``epoch()`` (one eager training
    epoch that ends reading its metrics) after 2 warm-up calls and the
    profiler's warm-up call, against the host clock of the profiled calls
    (``utils.profiling``)."""
    for _ in range(2):
        epoch()
    reps = 3
    _, prof = profiling.profile_fn(epoch, reps=reps)
    profiling.report(f"{label}, mode=eager, {reps} epochs after 2 warm-up", prof)


# epochs of a profiled scan: epoch 1 (before the capture), 2 warm-up replays,
# 3 timed without the profiler, the profiler's warm-up replay and 3 under it,
# and as many again for a second trace when the first is short
SCAN_PROFILE_EPOCHS = 14


def _profile_scan(label: str, loop) -> None:
    """Device time by op over 3 replays of ``loop``'s captured epoch
    (``utils.profiling``, the trace held to the captured launches) against
    the host clock of 3 unprofiled replays ended by one sync: the scan
    epoch's idle share."""
    import torch

    loop.prepare()
    for _ in range(2):
        loop.epoch()
    torch.cuda.synchronize()
    reps = 3
    t0 = time.perf_counter()
    for _ in range(reps):
        loop.epoch()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / reps
    _, prof = profiling.profile_fn(loop.epoch, reps=reps, per_step=loop.graph_launches)
    profiling.report(f"{label}, mode=scan, {reps} replays (unprofiled host clock of 3 others)",
                     prof, host_ms)


def phase_profile(name: str, args: list[str], dds) -> None:
    """The single-card epoch of synth-reddit's configuration ``args`` under
    the profiler, eager (``_profile_epochs``) and as the scan's replay
    (``_profile_scan``)."""
    import torch

    from parallel_gcn_tpu_torch.models.gat import GATModel
    from parallel_gcn_tpu_torch.models.gcn import GCNModel
    from parallel_gcn_tpu_torch.optim import init_adam
    from parallel_gcn_tpu_torch.train import (build_model, epoch_seeds, make_epoch_step,
                                              make_scan_loop, preaggregate_input)

    label = f"synth-reddit {name} ({' '.join(args)})"
    for mode in ("eager", "scan"):
        cfg = _config(args, SCAN_PROFILE_EPOCHS)
        model = build_model(cfg, dds)
        gat = isinstance(model, GATModel)
        mdds = (preaggregate_input(model, dds)
                if cfg.tpu.input_preagg and isinstance(model, GCNModel) else dds)
        opt = init_adam(list(model.weights))
        gen = torch.Generator().manual_seed(cfg.tpu.seed)
        if mode == "scan":
            _profile_scan(label, make_scan_loop(model, cfg, mdds, opt, gen))
        else:
            step = make_epoch_step(model, cfg, mdds)
            _profile_epochs(label, lambda: step(
                opt, epoch_seeds(gen, model.n_layers, attention=gat)).tolist())


def phase_profile_mesh(name: str, args: list[str], ds) -> None:
    """The mesh epoch (a world of one over NCCL) of synth-reddit's
    configuration ``args`` under the profiler, eager and as the scan's
    replay."""
    import torch

    from parallel_gcn_tpu_torch.optim import init_adam
    from parallel_gcn_tpu_torch.parallel import collectives
    from parallel_gcn_tpu_torch.parallel import train_parallel as tpl
    from parallel_gcn_tpu_torch.train import epoch_seeds

    cfg = _config(args, SCAN_PROFILE_EPOCHS)
    gat = cfg.gcn.model == "gat"
    dev = torch.device("cuda", 0)
    label = f"synth-reddit mesh {name} ({' '.join(args)}), n_devices=1"
    with collectives.world(1, dev):
        run = tpl.build_rank(cfg, ds, 0, 1, cfg.tpu.halo, dev)
        step = tpl.make_parallel_epoch_step(cfg, run.model, run.graph, run.data,
                                            run.split_counts, *tpl.preagg_inputs(cfg, run))
        opt = init_adam(list(run.model.weights))
        gen = torch.Generator().manual_seed(cfg.tpu.seed)
        n_layers = run.model.n_layers
        _profile_epochs(label, lambda: step(
            opt, epoch_seeds(gen, n_layers, attention=gat)).tolist())
        opt = init_adam(list(run.model.weights))
        loop = tpl.make_parallel_scan_loop(cfg, run, opt, torch.Generator().manual_seed(
            cfg.tpu.seed), *tpl.preagg_inputs(cfg, run))
        _profile_scan(label, loop)


def check_reference() -> None:
    """A small graph through the port's training on the card and on the CPU
    (plain versions), as a GCN and as a GAT on the tile backend with feature
    and attention dropout, with the fused kernels, and as SAGE and GIN-0
    (learning rate 0.01, dropout 0.3 at both layers) over tiles and a COO
    residual (kernel (a)): metrics must agree. Every dropout mask (K1's
    Philox, which K10 shares, and the attention hash) depends only on seeds
    and indices."""
    import torch

    from parallel_gcn_tpu_torch.config import Config
    from parallel_gcn_tpu_torch.data.parser import to_device
    from parallel_gcn_tpu_torch.data.synthetic import make_synthetic_dataset
    from parallel_gcn_tpu_torch.ops import (cuda_bcsr, cuda_ce, cuda_dropout, cuda_fused,
                                            cuda_segment, tile_attention)
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
    gcn_fused = Config()
    gcn_fused.gcn.hidden_dims, gcn_fused.gcn.dropouts = (32,), (0.3, 0.3)
    gcn_fused.tpu.ce_impl, gcn_fused.tpu.fuse_dropout_matmul = "pallas", True
    gcn_fused.tpu.input_preagg = False
    gat_ce = Config()
    gat_ce.gcn.model, gat_ce.gcn.heads, gat_ce.gcn.hidden_dims = "gat", 2, (8,)
    gat_ce.gcn.dropouts, gat_ce.gcn.attn_dropout = (0.0, 0.3), 0.3
    gat_ce.tpu.ce_impl = "pallas"
    sage, gin = Config(), Config()
    sage.gcn.model, gin.gcn.model, gin.gcn.gin_eps = "sage", "gin", 0.0
    for cfg in (sage, gin):
        cfg.gcn.hidden_dims, cfg.gcn.dropouts = (32,), (0.3, 0.3)
    # the launch counts each run must move on the card and leave alone on the CPU
    watch = {"GAT": [(tile_attention.launches, "gat_fwd")],
             "GCN fused": [(cuda_ce.launches, "ce_train"), (cuda_ce.launches, "ce_eval"),
                           (cuda_fused.launches, "fused_fwd"),
                           (cuda_fused.launches, "fused_dw"), (cuda_fused.launches, "fused_dx")],
             "GAT pallas CE": [(tile_attention.launches, "gat_fwd"),
                               (cuda_ce.launches, "ce_train"), (cuda_ce.launches, "ce_eval")]}
    # (f32 compute: K4's f32 body)
    agg = [(cuda_bcsr.launches, "bcsr_scaled_f32"), (cuda_segment.launches, "gather_sum"),
           (cuda_dropout.launches, "dropout"), (cuda_dropout.launches, "relu_dropout")]
    watch["SAGE"] = watch["GIN"] = agg
    # SAGE and GIN pack only the tiles of 400 edges or more: 16 tiles and a
    # residual of 36566 edges, so both K4 and kernel (a) carry the sums
    for name, cfg, min_nnz in (("GCN", gcn, 0), ("GAT", gat, 0), ("GCN fused", gcn_fused, 0),
                               ("GAT pallas CE", gat_ce, 0), ("SAGE", sage, 400),
                               ("GIN", gin, 400)):
        cfg.gcn.epochs, cfg.train.verbose = 3, False
        hist = {}
        for dev in ("cuda", "cpu"):
            dds = to_device(ds, device=torch.device(dev), hybrid=True, tile_dtype="int8",
                            tile_size=128, tile_cols=256, min_tile_nnz=min_nnz)
            before = [d[k] for d, k in watch.get(name, [])]
            hist[dev] = fit(cfg, dds).history
            for (d, k), b in zip(watch.get(name, []), before):
                assert (d[k] > b) == (dev == "cuda"), f"{name}: {k} launched on {dev}: {d[k] - b}"
        diff = float(abs(hist["cuda"] - hist["cpu"]).max())
        print(f"[reference] {name}: 2000-node hybrid int8 graph (min_tile_nnz "
              f"{min_nnz or 'default'}), 3 epochs: card vs CPU plain max metric diff "
              f"{diff:.3e}, train loss {hist['cuda'][0, 0]:.5f} -> {hist['cuda'][-1, 0]:.5f}")
        assert diff < 2e-4, f"{name}: card and CPU trajectories differ by {diff}"


# each kernel's launch-count key in its wrapper's ``launches`` dict
KERNEL_KEYS = {"K1": "dropout", "K2": "relu_dropout", "K3": "bcsr", "K4": "bcsr_scaled",
               "K5": "gat_fwd", "K6": "gat_bwd", "K3 rect": "bcsr_rect",
               "K5 rect": "gat_fwd_rect", "K7 row": "gat_bwd_rect_row",
               "K7 col": "gat_bwd_rect_col", "K9 train": "ce_train", "K9 eval": "ce_eval",
               "K10 fwd": "fused_fwd", "K10 dW": "fused_dw", "K10 dX": "fused_dx",
               "K8": "sddmm", "ordered gather_sum": "gather_sum",
               "ordered segment_sum": "segment_sum", "K1 lanes": "dropout_lanes",
               "K2 lanes": "relu_dropout_lanes", "K2 lanes bwd": "relu_dropout_lanes_bwd",
               "K10 fwd lanes": "fused_fwd_lanes",
               "K10 dW lanes": "fused_dw_lanes", "K10 dX lanes": "fused_dx_lanes",
               # the tile SpMM's f32 body over the live-entry index
               "K4 f32": "bcsr_scaled_f32", "K3 f32": "bcsr_f32",
               "K3 rect f32": "bcsr_rect_f32",
               # K4's wide bf16 body (SAGE's and GIN's widths)
               "K4 wide": "bcsr_scaled_wide"}
# the ordered sums' hub kernels (launched beside the walk kernel by a call
# whose work list has hubs), counted apart from KERNEL_KEYS so the launches
# a replay stay those of the walk kernels
HUB_KEYS = {"ordered gather_sum hub": "gather_sum_hub",
            "ordered segment_sum hub": "segment_sum_hub"}


def _reset_counts() -> None:
    from parallel_gcn_tpu_torch.ops import (cuda_bcsr, cuda_ce, cuda_dropout, cuda_fused,
                                            cuda_sddmm, cuda_segment, tile_attention)

    for d in (cuda_dropout.launches, cuda_bcsr.launches, tile_attention.launches,
              cuda_ce.launches, cuda_fused.launches, cuda_sddmm.launches,
              cuda_segment.launches):
        for k in d:
            d[k] = 0


def _read_counts(replays: int = 0, per_replay: dict | None = None) -> dict:
    """Every kernel's launches since ``_reset_counts``. A wrapper counts a
    launch where it enqueues it, so a captured epoch counts once, at its
    capture; with ``replays`` replays of a graph whose capture counted
    ``per_replay`` (wrapper keys), the launches are the counts plus
    ``replays − 1`` times the graph's."""
    from parallel_gcn_tpu_torch.scan import launch_counts

    counts, per_replay = launch_counts(), per_replay or {}
    return {k: counts[key] + max(replays - 1, 0) * per_replay.get(key, 0)
            for k, key in {**KERNEL_KEYS, **HUB_KEYS}.items()}


def _per_replay(graph_launches: dict) -> dict:
    """The captured epoch's launches by kernel name (nonzero only)."""
    return {k: graph_launches[key] for k, key in KERNEL_KEYS.items() if key in graph_launches}


def phase_main_path(tag: str, argv: list[str], falls: bool = True) -> dict:
    """``cli.main(argv)`` (``mode=scan``, the default) with every launch
    count set to 0 just before it; checks the run (``_check_run``)."""
    from parallel_gcn_tpu_torch import cli

    buf = io.StringIO()
    _reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    secs = time.perf_counter() - t0
    assert rc == 0, f"cli.main returned {rc}:\n{buf.getvalue()}"
    return _check_run(tag, f"{' '.join(argv)} through cli.main", buf.getvalue(), secs,
                      EPOCHS, falls)


def _check_run(tag: str, what: str, out: str, secs: float, epochs: int,
               falls: bool = True) -> dict:
    """Prints a scan run's output ``out`` under ``[tag]``, checks the losses
    (finite, and with ``falls`` the last below the first) and returns the
    launches since the counts were set to 0 (the capture's counted once per
    replay), the train losses, the scan's ms/epoch over the replays of
    epochs 2 to the last, its set-up seconds and the captured epoch's
    launches."""
    for line in out.splitlines():
        print(f"[{tag}] {line}")
    scan = re.search(r"^scan: epoch 1 and the capture in (\S+) s, (\d+) replays of one CUDA "
                     r"graph, (\S+) ms/epoch; launches a replay: (.*)$", out, re.M)
    assert scan, "no CUDA graph: the scan did not capture its epoch"
    setup_s, replays, ms = float(scan.group(1)), int(scan.group(2)), float(scan.group(3))
    per_replay = _per_replay(json.loads(scan.group(4)))
    counts = _read_counts(replays, json.loads(scan.group(4)))
    history = [tuple(map(float, m)) for m in re.findall(
        r"^epoch=\d+ train_loss=(\S+) train_acc=(\S+) val_loss=(\S+) val_acc=(\S+)$", out, re.M)]
    losses = [row[0] for row in history]
    assert len(losses) == epochs, f"expected {epochs} epoch lines, got {len(losses)}"
    assert replays == epochs - 1, f"{replays} replays for {epochs} epochs"
    assert all(math.isfinite(v) for v in losses), losses
    assert not falls or losses[-1] < losses[0], f"train loss did not fall: {losses}"
    test_acc = float(re.search(r"test_acc=(\S+)", out).group(1))
    assert math.isfinite(test_acc), test_acc
    preagg = re.search(r"^setup: the input's pre-aggregation .* in (\S+) s$", out, re.M)
    print(f"[{tag}] {what} (mode=scan) in {secs:.1f} s: "
          f"{ms:.3f} ms/epoch over the {replays} replays of epochs 2-{epochs}, set-up (epoch 1 "
          f"and the capture) {setup_s:.3f} s, train loss {losses[0]:.5f} -> {losses[-1]:.5f}, "
          f"test_acc {test_acc:.5f}, launches a replay {per_replay}, launches {counts}")
    return dict(counts=counts, losses=losses, history=history, ms=ms, setup_s=setup_s,
                per_replay=per_replay, test_acc=test_acc,
                preagg_s=float(preagg.group(1)) if preagg else None)


def phase_main_gcn_f32(dds) -> dict:
    """``[main-gcn-f32]``: synth-reddit's GCN through ``train.fit`` on this
    script's copy of the dataset at ``compute_dtype=float32`` (the config's
    default, the reference's own precision) in ``mode=scan`` for ``EPOCHS``
    epochs, the launch counts set to 0 just before it: every aggregation on
    K4's f32 body over the live-entry index (built at the run's set-up
    pre-aggregation: a new pack object). Prints ms/epoch, the pre-aggregation's
    seconds and the f32 K4 launches; the loss must fall."""
    import dataclasses

    from parallel_gcn_tpu_torch.train import fit

    # the pack as a user's run has it: no index built yet
    pack = dataclasses.replace(dds.graph.bcsr)
    dds = dataclasses.replace(dds, graph=dataclasses.replace(dds.graph, bcsr=pack))
    cfg = _config(["compute_dtype=float32"], EPOCHS)
    buf = io.StringIO()
    _reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        fit(cfg, dds, verbose=True)
    out = _check_run("main-gcn-f32", "synth-reddit compute_dtype=float32 through train.fit",
                     buf.getvalue(), time.perf_counter() - t0, EPOCHS)
    # a replay: the deferred schedule (K2 once; K4 for the stacked forward
    # at 82 columns and the backward at 41, each with the residual's
    # gather-sum), all in f32; plus the pre-aggregation, the final val and
    # the test eval
    assert out["per_replay"] == {"K2": 1, "K4 f32": 2, "ordered gather_sum": 2}, \
        out["per_replay"]
    assert (out["counts"]["K4 f32"], out["counts"]["K4"], out["counts"]["K2"]) == (
        2 * EPOCHS + 3, 0, EPOCHS), out
    print(f"[main-gcn-f32] {out['ms']:.3f} ms/epoch (scan, float32), the set-up "
          f"pre-aggregation Â·X at 602 columns in {out['preagg_s']:.4f} s, K4 f32 launches "
          f"{out['counts']['K4 f32']}, train loss {out['losses'][0]:.5f} -> "
          f"{out['losses'][-1]:.5f}")
    return out


def _steady_ms(out: str) -> float:
    """Mean ms of the eager loop's epochs 2 to the last, from its lines."""
    steady = [float(t) * 1e3 for t in re.findall(r"^epoch=\d+ .* time=(\S+)$", out, re.M)][1:]
    return sum(steady) / len(steady)


def _deterministic(fn):
    """``fn()`` with ``torch.use_deterministic_algorithms`` on (warn only),
    PyTorch's deterministic kernels where it has them. Returns (fn's result,
    the ops PyTorch warned have no deterministic kernel)."""
    import warnings

    import torch

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            out = fn()
        finally:
            torch.use_deterministic_algorithms(False)
    ops = sorted({str(w.message).split(" does not have")[0][:90] for w in caught
                  if "deterministic" in str(w.message)})
    return out, ops


def _same_run(a, b) -> bool:
    """Two ``FitResult``s bit for bit: history, test metrics, weights."""
    import numpy as np
    import torch

    return (np.array_equal(a.history, b.history)
            and (a.test_loss, a.test_acc) == (b.test_loss, b.test_acc)
            and all(torch.equal(x, y) for x, y in zip(a.weights, b.weights)))


def _compare_modes(tag: str, run, scan_losses, scan_ms: float, deterministic: bool = True,
                   first=None):
    """``run(mode, verbose)`` (a training run's ``FitResult``) twice in
    ``mode=scan`` (once where ``first``, the path's own scan run, is given:
    it is the other) and once in ``mode=eager``, without PyTorch's
    deterministic algorithms: the two scans and the eager run must be the
    same run bit for bit (the ordered residual sums leave no atomics in an
    epoch), and the scan's train losses those ``cli.main`` printed (5
    decimals). Then, with ``deterministic``, both modes again under
    ``_deterministic``, whose train-loss histories must agree within 1e-4;
    the mesh paths leave it out for the smoke's time limit (it costs two
    more runs, and their single-card paths have it). Returns (the eager ms/epoch, epochs 2 to the last, from its
    lines; the first scan run)."""
    import numpy as np

    scan_a = run("scan", False) if first is None else first
    scan_b = run("scan", False)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        eager = run("eager", True)
    ms = _steady_ms(buf.getvalue())
    scans_equal, eager_equal = _same_run(scan_a, scan_b), _same_run(scan_a, eager)
    eager_diff = float(abs(scan_a.history - eager.history).max())
    printed = float(np.abs(np.asarray(scan_losses) - scan_a.history[:, 0]).max())
    print(f"[{tag}] mode=eager: {ms:.3f} ms/epoch over epochs 2-{EPOCHS} against the scan's "
          f"{scan_ms:.3f}; without deterministic algorithms two scan runs are bit-equal: "
          f"{scans_equal}, scan and eager bit-equal: {eager_equal} (histories differ by "
          f"{eager_diff:.3e})")
    assert len(eager.history) == EPOCHS and scan_a.replays == EPOCHS - 1, scan_a.replays
    assert printed <= 6e-6, f"the cli's scan and this scan differ by {printed} in train loss"
    assert scans_equal, "two scan runs differ"
    assert eager_equal, f"scan and eager differ (histories by {eager_diff})"
    if deterministic:
        (det_scan, det_eager), ops = _deterministic(lambda: (run("scan", False),
                                                             run("eager", False)))
        diff = float(abs(det_scan.history - det_eager.history).max())
        loss_diff = float(abs(det_scan.history[:, 0] - det_eager.history[:, 0]).max())
        print(f"[{tag}] with deterministic algorithms (the ops without a deterministic "
              f"kernel: {ops or 'none'}) scan and eager histories differ by {diff:.3e}, train "
              f"losses by {loss_diff:.3e} (scan replays {det_scan.replays}), the scan bit-equal "
              f"to the one without them: {_same_run(det_scan, scan_a)}")
        assert len(det_eager.history) == EPOCHS, len(det_eager.history)
        assert det_scan.replays == EPOCHS - 1, det_scan.replays
        assert loss_diff <= 1e-4, f"scan and eager train losses differ by {loss_diff}"
    return ms, scan_a


def phase_eager_compare(tag: str, args: list[str], dds, scan: dict):
    """The scan main path's configuration through ``train.fit`` on ``dds``
    (``_compare_modes``). Returns (the eager ms/epoch, the scan run)."""
    from parallel_gcn_tpu_torch.train import fit

    def run(mode, verbose):
        cfg = _config([*args, f"mode={mode}"], EPOCHS)
        cfg.train.verbose = verbose
        return fit(cfg, dds)

    return _compare_modes(tag, run, scan["losses"], scan["ms"])


@contextlib.contextmanager
def _recorded(module, name: str):
    """Record what ``module.name`` returns while the block runs (the
    ``FitResult`` of each run the CLI starts), in the yielded list."""
    results: list = []
    orig = getattr(module, name)

    def wrapped(*args, **kwargs):
        results.append(orig(*args, **kwargs))
        return results[-1]

    setattr(module, name, wrapped)
    try:
        yield results
    finally:
        setattr(module, name, orig)


@contextlib.contextmanager
def _torchrun_world_of_one():
    """The environment torchrun gives a world of one (a free port on
    localhost), so that ``cli.main`` takes the mesh path at
    ``n_devices=1``."""
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    env = dict(WORLD_SIZE="1", RANK="0", LOCAL_RANK="0", MASTER_ADDR="localhost",
               MASTER_PORT=str(port))
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _cli(tag: str, argv: list[str]) -> str:
    from parallel_gcn_tpu_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    out = buf.getvalue()
    for line in out.splitlines():
        if not line.startswith("epoch="):
            print(f"[{tag}] {line}")
    assert rc == 0, f"cli.main returned {rc}"
    return out


def phase_resume(tag: str, args: list[str], unchunked, unchunked_ms: float,
                 mesh: bool = False) -> dict:
    """Through ``cli.main``: synth-reddit with ``args`` for 10 epochs with
    early stopping off and a checkpoint every 5 epochs, then resumed from
    ckpt_000005.npz. The whole run must be ``unchunked`` (the same
    configuration's scan without checkpoints, ``_compare_modes``) bit for
    bit, and the resumed run its epochs 6-10, test metrics and final
    weights. ``mesh``: the mesh trainer at ``n_devices=1`` (a torchrun
    world of one). Prints the seconds to write and to load a checkpoint and
    both runs' ms/epoch."""
    import tempfile

    import numpy as np
    import torch

    from parallel_gcn_tpu_torch import train
    from parallel_gcn_tpu_torch.parallel import train_parallel

    module, name = (train_parallel, "fit_parallel") if mesh else (train, "fit")
    argv = ["synth-reddit", *args, f"epochs={EPOCHS}", "early_stopping=0"]
    world = _torchrun_world_of_one if mesh else contextlib.nullcontext
    with tempfile.TemporaryDirectory() as tmp, _recorded(module, name) as runs:
        ck = os.path.join(tmp, "ck")
        with world():
            _cli(tag, [*argv, "checkpoint_every=5", f"checkpoint_dir={ck}"])
        files = sorted(os.listdir(ck))
        assert files == ["ckpt_000005.npz", "ckpt_final.npz"], files
        with world():
            out = _cli(tag, [*argv, f"resume_from={os.path.join(ck, 'ckpt_000005.npz')}"])
    whole, resumed = runs
    load_s = float(re.search(r"^resumed from \S+ at epoch 5 \(loaded in (\S+) s\)$", out,
                             re.M).group(1))
    assert resumed.start_epoch == 5 and resumed.epochs_run == EPOCHS - 5, resumed.epochs_run
    assert _same_run(whole, unchunked), f"{tag}: the chunked run differs from the unchunked"
    tail = np.array_equal(resumed.history, whole.history[5:])
    final = ((resumed.test_loss, resumed.test_acc) == (whole.test_loss, whole.test_acc)
             and all(torch.equal(a, b) for a, b in zip(resumed.weights, whole.weights)))
    print(f"[{tag}] {' '.join(args) or 'GCN'} through cli.main{' (a world of one)' if mesh else ''}:"
          f" 10 epochs with checkpoint_every=5 bit-equal to the unchunked scan; resumed from "
          f"ckpt_000005.npz, epochs 6-10 bit-equal: {tail}, test metrics and final weights "
          f"bit-equal: {final}; checkpoint written in {whole.checkpoint_s[0]:.3f} s (ckpt_final "
          f"{whole.checkpoint_s[-1]:.3f} s), loaded in {load_s:.3f} s; the chunked run "
          f"{whole.avg_epoch_time_s * 1e3:.3f} ms/epoch against the unchunked "
          f"{unchunked_ms:.3f}, the resumed {resumed.avg_epoch_time_s * 1e3:.3f}")
    assert tail and final, f"{tag}: the resumed run differs from the uninterrupted one"
    return dict(write_s=whole.checkpoint_s[0], load_s=load_s,
                chunked_ms=whole.avg_epoch_time_s * 1e3)


SEED_LANES = 4  # [main-seeds]


def _seed_batch(tag: str, cfg, dds, lanes: int, solo_lanes, exact: bool) -> dict:
    """``seeds.fit_seeds`` of ``cfg`` over ``lanes`` seeds from ``cfg.tpu.seed``
    (``mode=scan``: epoch 1, the capture, replays), with every launch count
    set to 0 just before it, then ``train.fit`` of each lane in
    ``solo_lanes`` with its seed: the lane must be its solo run, bit for bit
    with ``exact`` (history, test metrics, weights), or with the same epochs,
    histories within 1e-6 and the test metrics and final weights within
    1e-5."""
    import copy

    import numpy as np
    import torch

    from parallel_gcn_tpu_torch.seeds import fit_seeds
    from parallel_gcn_tpu_torch.train import fit

    seeds = [cfg.tpu.seed + s for s in range(lanes)]
    _reset_counts()
    t0 = time.perf_counter()
    res = fit_seeds(cfg, dds, seeds)
    secs = time.perf_counter() - t0
    counts = _read_counts(res.replays, res.graph_launches)
    per_replay = _per_replay(res.graph_launches)
    solo_ms, diffs = [], []
    for s in solo_lanes:
        solo_cfg = copy.deepcopy(cfg)
        solo_cfg.tpu.seed = seeds[s]
        solo = fit(solo_cfg, dds)
        solo_ms.append(solo.avg_epoch_time_s * 1e3)
        assert res.epochs_run[s] == solo.epochs_run, \
            f"[{tag}] lane {s} ran {res.epochs_run[s]} epochs, its solo run {solo.epochs_run}"
        test = (float(res.test_loss[s]), float(res.test_acc[s]))
        if exact:
            same = (np.array_equal(res.history[s], solo.history)
                    and test == (solo.test_loss, solo.test_acc)
                    and all(torch.equal(a, b) for a, b in zip(res.weights[s], solo.weights)))
            assert same, f"[{tag}] lane {s} (seed {seeds[s]}) is not its solo run bit for bit"
        else:
            diff = (float(abs(res.history[s] - solo.history).max()),
                    max(abs(test[0] - solo.test_loss), abs(test[1] - solo.test_acc)),
                    max(float((a - b).abs().max()) for a, b in zip(res.weights[s],
                                                                  solo.weights)))
            diffs.append(diff)
            assert diff[0] <= 1e-6, f"[{tag}] lane {s}'s history differs from its solo run's " \
                                    f"by {diff[0]}"
            # the test eval and the weights after the last epoch: 1e-5
            assert max(diff[1:]) <= 1e-5, f"[{tag}] lane {s}'s test metrics and weights differ " \
                                          f"from its solo run's by {diff[1:]}"
    ms, one = res.avg_epoch_time_s * 1e3, sum(solo_ms) / len(solo_ms)
    print(f"[{tag}] {lanes} lanes through fit_seeds (mode=scan) in {secs:.1f} s: {ms:.3f} "
          f"ms/epoch over {res.replays} replays, set-up {res.setup_time_s:.3f} s; one solo run "
          f"{one:.3f} ms/epoch ({lanes} solo runs {lanes * one:.3f}: the batch takes "
          f"{ms / (lanes * one):.3f} of them); epochs run {res.epochs_run}; lanes "
          f"{list(solo_lanes)} equal to their solo runs "
          + ("bit for bit (history, test metrics, weights)" if exact else
             "in epochs, histories within {:.3e}, test metrics {:.3e}, weights {:.3e}".format(
                 *(max(d[i] for d in diffs) for i in range(3))))
          + f"; test_acc {[round(float(a), 5) for a in res.test_acc]}; launches a replay "
            f"{per_replay}, launches {counts}")
    return dict(counts=counts, per_replay=per_replay, ms=ms, solo_ms=one, result=res)


def phase_main_seeds(dds) -> dict:
    """``[main-seeds]``: synth-reddit's GCN at full width (602 -> 600 -> 41,
    hybrid int8 tiles, bf16) as a batch of ``SEED_LANES`` seeds, ``EPOCHS``
    epochs, each lane held bit for bit against its solo ``fit``; then the
    batch's replay under the profiler."""
    from parallel_gcn_tpu_torch.seeds import seed_run

    out = _seed_batch("main-seeds", _config([], EPOCHS), dds, SEED_LANES,
                      range(SEED_LANES), exact=True)
    cfg = _config([], SCAN_PROFILE_EPOCHS)
    run = seed_run(cfg, dds, [cfg.tpu.seed + s for s in range(SEED_LANES)])
    _profile_scan(f"synth-reddit GCN, {SEED_LANES} seed lanes", run.loop)
    return out


# the seed batches of the other families and of the fused GCN at
# synth-reddit's full width: [tag, the configuration's arguments, the lanes
# held against their solo runs]
SEED_FAMILIES = (("seeds-sage", SAGE_ARGS, range(SEED_LANES)),
                 ("seeds-gin", GIN_ARGS, range(SEED_LANES)),
                 ("seeds-gat", [*GAT_ARGS, "attn_dropout=0.1"], range(SEED_LANES)),
                 ("seeds-fused", FUSED_ARGS, range(SEED_LANES)))


def phase_seeds_family(tag: str, args: list[str], dds, solo_lanes) -> dict:
    """``[seeds-sage]``, ``[seeds-gin]``, ``[seeds-gat]``, ``[seeds-fused]``:
    synth-reddit's configuration ``args`` at full width as ``SEED_LANES``
    lanes for ``EPOCHS`` epochs, each lane of ``solo_lanes`` bit for bit its
    solo ``fit``; then the batch's replay under the profiler."""
    from parallel_gcn_tpu_torch.seeds import seed_run

    out = _seed_batch(tag, _config(args, EPOCHS), dds, SEED_LANES, solo_lanes, exact=True)
    cfg = _config(args, SCAN_PROFILE_EPOCHS)
    run = seed_run(cfg, dds, [cfg.tpu.seed + s for s in range(SEED_LANES)])
    _profile_scan(f"synth-reddit {' '.join(args)}, {SEED_LANES} seed lanes", run.loop)
    return out


def phase_seeds_medium() -> dict:
    """``[seeds-medium]``: synth-medium (``backend=segment``: the flat COO's
    ordered gather-sum at 16·64 columns) as 16 lanes, 30 epochs, lanes 0, 5,
    10 and 15 held bit for bit against their solo runs."""
    import torch

    from parallel_gcn_tpu_torch.config import default_params_path, load_config
    from parallel_gcn_tpu_torch.data.parser import prepare_device_dataset

    cfg = load_config(default_params_path("synth-medium"), dict(epochs=30, verbose=False))
    t0 = time.perf_counter()
    _, dds = prepare_device_dataset(cfg, "synth-medium", torch.device("cuda"))
    print(f"[seeds-medium] synth-medium generated in {time.perf_counter() - t0:.1f} s "
          f"(backend={cfg.tpu.backend}, hidden {cfg.gcn.hidden_dims}, dropouts "
          f"{cfg.gcn.dropouts}, {cfg.tpu.compute_dtype})")
    return _seed_batch("seeds-medium", cfg, dds, 16, (0, 5, 10, 15), exact=True)


def phase_seeds_stop(fused: bool = False) -> dict:
    """``[seeds-stop]``: a generated cora-sized graph (``DENSE_SETS``, with a
    feature signal of 2.0 so that lanes stop at different epochs) on the
    dense backend in f32, ``parameters_cora.txt``'s width 72 and dropouts
    0.4 / 0.2 (K1 over 8 lanes of 1,433 features), 8 lanes with
    ``early_stopping=5`` and at most 200 epochs: each lane stops where its
    solo run stops, its history within 1e-6 (Â·[N, 8·72] is one cuBLAS
    product whose algorithm follows the shape, so bits are not asked for).
    ``[seeds-stop-fused]`` (``fused``): the same with
    ``fuse_dropout_matmul=true``, the f32 laned K10 at both layers (layer
    0 over the shared input)."""
    import torch

    from parallel_gcn_tpu_torch.config import default_params_path, load_config
    from parallel_gcn_tpu_torch.data.parser import to_device
    from parallel_gcn_tpu_torch.data.synthetic import make_synthetic_dataset

    ds = make_synthetic_dataset("cora-sized", **DENSE_SETS["cora"], feature_signal=2.0)
    dds = to_device(ds, device=torch.device("cuda"), dense=True)
    cfg = load_config(default_params_path("cora"), dict(
        epochs=200, early_stopping=5, compute_dtype="float32", backend="dense", verbose=False,
        fuse_dropout_matmul=fused))
    out = _seed_batch("seeds-stop-fused" if fused else "seeds-stop", cfg, dds, 8, range(8),
                      exact=False)
    runs = out["result"].epochs_run
    assert len(set(runs)) > 1 and max(runs) < 200, f"the lanes stopped at {runs}"
    return out


def phase_remat(tag: str, args: list[str], dds, unremat) -> dict:
    """``train.fit`` of synth-reddit with ``args`` in ``mode=scan`` without
    and with ``remat=true``, every launch count set to 0 just before the
    remat run: the two runs and ``unremat`` (the same configuration's scan
    of ``_compare_modes``) must be one run bit for bit (history, test
    metrics, weights). Prints the peak of ``torch.cuda.max_memory_allocated``
    over each run (the dataset resident in both), both ms/epoch and the
    remat run's launches a replay (the recompute's included)."""
    import torch

    from parallel_gcn_tpu_torch.train import fit

    runs, peaks = {}, {}
    for remat in (False, True):
        cfg = _config([*args, f"remat={str(remat).lower()}"], EPOCHS)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        if remat:
            _reset_counts()
        runs[remat] = fit(cfg, dds)
        torch.cuda.synchronize()
        peaks[remat] = (torch.cuda.max_memory_allocated(), base)
    res = runs[True]
    counts = _read_counts(res.replays, res.graph_launches)
    same = _same_run(res, runs[False]) and _same_run(res, unremat)
    mib = 2.0**20
    print(f"[{tag}] {' '.join(args) or 'GCN'} remat=true (train.fit, mode=scan) on "
          f"{torch.cuda.get_device_name(0)}: bit-equal to the run without remat (history, test "
          f"metrics, weights): {same}; peak max_memory_allocated {peaks[True][0] / mib:.1f} MiB "
          f"against {peaks[False][0] / mib:.1f} without remat ({peaks[True][0] - peaks[True][1]} "
          f"and {peaks[False][0] - peaks[False][1]} bytes above the resident "
          f"{peaks[False][1] / mib:.1f} MiB); {res.avg_epoch_time_s * 1e3:.3f} ms/epoch against "
          f"{runs[False].avg_epoch_time_s * 1e3:.3f}; a replay launches "
          f"{_per_replay(res.graph_launches)}, launches {counts}")
    assert same, f"{tag}: remat changed the run"
    return dict(counts=counts, peak=peaks[True][0], peak_plain=peaks[False][0],
                ms=res.avg_epoch_time_s * 1e3, ms_plain=runs[False].avg_epoch_time_s * 1e3,
                per_replay=_per_replay(res.graph_launches))


def build_native() -> float:
    """Builds (or loads) the native loader, ``csrc/loader.cpp`` by g++ with
    OpenMP; a failed build fails the run. Returns the seconds."""
    from parallel_gcn_tpu_torch.data import native

    t0 = time.perf_counter()
    native.load_library()
    secs = time.perf_counter() - t0
    print(f"[native] {os.path.basename(native.library_path())} built and loaded in {secs:.2f} s "
          f"(g++ {' '.join(native.FLAGS)})", flush=True)
    return secs


def _write_reference_files(directory: str, name: str, ds) -> None:
    """``ds`` as the reference's ``.graph`` (neighbours without the
    self-loop), ``.svmlight`` and ``.split`` files."""
    import numpy as np

    g, f = ds.graph, ds.feature_csr
    with open(os.path.join(directory, f"{name}.graph"), "w") as fh:
        for i in range(g.n_rows):
            nb = g.indices[g.indptr[i]:g.indptr[i + 1]]
            fh.write(" ".join(map(str, nb[nb != i].tolist())) + "\n")
    with open(os.path.join(directory, f"{name}.svmlight"), "w") as fh:
        for i in range(f.n_rows):
            a, b = f.indptr[i], f.indptr[i + 1]
            fh.write(f"{ds.labels[i]} " + " ".join(
                f"{j}:{v:.7g}" for j, v in zip(f.indices[a:b].tolist(), f.values[a:b].tolist()))
                + "\n")
    np.savetxt(os.path.join(directory, f"{name}.split"), ds.split, fmt="%d")


def phase_native(ds_host) -> None:
    """``[native]``: the native sweep's labels against the numpy sweep's on
    synth-reddit's hub-excluded edges (equal, both timed), and
    ``load_dataset_native`` against the numpy reader on synth-medium written
    as reference-format files to a temporary directory (equal, both timed)."""
    import tempfile

    import numpy as np

    from parallel_gcn_tpu_torch.data import native, parser, reorder
    from parallel_gcn_tpu_torch.data.synthetic import make_synthetic_dataset

    rows, cols, _ = reorder.hub_excluded_edges(ds_host.graph, 1024)
    n = ds_host.graph.n_rows
    t0 = time.perf_counter()
    fast = native.community_labels_native(rows, cols, n, 8)
    t1 = time.perf_counter()
    slow = reorder._propagate_labels_numpy(rows, cols, n, 8)
    t2 = time.perf_counter()
    assert np.array_equal(fast, slow), "native and numpy label sweeps differ"
    print(f"[native] label propagation over synth-reddit's {len(rows)} hub-excluded edges, 8 "
          f"sweeps: native {t1 - t0:.2f} s, numpy {t2 - t1:.2f} s ({(t2 - t1) / (t1 - t0):.1f}x), "
          f"labels equal ({len(np.unique(fast))} communities)", flush=True)
    src = make_synthetic_dataset("synth-medium")
    with tempfile.TemporaryDirectory() as d:
        _write_reference_files(d, "medium", src)
        t0 = time.perf_counter()
        graph, feats, labels, split, fin, fout = native.load_dataset_native(d, "medium", False)
        t1 = time.perf_counter()
        ref = parser.load_dataset("medium", d, use_native=False)
        t2 = time.perf_counter()
    for name in ("indptr", "indices", "values", "sym_scale"):
        assert np.array_equal(getattr(graph, name), getattr(ref.graph, name)), name
    for name in ("indptr", "indices", "values"):
        assert np.array_equal(getattr(feats, name), getattr(ref.feature_csr, name)), name
    assert np.array_equal(labels, ref.labels) and np.array_equal(split, ref.split)
    assert (fin, fout) == (ref.input_dim, ref.output_dim)
    print(f"[native] load_dataset_native on synth-medium's files ({graph.n_rows} nodes, "
          f"{graph.nnz} graph entries, {feats.nnz} features): {t1 - t0:.2f} s, the numpy reader "
          f"{t2 - t1:.2f} s; graph, features, labels and split equal", flush=True)


# [main-products]: synth-products at full width with its node, edge,
# community and split counts cut to one eighth
PRODUCTS_EIGHTH = dict(n_nodes=306_129, n_edges=15_464_785, n_communities=600,
                       n_train=24_577, n_val=4_915)
PRODUCTS_EPOCHS = 5


def check_products_kernels(dds) -> None:
    """The kernels of the products path at its shapes: K4 over the pack at
    47 columns (bf16 x, rtol 2e-3) and at the set-up's 100 (f32 x, rtol
    1e-4), the residual's ordered gather-sum at 47 bf16 (bit-equal to its
    plain version on the CPU), K2 on [n, 256] bf16 (bit-equal), each timed
    beside its plain version."""
    import torch

    from parallel_gcn_tpu_torch.ops import cuda_bcsr as cb
    from parallel_gcn_tpu_torch.ops import cuda_dropout as cd

    gen = torch.Generator().manual_seed(16)
    g, pack = dds.graph, dds.graph.bcsr
    n = g.n_nodes
    for x, rtol in ((torch.randn((n, 47), generator=gen).to(torch.bfloat16).cuda(), 2e-3),
                    (dds.x, 1e-4)):
        got = cb.bcsr_matmul_impl(pack, x)
        assert torch.equal(got, cb.bcsr_matmul_impl(pack, x)), "K4: two runs differ"
        err = _max_err(got, cb.bcsr_matmul_plain(pack, x), rtol)
        ms = timer.events_ms(lambda: cb.bcsr_matmul_impl(pack, x), 10)
        pms = timer.events_ms(lambda: cb.bcsr_matmul_plain(pack, x), 2)
        bound = _spmm_bound(pack, x, got)
        lib = ""
        if x.dtype == torch.float32:  # the set-up Â·X: the library call beside it
            csr = _pack_csr(pack)
            lib = (f", torch.sparse.mm (CSR f32, f32 x) "
                   f"{timer.events_ms(lambda: torch.sparse.mm(csr, x), 10):.4f} ms")
            del csr
        body = _f32_body(pack) if x.dtype == torch.float32 else "bf16 body"
        print(f"[main-products] K4 bcsr fwd F={x.shape[1]} {x.dtype}, {body}, over "
              f"{pack.n_tiles} tiles: "
              f"max_abs_err {err:.3e} (rtol {rtol}), runs bit-identical; kernel {ms:.4f} ms, "
              f"plain {pms:.4f} ms{lib}, bound {bound['bound_ms']:.4f} ms ({bound['bound_by']})")
    x = torch.randn((n, 47), generator=gen).to(torch.bfloat16).cuda()
    check_segment_gather({}, None, "synth-products residual", x, g.row_seg)
    seed = 0x5EED_0F_C0DE
    x = torch.randn((n, 256), generator=gen).to(torch.bfloat16).cuda()
    got = cd.relu_dropout(x, _slot(seed), 0.1)
    assert torch.equal(got, cd.dropout_plain(x, seed, 0.1, relu=True)), "K2 != plain"
    ms = timer.events_ms(lambda: cd.relu_dropout(x, _slot(seed), 0.1), 20)
    pms = timer.events_ms(lambda: cd.dropout_plain(x, seed, 0.1, relu=True), 3)
    print(f"[main-products] K2 relu_dropout [{n}, 256] bf16 rate 0.1: bit-equal to plain; kernel "
          f"{ms:.4f} ms, plain {pms:.4f} ms, bound {_bound(2 * _nbytes(x))['bound_ms']:.4f} ms",
          flush=True)


# [products-shapes]: the full-size products path's shapes on random inputs
# (no generation): activations of [2,449,408, 256] (nodes padded to the
# 512-wide tiles), as many 512x512 int8 tiles as its pack holds (26,636,
# offsets past 2^31 bytes), a residual of its 23,050,722 items whose
# longest rows are its three longest
PRODUCTS_N_PAD = 2_449_408
PRODUCTS_TILES_PER_ROW = 6  # x 4,784 tile rows = 28,704 tiles
PRODUCTS_RES_ITEMS = 23_050_722
PRODUCTS_HUB_ROWS = (143_437, 71_923, 47_492)


def phase_products_shapes() -> None:
    """``[products-shapes]``: the kernels of the full-size products path
    held against their plain versions at its index widths. K2 on random
    [2,449,408, 256] in bf16 (the path's) and in f32 (2.5 GB: byte offsets
    past 2^31), bit-equal; K4 over a random int8 pattern pack
    (``pack_census._random_pack``, d = 1) of 28,704 tiles (7.5 GB) at 47
    and 94 bf16 columns and 100 f32 columns, within rtol 2e-3 / 1e-4 of
    ``bcsr_matmul_plain`` over every row, and over the rows whose tiles lie
    past the 2^31-byte offset on their own; kernel (a) over a random
    residual of 23,050,722 items into 2,449,408 rows holding rows of
    143,437, 71,923 and 47,492 items, bit-equal to ``gather_sum_plain`` on
    the CPU (``check_segment_gather``). Each is timed beside its plain
    version."""
    import numpy as np
    import torch

    from parallel_gcn_tpu_torch.harness.pack_census import _random_pack
    from parallel_gcn_tpu_torch.ops import cuda_bcsr as cb
    from parallel_gcn_tpu_torch.ops import cuda_dropout as cd
    from parallel_gcn_tpu_torch.ops import cuda_segment as cs

    n = PRODUCTS_N_PAD
    gen = torch.Generator(device="cuda").manual_seed(16)
    seed = 0x5EED_16_C0DE
    for dtype in (torch.bfloat16, torch.float32):
        x = torch.randn((n, 256), generator=gen, device="cuda", dtype=dtype)
        got = cd.relu_dropout(x, _slot(seed), 0.1)
        ref = cd.dropout_plain(x, seed, 0.1, relu=True)
        assert torch.equal(got, ref), f"K2 [{n}, 256] {dtype} != plain"
        del got, ref
        ms = timer.events_ms(lambda: cd.relu_dropout(x, _slot(seed), 0.1), 10)
        pms = timer.events_ms(lambda: cd.dropout_plain(x, seed, 0.1, relu=True), 2)
        print(f"[products-shapes] K2 relu_dropout [{n}, 256] {dtype} ({_nbytes(x)} bytes) rate "
              f"0.1: bit-equal to plain; kernel {ms:.4f} ms, "
              f"plain {pms:.4f} ms, bound {_bound(2 * _nbytes(x))['bound_ms']:.4f} ms",
              flush=True)
        del x
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    pack = _random_pack(n // 512, 512, PRODUCTS_TILES_PER_ROW, np.random.default_rng(16))
    pack = pack.to(torch.device("cuda"))
    torch.cuda.synchronize()
    tile_bytes = pack.tile_r * pack.tile_c
    first = 2**31 // tile_bytes  # the first tile at or past the 2^31-byte offset
    assert pack.n_tiles > first, pack.n_tiles
    r0 = int(pack.tile_rows[first]) * pack.tile_r
    nnz = int(pack.live_entries[0].numel())
    print(f"[products-shapes] random int8 pack: {pack.n_tiles} tiles 512x512 "
          f"({pack.n_tiles * tile_bytes} bytes), {nnz} entries, built and copied in "
          f"{time.perf_counter() - t0:.1f} s; tile {first} (tile row "
          f"{int(pack.tile_rows[first])}) starts at byte 2^31", flush=True)
    for F, dtype, rtol in ((47, torch.bfloat16, 2e-3), (94, torch.bfloat16, 2e-3),
                           (100, torch.float32, 1e-4)):
        x = torch.randn((n, F), generator=gen, device="cuda").to(dtype)
        got = cb.bcsr_matmul_impl(pack, x)
        assert torch.equal(got, cb.bcsr_matmul_impl(pack, x)), "K4: two runs differ"
        ref = cb.bcsr_matmul_plain(pack, x)
        err = _max_err(got, ref, rtol)
        err_past = _max_err(got[r0:], ref[r0:], rtol)
        del ref
        ms = timer.events_ms(lambda: cb.bcsr_matmul_impl(pack, x), 10)
        pms = timer.events_ms(lambda: cb.bcsr_matmul_plain(pack, x), 2)
        bound = _spmm_bound(pack, x, got)
        lib = ""
        if dtype == torch.float32:  # the set-up Â·X: the library call beside it
            csr = _pack_csr(pack)
            lib = (f", torch.sparse.mm (CSR f32, f32 x) "
                   f"{timer.events_ms(lambda: torch.sparse.mm(csr, x), 10):.4f} ms")
            del csr
        body = _f32_body(pack) if dtype == torch.float32 else "bf16 body"
        print(f"[products-shapes] K4 bcsr fwd F={F} {dtype}, {body}, over {pack.n_tiles} tiles: "
              f"max_abs_err {err:.3e} (rtol {rtol}), on rows {r0}.. (tiles past 2^31 bytes) "
              f"{err_past:.3e}, runs bit-identical; kernel {ms:.4f} ms, plain {pms:.4f} ms"
              f"{lib}, bound {bound['bound_ms']:.4f} ms ({bound['bound_by']})", flush=True)
        del x, got
    del pack
    torch.cuda.empty_cache()

    # the residual: the three hub rows at random places, the other items
    # spread at random over the other rows
    rng = np.random.default_rng(16)
    hubs = rng.choice(n, len(PRODUCTS_HUB_ROWS), replace=False)
    others = np.setdiff1d(np.arange(n), hubs)
    rest = others[rng.integers(0, len(others), PRODUCTS_RES_ITEMS - sum(PRODUCTS_HUB_ROWS))]
    index = np.sort(np.concatenate([np.repeat(hubs, PRODUCTS_HUB_ROWS), rest]))
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    seg = cs.segments(torch.from_numpy(index).to(dev), n,
                      torch.from_numpy(rng.integers(0, n, len(index))).to(dev),
                      torch.from_numpy(rng.random(len(index), np.float32)).to(dev))
    lengths = (seg.ptr[1:] - seg.ptr[:-1]).long()
    print(f"[products-shapes] random residual: {seg.index.numel()} items into {n} rows, "
          f"{seg.n_hub} hub rows (>= {cs.HUB_ITEMS} items), longest "
          f"{torch.topk(lengths, 3).values.tolist()}; segments built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    assert seg.index.numel() == PRODUCTS_RES_ITEMS
    assert torch.topk(lengths, 3).values.tolist() == list(PRODUCTS_HUB_ROWS)
    x = torch.randn((n, 47), generator=gen, device="cuda").to(torch.bfloat16)
    check_segment_gather({}, None, "products-size residual", x, seg, plain_chunks=8)
    del seg, x
    torch.cuda.empty_cache()


def phase_main_products() -> dict:
    """``[main-products]``: synth-products (``parameters_synth-products.txt``:
    100 -> 256 -> 47, hybrid, community reorder, 512x512 int8 tiles, the
    file's tile budget and ``min_tile_nnz``, bf16) on ``PRODUCTS_EIGHTH`` of
    its graph, generated, reordered and packed by ``prepare_host_dataset``
    and ``prepare_device_dataset`` with each stage timed; its kernels at the path's shapes
    (``check_products_kernels``); then ``train.fit`` for ``PRODUCTS_EPOCHS``
    epochs in ``mode=scan`` with the launch counts set to 0 just before it:
    ms/epoch, peak memory, a finite falling loss and the GCN's launches."""
    import torch

    from parallel_gcn_tpu_torch.config import default_params_path, load_config
    from parallel_gcn_tpu_torch.data.parser import (describe_setup, prepare_device_dataset,
                                                    prepare_host_dataset)
    from parallel_gcn_tpu_torch.train import fit

    cfg = load_config(default_params_path("synth-products"), {"epochs": PRODUCTS_EPOCHS})
    ds = prepare_host_dataset(cfg, "synth-products", PRODUCTS_EIGHTH)
    assert ds.setup["labels"] == "native", ds.setup
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    _, dds = prepare_device_dataset(cfg, "synth-products", torch.device("cuda"), host=ds)
    print(f"[main-products] synth-products at one eighth ({ds.n_nodes} nodes, {ds.graph.nnz} "
          f"entries with self-loops, {ds.input_dim} -> {cfg.gcn.hidden_dims[0]} -> "
          f"{ds.output_dim}, train/val/test {ds.train_dim}/{ds.val_dim}/{ds.test_dim})")
    print(f"[main-products] {describe_setup(ds, dds)}", flush=True)
    check_products_kernels(dds)
    buf = io.StringIO()
    _reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        fit(cfg, dds, verbose=True)
    out = _check_run("main-products", "train.fit", buf.getvalue(), time.perf_counter() - t0,
                     PRODUCTS_EPOCHS)
    out["peak"] = torch.cuda.max_memory_allocated() - before
    print(f"[main-products] peak max_memory_allocated above the {before} bytes held before the "
          f"dataset: {out['peak']} bytes", flush=True)
    del dds
    torch.cuda.empty_cache()
    return out


def check_dense() -> dict:
    """The dense backend on the card: generated graphs at cora's and
    citeseer's sizes (``DENSE_SETS``, under ``dense_threshold``) train the
    GCN, the GAT, SAGE and GIN for 3 epochs from those datasets' parameter
    files (float32 compute, early stopping off) on the card and on the CPU
    (the plain versions): metrics within 2e-4, and the dropout kernels
    launched on the card only. Returns each family's launches on the
    card."""
    import torch

    from parallel_gcn_tpu_torch.config import default_params_path, load_config
    from parallel_gcn_tpu_torch.data.parser import to_device
    from parallel_gcn_tpu_torch.data.synthetic import make_synthetic_dataset
    from parallel_gcn_tpu_torch.ops import cuda_dropout
    from parallel_gcn_tpu_torch.train import fit

    # the GAT at 2 heads: the CPU's plain Philox over [heads, N, N] attention
    # weights takes seconds a head
    families = {"GCN": {}, "GAT": dict(model="gat", heads=2, hidden_dims=(8,), attn_dropout=0.6),
                "SAGE": dict(model="sage"), "GIN": dict(model="gin")}
    launches: dict = {}
    for name, spec in DENSE_SETS.items():
        t0 = time.perf_counter()
        ds = make_synthetic_dataset(f"{name}-sized", **spec)
        dds = {dev: to_device(ds, device=torch.device(dev), dense=True)
               for dev in ("cuda", "cpu")}
        assert dds["cuda"].graph.adj is not None
        gen_s = time.perf_counter() - t0
        for family, over in families.items():
            cfg = load_config(default_params_path(name), dict(
                epochs=3, early_stopping=0, compute_dtype="float32", backend="dense",
                verbose=False))
            for key, val in over.items():
                setattr(cfg.gcn, key, val)
            hist = {}
            for dev in ("cuda", "cpu"):
                _reset_counts()
                before = dict(cuda_dropout.launches)
                hist[dev] = fit(cfg, dds[dev]).history
                moved = {k: cuda_dropout.launches[k] - before[k] for k in before}
                assert (sum(moved.values()) > 0) == (dev == "cuda"), (name, family, dev, moved)
                if dev == "cuda":
                    launches[f"{family} {name}"] = {k: v for k, v in _read_counts().items()
                                                    if v}
            diff = float(abs(hist["cuda"] - hist["cpu"]).max())
            print(f"[dense] {family} on a generated {name}-sized graph ({spec['n_nodes']} nodes, "
                  f"{spec['input_dim']} features, {spec['n_classes']} classes; generated in "
                  f"{gen_s:.1f} s), backend=dense, 3 epochs: card vs CPU max metric diff "
                  f"{diff:.3e}, train loss {hist['cuda'][0, 0]:.5f} -> {hist['cuda'][-1, 0]:.5f}, "
                  f"launches on the card {launches[f'{family} {name}']}")
            assert diff < 2e-4, f"dense {family} on {name}: card and CPU differ by {diff}"
    return launches


_T0 = time.perf_counter()


def _stamp(label: str) -> None:
    print(f"[time] {label} done at {time.perf_counter() - _T0:.1f} s", flush=True)


def main(argv: list[str]) -> int:
    import torch

    if not torch.cuda.is_available():
        print("error: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    repo = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, repo)
    import parallel_gcn_tpu_torch  # noqa: F401  (fails outside a checkout)
    global timer, profiling
    from parallel_gcn_tpu_torch.utils import profiling, timer
    from parallel_gcn_tpu_torch.config import default_params_path, load_config
    from parallel_gcn_tpu_torch.data.parser import prepare_device_dataset, prepare_host_dataset

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    kind = phase_device()
    built = phase_build()
    build_native()

    t0 = time.perf_counter()
    cfg = load_config(default_params_path("synth-reddit"))
    ds_host, dds = prepare_device_dataset(cfg, "synth-reddit", torch.device("cuda"))
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    built()
    pack = dds.graph.bcsr
    per_row = torch.bincount(pack.tile_rows.long(), minlength=pack.n_tile_rows)
    print(f"[setup] synth-reddit generated, reordered and packed in "
          f"{setup_s:.1f} s: {pack.n_tiles} tiles "
          f"{pack.tile_r}x{pack.tile_c} int8 (max {int(per_row.max())} per tile-row, "
          f"{pack.schedule.n_seg} segments, {pack.schedule.multi_row.numel()} split rows), "
          f"{dds.graph.n_edges_pad} padded residual edges, n_pad {dds.graph.n_nodes}")
    t0 = time.perf_counter()
    idx = pack.attn_index
    torch.cuda.synchronize()
    print(f"[setup] the pack's live-column index (K5/K6): {idx.col.numel()} entries over "
          f"{idx.ptr.numel() - 1} (segment, row) units, {_nbytes(idx.ptr, idx.col)} bytes, "
          f"built on the card in {time.perf_counter() - t0:.4f} s")

    phase_native(ds_host)
    _stamp("native")
    results: dict = {}
    check_dropout(results)
    check_dropout_offset()
    check_seed_lanes(results)
    # GIN's layer-0 aggregation input: s ⊙ x in bf16 (models/sage.py sum_agg)
    gin602 = dds.graph.sqrt_deg.to(torch.bfloat16)[:, None] * dds.x.to(torch.bfloat16)
    parent = parent_segment_sums(argv[argv.index("--parent") + 1] if "--parent" in argv
                                 else None)
    check_segment(results, dds.graph, gin602, parent)
    check_segment_flat(ds_host, cfg, parent)
    _stamp("ordered sums")
    check_bcsr(results, dds.graph.bcsr, dds.x, gin602)
    del gin602
    check_tile_attention(results, dds.graph.bcsr)
    check_ce(results, dds)
    check_fused(results)
    _stamp("kernel checks")
    phase_profile("GCN", [], dds)
    phase_profile("GAT", GAT_ARGS, dds)
    phase_profile("GCN fused", FUSED_ARGS, dds)
    phase_profile("SAGE", SAGE_ARGS, dds)
    phase_profile("GIN", GIN_ARGS, dds)
    torch.cuda.empty_cache()
    _stamp("profiles")
    check_reference()
    dense = check_dense()
    _stamp("reference and dense")

    # the mesh kernels on rank 0's slab of synth-reddit at one rank (square)
    # and of its 4-way partition with the boundary halo kept (rectangular)
    t0 = time.perf_counter()
    ds = prepare_host_dataset(cfg, "synth-reddit")
    print(f"[mesh-kernels] synth-reddit loaded and reordered on the host in "
          f"{time.perf_counter() - t0:.1f} s")
    check_sddmm(results, ds, cfg)
    for n_dev, args in ((1, []), (4, ["halo_fallback=false"])):
        gcn_slab, attn = mesh_slabs(ds, n_dev, args)
        tag = f"{n_dev}-way rank 0 [{attn.n_rows}, {attn.n_buf}]"
        check_bcsr_rect(results, gcn_slab.slab, tag, record=n_dev == 1)
        check_attention_rect(results, attn, tag, record=n_dev == 1)
        if n_dev == 1:
            check_segment_slab(gcn_slab, attn)
        del gcn_slab, attn
        torch.cuda.empty_cache()
    check_reference_mesh()
    _stamp("mesh kernels")
    halo = phase_halo_kernels(ds)
    _stamp("halo kernels")
    tp_emu = phase_tp_emulated(ds)
    _stamp("tp emulated")

    # the main paths: mode=scan (the default) through cli.main, each beside
    # mode=eager through train.fit on this script's copy of the dataset
    gcn = phase_main_path("main-gcn", ["synth-reddit", f"epochs={EPOCHS}"])
    gcn["eager_ms"], gcn["scan_run"] = phase_eager_compare("main-gcn", [], dds, gcn)
    # a replay (the deferred-eval schedule): K2 once (layer 1's train
    # forward), K4 for the stacked train and val forward and for the
    # backward, each with the ordered gather-sum of its residual; plus K4
    # and the gather-sum once each for the input pre-aggregation, the final
    # val eval and the test eval
    assert gcn["per_replay"] == {"K2": 1, "K4": 2, "ordered gather_sum": 2}, gcn["per_replay"]
    # (the pre-aggregation of the f32 input: K4's f32 body)
    assert gcn["counts"]["K2"] == EPOCHS and gcn["counts"]["K4"] == 2 * EPOCHS + 2, gcn
    assert gcn["counts"]["K4 f32"] == 1, gcn
    assert gcn["counts"]["ordered gather_sum"] == 2 * EPOCHS + 3, gcn
    _stamp("main-gcn")
    gcn_f32 = phase_main_gcn_f32(dds)
    _stamp("main-gcn-f32")
    resume = {"GCN": phase_resume("resume-gcn", [], gcn["scan_run"], gcn["ms"])}
    _stamp("resume-gcn")
    gat = phase_main_path("main-gat", ["synth-reddit", *GAT_ARGS, f"epochs={EPOCHS}"])
    gat["eager_ms"], gat["scan_run"] = phase_eager_compare("main-gat", GAT_ARGS, dds, gat)
    # a replay (the plain scan: the GAT has no deferred eval): K5 for both
    # layers of the train forward and of the val eval, K6 for both layers'
    # backward, K1 on layer 1's train input and in its backward; the
    # residual's ordered sums, 2 a forward (den, acc) and 3 a backward (ds,
    # dt, dv); plus both layers of the test eval
    assert gat["per_replay"] == {"K1": 2, "K5": 4, "K6": 2, "ordered segment_sum": 14}, \
        gat["per_replay"]
    assert (gat["counts"]["K5"], gat["counts"]["K6"], gat["counts"]["K1"],
            gat["counts"]["ordered segment_sum"]) == (
        4 * EPOCHS + 2, 2 * EPOCHS, 2 * EPOCHS, 14 * EPOCHS + 4), gat
    _stamp("main-gat")
    resume["GAT"] = phase_resume("resume-gat", GAT_ARGS, gat["scan_run"], gat["ms"])
    _stamp("resume-gat")
    fused = phase_main_path("main-fused", ["synth-reddit", *FUSED_ARGS, f"epochs={EPOCHS}"])
    fused["eager_ms"], _ = phase_eager_compare("main-fused", FUSED_ARGS, dds, fused)
    # a replay: K9's train variant on the train half and its eval variant on
    # the val half (plus the final val eval and the test eval); K10 forward,
    # dW and dX on layer 1; K4 and the gather-sum as on the default path; K2
    # never
    assert fused["per_replay"] == {"K4": 2, "K9 train": 1, "K9 eval": 1, "K10 fwd": 1,
                                   "K10 dW": 1, "K10 dX": 1, "ordered gather_sum": 2}, \
        fused["per_replay"]
    assert (fused["counts"]["K9 train"], fused["counts"]["K9 eval"], fused["counts"]["K4"],
            fused["counts"]["K4 f32"], fused["counts"]["K2"]) == (
        EPOCHS, EPOCHS + 2, 2 * EPOCHS + 2, 1, 0), fused
    diff = max(abs(a - b) for a, b in zip(gcn["losses"], fused["losses"]))
    print(f"[main-fused] {fused['ms']:.3f} ms/epoch (scan) against the default GCN path's "
          f"{gcn['ms']:.3f} (epochs 2-{EPOCHS}); train-loss trajectories differ by at most "
          f"{diff:.5f}")
    _stamp("main-fused")
    sage = phase_main_path("main-sage", ["synth-reddit", *SAGE_ARGS, f"epochs={EPOCHS}"])
    sage["eager_ms"], sage["scan_run"] = phase_eager_compare("main-sage", SAGE_ARGS, dds, sage)
    # a replay (the plain scan: no deferred eval, no pre-aggregation): K4
    # with the gather-sum of its residual for layer 0's neighbour mean at
    # 600 columns (the wide body) and layer 1's at 41, each in the train
    # forward, the backward and the val eval (3 calls at each width); K2 at
    # layer 1's entry; plus both layers of the test eval
    assert sage["per_replay"] == {"K2": 1, "K4": 3, "K4 wide": 3, "ordered gather_sum": 6}, \
        sage["per_replay"]
    assert (sage["counts"]["K4"], sage["counts"]["K4 wide"], sage["counts"]["ordered gather_sum"],
            sage["counts"]["K2"]) == (3 * EPOCHS + 1, 3 * EPOCHS + 1, 6 * EPOCHS + 2, EPOCHS), sage
    _stamp("main-sage")
    gin = phase_main_path("main-gin", ["synth-reddit", *GIN_ARGS, f"epochs={EPOCHS}"],
                          falls=False)
    gin["eager_ms"], gin["scan_run"] = phase_eager_compare("main-gin", GIN_ARGS, dds, gin)
    # a replay: K4 (the wide body) with the gather-sum for layer 0's sum of
    # the input at 602 columns (the train forward and the val eval; the input
    # takes no gradient) and for layer 1's at 600 (forward, backward, val
    # eval); K2 at layer 1's entry; plus both layers of the test eval
    assert gin["per_replay"] == {"K2": 1, "K4 wide": 5, "ordered gather_sum": 5}, \
        gin["per_replay"]
    assert (gin["counts"]["K4 wide"], gin["counts"]["K4"], gin["counts"]["ordered gather_sum"],
            gin["counts"]["K2"]) == (5 * EPOCHS + 2, 0, 5 * EPOCHS + 2, EPOCHS), gin
    _stamp("main-gin")
    main_seeds = phase_main_seeds(dds)
    # a replay: the GCN's deferred schedule over the lanes: K2 over the lanes
    # once (layer 1's train forward, from layer 0's lanes to the lanes' GEMMs)
    # and its backward once, K4 and the gather-sum of its residual
    # over 4·82 columns (the stacked forward) and 4·41 (the backward); plus
    # the pre-aggregation, the final val eval and the test eval, each one
    # aggregation for all lanes
    assert main_seeds["per_replay"] == {"K2 lanes": 1, "K2 lanes bwd": 1, "K4": 2,
                                        "ordered gather_sum": 2}, main_seeds["per_replay"]
    assert (main_seeds["counts"]["K2 lanes"], main_seeds["counts"]["K2 lanes bwd"],
            main_seeds["counts"]["K4"], main_seeds["counts"]["K4 f32"],
            main_seeds["counts"]["ordered gather_sum"], main_seeds["counts"]["K2"]) == (
        EPOCHS, EPOCHS, 2 * EPOCHS + 2, 1, 2 * EPOCHS + 3, 0), main_seeds
    _stamp("main-seeds")
    families = {tag: phase_seeds_family(tag, args, dds, lanes)
                for tag, args, lanes in SEED_FAMILIES}
    # a replay: each family's solo schedule with the aggregations over the
    # lanes' joined columns (SAGE's and GIN's K4 and gather-sums as alone, K2
    # over the lanes once); the GAT's attention once a lane (K5, K6, K1 and
    # the residual's sums 4 times the solo replay's); the fused GCN's K10
    # over the lanes once each way, K9 once a lane
    for tag, want in (("seeds-sage", {"K2 lanes": 1, "K2 lanes bwd": 1, "K4": 3, "K4 wide": 3,
                                      "ordered gather_sum": 6}),
                      ("seeds-gin", {"K2 lanes": 1, "K2 lanes bwd": 1, "K4 wide": 5,
                                     "ordered gather_sum": 5}),
                      ("seeds-gat", {k: SEED_LANES * v for k, v in gat["per_replay"].items()}),
                      ("seeds-fused", {"K4": 2, "K9 train": SEED_LANES, "K9 eval": SEED_LANES,
                                       "K10 fwd lanes": 1, "K10 dW lanes": 1,
                                       "K10 dX lanes": 1, "ordered gather_sum": 2})):
        assert families[tag]["per_replay"] == want, (tag, families[tag]["per_replay"])
    _stamp("seeds-families")
    remat = {"GCN": phase_remat("remat-gcn", [], dds, gcn["scan_run"]),
             "GAT": phase_remat("remat-gat", GAT_ARGS, dds, gat["scan_run"])}
    # the GCN's deferred schedule recomputes layer 0's transform only (its
    # input is the pre-aggregated Â·X): the same kernels a replay
    assert remat["GCN"]["per_replay"] == gcn["per_replay"], remat["GCN"]
    # the GAT recomputes both layers' forward in the backward: K5 twice more
    # and K1 once more (layer 1's input) a replay
    assert (remat["GAT"]["per_replay"]["K5"], remat["GAT"]["per_replay"]["K1"]) == (6, 3), \
        remat["GAT"]
    del dds
    torch.cuda.empty_cache()
    _stamp("single-card paths")
    seeds_medium = phase_seeds_medium()
    assert seeds_medium["per_replay"] == {"K2 lanes": 1, "K2 lanes bwd": 1,
                                          "ordered gather_sum": 2}, seeds_medium["per_replay"]
    seeds_stop = phase_seeds_stop()
    # the plain epoch (early stopping): K1 over the lanes' input features and
    # K2 at layer 1's entry, in the train forward, and K2's backward; the
    # dense Â is cuBLAS's
    assert seeds_stop["per_replay"] == {"K1 lanes": 1, "K2 lanes": 1, "K2 lanes bwd": 1}, \
        seeds_stop["per_replay"]
    seeds_stop_fused = phase_seeds_stop(fused=True)
    # the laned K10 at both layers' training forward (layer 0 over the
    # shared input) and backward, dX at layer 1 only
    assert seeds_stop_fused["per_replay"] == {"K10 fwd lanes": 2, "K10 dW lanes": 2,
                                              "K10 dX lanes": 1}, seeds_stop_fused["per_replay"]
    torch.cuda.empty_cache()
    _stamp("seed batches")
    products = phase_main_products()
    # a replay: the GCN's deferred schedule (K2 once, K4 and the residual's
    # gather-sum for the stacked forward at 94 columns and the backward at
    # 47); plus the pre-aggregation at 100, the final val eval and the test
    assert products["per_replay"] == {"K2": 1, "K4": 2, "ordered gather_sum": 2}, \
        products["per_replay"]
    assert (products["counts"]["K2"], products["counts"]["K4"], products["counts"]["K4 f32"],
            products["counts"]["ordered gather_sum"]) == (
        PRODUCTS_EPOCHS, 2 * PRODUCTS_EPOCHS + 2, 1, 2 * PRODUCTS_EPOCHS + 3), products
    _stamp("main-products")
    phase_products_shapes()
    _stamp("products-shapes")
    mesh_gcn = phase_mesh_path("main-mesh-gcn", MESH_GCN_ARGS, ds, gcn, deterministic=False)
    # a replay (deferred eval on the mesh): K3 over the slab for the stacked
    # forward and for the backward (layer 0 pre-aggregated), each with the
    # gather-sum of the slab's residual, K2 on layer 1's train input; plus
    # K3 and the gather-sum for the pre-aggregation, the final val and the
    # test
    assert mesh_gcn["per_replay"] == {"K2": 1, "K3 rect": 2, "ordered gather_sum": 2}, \
        mesh_gcn["per_replay"]
    assert (mesh_gcn["counts"]["K3 rect"], mesh_gcn["counts"]["K3 rect f32"],
            mesh_gcn["counts"]["K2"], mesh_gcn["counts"]["ordered gather_sum"]) == (
        2 * EPOCHS + 2, 1, EPOCHS, 2 * EPOCHS + 3), mesh_gcn
    _stamp("main-mesh-gcn")
    resume["mesh GCN"] = phase_resume("resume-mesh-gcn", MESH_GCN_ARGS, mesh_gcn["scan_run"],
                                      mesh_gcn["ms"], mesh=True)
    _stamp("resume-mesh-gcn")
    mesh_gat = phase_mesh_path("main-mesh-gat", MESH_GAT_ARGS, ds, gat, deterministic=False)
    # a replay: rect K5 for both layers in the train forward and the val
    # eval, both K7 sweeps for both layers' backward, K1 on layer 1's input
    # and in its backward, the residual's ordered sums as on the GAT path
    # (dt and dv by source); plus both layers of the test eval
    assert mesh_gat["per_replay"] == {"K1": 2, "K5 rect": 4, "K7 row": 2, "K7 col": 2,
                                      "ordered segment_sum": 14}, mesh_gat["per_replay"]
    assert (mesh_gat["counts"]["K5 rect"], mesh_gat["counts"]["K7 row"],
            mesh_gat["counts"]["K7 col"], mesh_gat["counts"]["K1"],
            mesh_gat["counts"]["ordered segment_sum"]) == (
        4 * EPOCHS + 2, 2 * EPOCHS, 2 * EPOCHS, 2 * EPOCHS, 14 * EPOCHS + 4), mesh_gat
    _stamp("main-mesh-gat")
    mesh_sage = phase_mesh_path("main-mesh-sage", MESH_SAGE_ARGS, ds, sage, deterministic=False)
    # a replay: the single-card SAGE schedule with K3 over the rank's slab
    assert mesh_sage["per_replay"] == {"K2": 1, "K3 rect": 6, "ordered gather_sum": 6}, \
        mesh_sage["per_replay"]
    mesh_gin = phase_mesh_path("main-mesh-gin", MESH_GIN_ARGS, ds, gin, deterministic=False,
                               falls=False)
    assert mesh_gin["per_replay"] == {"K2": 1, "K3 rect": 5, "ordered gather_sum": 5}, \
        mesh_gin["per_replay"]
    _stamp("mesh paths")
    # the ring and adaptive halos at one rank: the ring is one slab and no
    # rotation; the adaptive halo has no push pair and falls back to the
    # all_gather layout (halo_fallback), over flat COO or int8 tile slabs.
    # A replay: the single-card schedules, the flat ones' aggregation one
    # ordered gather-sum (forward, self-adjoint or transposed backward)
    ring = phase_mesh_path("main-ring", ["backend=segment", "halo=ring"], ds, gcn,
                           deterministic=False)
    assert ring["per_replay"] == {"K2": 1, "ordered gather_sum": 2}, ring["per_replay"]
    assert ring["collectives"] == {"all_reduce": 1}, ring["collectives"]
    ring_sage = phase_mesh_path("main-ring-sage", [*SAGE_ARGS, "backend=segment", "halo=ring"],
                                ds, sage, deterministic=False)
    assert ring_sage["per_replay"] == {"K2": 1, "ordered gather_sum": 6}, \
        ring_sage["per_replay"]
    adaptive = phase_mesh_path("main-adaptive", ["backend=segment", "halo=adaptive"], ds, gcn,
                               deterministic=False)
    assert adaptive["per_replay"] == {"K2": 1, "ordered gather_sum": 2}, adaptive["per_replay"]
    hyb_adaptive = phase_mesh_path("main-hybrid-adaptive", ["halo=adaptive"], ds, gcn,
                                   deterministic=False)
    assert hyb_adaptive["per_replay"] == mesh_gcn["per_replay"], hyb_adaptive["per_replay"]
    _stamp("ring and adaptive paths")
    n_chunks = check_attention_chunked(ds)
    gat_chunk = phase_gat_chunk(ds)
    # a replay of the segment GAT: K1 on layer 1's input and on both layers'
    # attention weights, forward and backward; the ordered sums 2 a layer
    # forward (train and val: the denominator, the aggregation) and 4 a
    # layer backward (the gathers of s, t, hw and the denominator)
    assert gat_chunk["main-gat-segment"]["per_replay"] == {
        "K1": 6, "ordered segment_sum": 16}, gat_chunk["main-gat-segment"]["per_replay"]
    # chunked (12 chunks): K1 a chunk and layer in the forward, in the
    # backward's recompute and in the backward; the sums 2 a chunk and layer
    # forward (train and val), the recompute's denominator (it stops at the
    # last tensor the backward needs) and the 3 gathers' sums a chunk and layer
    assert gat_chunk["main-gat-chunk"]["per_replay"] == {
        "K1": 2 + 3 * 2 * n_chunks, "ordered segment_sum": (2 + 2 + 1 + 3) * 2 * n_chunks}, \
        gat_chunk["main-gat-chunk"]["per_replay"]
    mesh_gat_chunk = phase_mesh_path(
        "main-mesh-gat-chunk", [*GAT_SEGMENT_ARGS, "halo=boundary", f"edge_chunk={GAT_CHUNK}"],
        ds, gat_chunk["main-gat-chunk"], deterministic=False)
    # K1 draws every chunk's mask at its offset: on both layers' attention
    # weights, in the forward, the recompute and the backward
    assert mesh_gat_chunk["per_replay"] == gat_chunk["main-gat-chunk"]["per_replay"], \
        mesh_gat_chunk["per_replay"]
    _stamp("streaming GAT paths")
    phase_profile_mesh("GCN", MESH_GCN_ARGS, ds)
    phase_profile_mesh("GAT", MESH_GAT_ARGS, ds)
    phase_profile_mesh("SAGE", MESH_SAGE_ARGS, ds)
    phase_profile_mesh("GIN", MESH_GIN_ARGS, ds)
    _stamp("mesh profiles")
    paths = {"GCN": gcn, "GCN float32": gcn_f32, "GAT": gat, "GCN fused": fused, "SAGE": sage,
             "GIN": gin,
             "mesh GCN": mesh_gcn, "mesh GAT": mesh_gat, "mesh SAGE": mesh_sage,
             "mesh GIN": mesh_gin, "GCN remat": remat["GCN"], "GAT remat": remat["GAT"],
             "mesh GCN ring": ring, "mesh SAGE ring": ring_sage, "mesh GCN adaptive": adaptive,
             "mesh GCN hybrid adaptive": hyb_adaptive,
             "GAT segment": gat_chunk["main-gat-segment"],
             "GAT segment chunked": gat_chunk["main-gat-chunk"],
             "mesh GAT segment chunked": mesh_gat_chunk, "GCN 4 seed lanes": main_seeds,
             "synth-medium 16 seed lanes": seeds_medium, "cora-sized 8 seed lanes": seeds_stop,
             "cora-sized 8 fused seed lanes": seeds_stop_fused, **families,
             "synth-products at one eighth": products}
    # each kernel's launches over every main path and the emulated TP
    # forwards and backwards (K3 and K8 run on none: 0)
    counts = {key: sum(p["counts"][key] for p in paths.values()) + tp_emu["counts"][key]
              for key in {**KERNEL_KEYS, **HUB_KEYS}}
    print(f"[main] launches by path: {json.dumps({k: p['counts'] for k, p in paths.items()})}")
    print(f"[tp-emulated] launches (GCN, SAGE, GIN at tp 2 and 4, one training step each): "
          f"{json.dumps(tp_emu['counts'])}; errors against tp=1 (logits, gradients): "
          f"{json.dumps(tp_emu['errs'])}")
    print(f"[main] scan ms/epoch by path: "
          f"{json.dumps({k: round(p['ms'], 3) for k, p in paths.items()})}")
    print(f"[remat] peak max_memory_allocated bytes (remat, without): "
          f"{json.dumps({k: [r['peak'], r['peak_plain']] for k, r in remat.items()})}")
    print(f"[dense] launches on the card: {json.dumps(dense, sort_keys=True)}")
    print(f"[halo-kernels] buffer rows and rank 0's pieces: {json.dumps(halo)}")
    print(f"[resume] checkpoints through cli.main, seconds to write / load and ms/epoch "
          f"chunked: {json.dumps(resume, sort_keys=True)}")

    def entry(key, name, source, replaces):
        r = results[key]
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": counts[key], "max_abs_err": r["err"], "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "library_ms": r.get("library_ms"),
                **({"bound_pack_ms": r["pack_bound_ms"]} if "pack_bound_ms" in r else {}),
                **({"parent_ms": r["parent_ms"]} if "parent_ms" in r else {}),
                **({"hub_launches": counts[f"{key} hub"]} if f"{key} hub" in counts else {}),
                **({"unlaned_ms": r["unlaned_ms"]} if "unlaned_ms" in r else {}),
                **({"bound_f32_ops_ms": r["f32_ops_bound_ms"]} if "f32_ops_bound_ms" in r
                   else {})}

    drop_src = "parallel_gcn_tpu_torch/csrc/dropout.cu"
    bcsr_src = "parallel_gcn_tpu_torch/csrc/bcsr_spmm.cu"
    attn_src = "parallel_gcn_tpu_torch/csrc/tile_attention.cu"
    ce_src = "parallel_gcn_tpu_torch/csrc/fused_ce.cu"
    mm_src = "parallel_gcn_tpu_torch/csrc/dropout_matmul.cu"
    rect_src = "parallel_gcn_tpu_torch/csrc/tile_attention_rect.cu"
    seg_src = "parallel_gcn_tpu_torch/csrc/segment_sum.cu"
    # no Pallas kernel: the JAX package sums its residual with XLA's segment_sum
    seg_replaces = "parallel_gcn_tpu/ops/graphsum.py:45 (jax.ops.segment_sum, no Pallas kernel)"
    kernels = [
        entry("K1", "dropout", drop_src, "parallel_gcn_tpu/ops/pallas_dropout.py:30"),
        entry("K2", "relu_dropout", drop_src, "parallel_gcn_tpu/ops/pallas_dropout.py:142"),
        entry("K4", "bcsr_spmm_scaled", bcsr_src, "parallel_gcn_tpu/ops/pallas_bcsr.py:254"),
        # the f32 body (spmm_walk_kernel): the set-up pre-aggregation's F=602
        # numbers, F=41's and the stacked F=82's under their widths
        {**entry("K4 f32", "bcsr_spmm_scaled_f32", bcsr_src,
                 "parallel_gcn_tpu/ops/pallas_bcsr.py:254"), "F=41": results["K4 f32"]["F=41"],
         "F=82": results["K4 f32"]["F=82"]},
        # the wide body (spmm_pipe_kernel_wgmma): SAGE's F=600 numbers, GIN's
        # F=602 under its width
        {**entry("K4 wide", "bcsr_spmm_scaled_wide", bcsr_src,
                 "parallel_gcn_tpu/ops/pallas_bcsr.py:254"), "F=602": results["K4 wide"]["F=602"]},
        entry("K5", "gat_fwd", attn_src, "parallel_gcn_tpu/ops/tile_attention.py:179"),
        entry("K6", "gat_bwd", attn_src, "parallel_gcn_tpu/ops/tile_attention.py:283"),
        entry("K9 train", "masked_ce_train", ce_src, "parallel_gcn_tpu/ops/pallas_ce.py:77"),
        entry("K9 eval", "masked_ce_eval", ce_src, "parallel_gcn_tpu/ops/pallas_ce.py:73"),
        entry("K10 fwd", "dropout_matmul_fwd", mm_src,
              "parallel_gcn_tpu/ops/pallas_fused.py:49"),
        entry("K10 dW", "dropout_matmul_dw", mm_src,
              "parallel_gcn_tpu/ops/pallas_fused.py:70"),
        entry("K10 dX", "dropout_matmul_dx", mm_src,
              "parallel_gcn_tpu/ops/pallas_fused.py:93"),
        entry("K3 rect", "bcsr_spmm_rect", bcsr_src,
              "parallel_gcn_tpu/ops/pallas_bcsr.py:190"),
        entry("K3 rect f32", "bcsr_spmm_rect_f32", bcsr_src,
              "parallel_gcn_tpu/ops/pallas_bcsr.py:190"),
        entry("K5 rect", "gat_fwd_rect", attn_src,
              "parallel_gcn_tpu/ops/tile_attention.py:179"),
        entry("K7 row", "gat_bwd_rect_row", rect_src,
              "parallel_gcn_tpu/ops/tile_attention.py:439"),
        entry("K7 col", "gat_bwd_rect_col", rect_src,
              "parallel_gcn_tpu/ops/tile_attention.py:475"),
        entry("ordered gather_sum", "ordered_gather_sum", seg_src, seg_replaces),
        entry("ordered segment_sum", "ordered_segment_sum", seg_src, seg_replaces),
        entry("K1 lanes", "dropout_lanes", drop_src,
              "parallel_gcn_tpu/ops/pallas_dropout.py:30"),
        entry("K2 lanes", "relu_dropout_lanes", drop_src,
              "parallel_gcn_tpu/ops/pallas_dropout.py:142"),
        # no Pallas kernel: the JAX package's K2 backward is jnp (its custom_vjp)
        entry("K2 lanes bwd", "relu_dropout_lanes_bwd", drop_src,
              "parallel_gcn_tpu/ops/pallas_dropout.py:197 (_relu_bwd, jnp: no Pallas kernel)"),
        entry("K10 fwd lanes", "dropout_matmul_fwd_lanes", mm_src,
              "parallel_gcn_tpu/ops/pallas_fused.py:49"),
        entry("K10 dW lanes", "dropout_matmul_dw_lanes", mm_src,
              "parallel_gcn_tpu/ops/pallas_fused.py:70"),
        entry("K10 dX lanes", "dropout_matmul_dx_lanes", mm_src,
              "parallel_gcn_tpu/ops/pallas_fused.py:93"),
    ]
    idle = [k["name"] for k in kernels if not k["launches"]]
    assert not idle, f"kernels of the main paths that no main path launched: {idle}"
    print(json.dumps({
        "kernels": kernels,
        # ported kernels that no main path launches
        "off_path_kernels": [
            entry("K3", "bcsr_spmm", bcsr_src, "parallel_gcn_tpu/ops/pallas_bcsr.py:190"),
            {**entry("K3 f32", "bcsr_spmm_f32", bcsr_src,
                     "parallel_gcn_tpu/ops/pallas_bcsr.py:190"),
             "F=41": results["K3 f32"]["F=41"]},
            {**entry("K8", "sddmm_bcsr", "parallel_gcn_tpu_torch/csrc/sddmm.cu",
                     "parallel_gcn_tpu/ops/pallas_sddmm.py:36"), "bf16": results["K8"]["bf16"]},
        ],
    }))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
