"""Build and load the CUDA kernels of ``parallel_gcn_tpu_torch/csrc``.

Each ``csrc/*.cu`` file is compiled for ``sm_90a`` by its own ``nvcc``
process, all started together, and the objects are linked into one shared
library with a plain C interface, named by a hash of the sources, headers
(``csrc/*.cuh``) and flags, kept under ``parallel_gcn_tpu_torch/_build/`` and loaded with ``ctypes``.
The build runs at the first kernel call of a process (seconds), never at
import. A failed build raises with nvcc's output.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
_BUILD_DIR = os.path.join(_PKG_DIR, "_build")
_ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
_NVCC_FLAGS = [*_ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
build_info: dict = {}  # path, seconds, log of the build this process loaded


def _find_nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH, /usr/local/cuda/bin): "
        "the CUDA kernels cannot be built"
    )


def _declare(lib: ctypes.CDLL) -> None:
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    # seeds are device pointers: K1/K2 and K10 read a uint64, K5-K7 an int32
    lib.pgcn_dropout.argtypes = [p, p, i64, i32, i32, p, ctypes.c_uint64, ctypes.c_uint32,
                                 ctypes.c_float, p]
    lib.pgcn_dropout.restype = i32
    # the lanes' input, saved output and output (host arrays of pointers, row
    # strides), rows, lanes, F, dtype, mode, the seeds, counter, threshold, 1/keep
    lib.pgcn_dropout_lanes.argtypes = [p, i64, p, i64, p, i64, i64, i32, i64, i32, i32, p,
                                       ctypes.c_uint64, ctypes.c_uint32, ctypes.c_float, p]
    lib.pgcn_dropout_lanes.restype = i32
    lib.pgcn_bcsr_spmm.argtypes = [
        p, i32, p, p, p, i32, p, p, i32, p, p, p, i32, p, p, i32, i32, i32, i32, i32, p,
    ]
    lib.pgcn_bcsr_spmm.restype = i32
    # K4's wide body: the tiles and their count, the schedule, d, x, its rows
    # and row stride, out, workspace, tile_r, tile_c, F, nonneg, the stream
    lib.pgcn_bcsr_spmm_wide.argtypes = [
        p, i32, p, p, p, i32, p, p, i32, p, p, p, i32, i32, p, p, i32, i32, i32, i32, p,
    ]
    lib.pgcn_bcsr_spmm_wide.restype = i32
    # the live-entry index (entries, row offsets), the schedule, x, out,
    # workspace, tile_r, tile_c, F, x's row stride, the shape
    lib.pgcn_bcsr_spmm_walk.argtypes = [p, p, p, p, p, i32, p, p, i32, p, p, p, p, i32, i32,
                                        i32, i32, i32, p]
    lib.pgcn_bcsr_spmm_walk.restype = i32
    lib.pgcn_sddmm.argtypes = [p, p, i32, p, p, i32, i32, p, i32, i32, p]
    lib.pgcn_sddmm.restype = i32
    u32, f32 = ctypes.c_uint32, ctypes.c_float
    drop = [i32, p, u32, f32]
    walk = [p, p, p, p, i32, p, p, i32, i32]  # AttnIndex and the schedule's segments
    lib.pgcn_gat_fwd.argtypes = [*walk, p, p, p, i32, i32, p, i32, i32, p, p, i32, i32,
                                 f32, *drop, p]
    lib.pgcn_gat_fwd.restype = i32
    lib.pgcn_gat_bwd.argtypes = [*walk, p, p, p, i32, i32, p, p, i32, i32, p, p, i32, i32,
                                 f32, *drop, p]
    lib.pgcn_gat_bwd.restype = i32
    rect = [*walk, p, p, p, p, i32, i32, i32, p, p, i32, i32, f32, *drop, p]
    lib.pgcn_gat_bwd_rect_row.argtypes = rect
    lib.pgcn_gat_bwd_rect_row.restype = i32
    lib.pgcn_gat_bwd_rect_col.argtypes = rect
    lib.pgcn_gat_bwd_rect_col.restype = i32
    lib.pgcn_pad_heads.argtypes = [p, p, i32, i32, i32, i32, i32, i32, p]
    lib.pgcn_pad_heads.restype = i32
    lib.pgcn_masked_ce.argtypes = [p, p, i32, p, i64, i32, f32, f32, p, i64, p, p, p, p]
    lib.pgcn_masked_ce.restype = i32
    lib.pgcn_dropout_matmul_fwd.argtypes = [p, p, p, i32, i64, i32, i32, p, u32, f32, p]
    lib.pgcn_dropout_matmul_fwd.restype = i32
    lib.pgcn_dropout_matmul_dw.argtypes = [p, p, p, p, i32, i64, i32, i32, i32, i32, i64,
                                           p, u32, f32, p]
    lib.pgcn_dropout_matmul_dw_blocks.argtypes = [i32, i32, p]
    lib.pgcn_dropout_matmul_dw_blocks.restype = i32
    lib.pgcn_dropout_matmul_dw.restype = i32
    lib.pgcn_dropout_matmul_dx.argtypes = [p, p, p, i32, i64, i32, i32, p, u32, f32, p]
    lib.pgcn_dropout_matmul_dx.restype = i32
    # seed lanes: the lanes, x's lane step and row stride (fwd, dW); dX's W
    # fragment scratch
    lib.pgcn_dropout_matmul_fwd_lanes.argtypes = [p, p, p, i32, i64, i32, i32, i32, i64, i64, p,
                                                  u32, f32, p]
    lib.pgcn_dropout_matmul_fwd_lanes.restype = i32
    lib.pgcn_dropout_matmul_dw_lanes.argtypes = [p, p, p, p, i32, i64, i32, i32, i32, i64, i64,
                                                 i32, i32, i64, p, u32, f32, p]
    lib.pgcn_dropout_matmul_dw_lanes.restype = i32
    lib.pgcn_dropout_matmul_dx_lanes.argtypes = [p, p, p, p, i32, i64, i32, i32, i32, p, u32,
                                                 f32, p]
    lib.pgcn_dropout_matmul_dx_lanes.restype = i32
    # the work list, its hubs, live and written entries; the packed items
    # (a) or the permutation (b); the rows' source and out (rows ld apart),
    # the width; the layout (ops/cuda_segment.layout) and the hubs' vectors
    seg = [p, i32, i32, i32, p, p, i64, i32, p, i64, i32, i32, i32, i32, i32, i32, i32, p]
    lib.pgcn_gather_sum.argtypes = seg
    lib.pgcn_gather_sum.restype = i32
    lib.pgcn_segment_sum.argtypes = seg
    lib.pgcn_segment_sum.restype = i32


def _run_nvcc(sources: list[str], out: str) -> str:
    """Compile each source in its own nvcc process, all at once, then link
    ``out``; returns the compilers' output. Raises on any failure."""
    nvcc = _find_nvcc()
    objs = [f"{out}.{i}.o" for i in range(len(sources))]
    procs = [
        (cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                               text=True))
        for cmd in ([nvcc, *_NVCC_FLAGS, "-c", src, "-o", obj]
                    for src, obj in zip(sources, objs))
    ]
    log, failed = "", []
    for cmd, proc in procs:
        text = proc.communicate()[0]
        log += text
        if proc.returncode != 0:
            failed.append(f"nvcc failed (exit {proc.returncode}): {' '.join(cmd)}\n{text}")
    if not failed:
        cmd = [nvcc, *_ARCH, "-shared", "-o", out, *objs]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log += proc.stdout + proc.stderr
        if proc.returncode != 0:
            failed.append(f"nvcc link failed (exit {proc.returncode}): {' '.join(cmd)}\n"
                          f"{proc.stdout}{proc.stderr}")
    for obj in objs:
        if os.path.exists(obj):
            os.remove(obj)
    if failed:
        raise RuntimeError("\n".join(failed))
    return log


def load_library() -> ctypes.CDLL:
    """The kernels' shared library, built on first use."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        sources = sorted(glob.glob(os.path.join(_CSRC_DIR, "*.cu")))
        if not sources:
            raise RuntimeError(f"no CUDA sources under {_CSRC_DIR}")
        digest = hashlib.sha256(" ".join(_NVCC_FLAGS).encode())
        for src in sources + sorted(glob.glob(os.path.join(_CSRC_DIR, "*.cuh"))):
            with open(src, "rb") as f:
                digest.update(f.read())
        path = os.path.join(_BUILD_DIR, f"libpgcn_{digest.hexdigest()[:16]}.so")
        t0 = time.perf_counter()
        log = ""
        if not os.path.exists(path):
            os.makedirs(_BUILD_DIR, exist_ok=True)
            tmp = f"{path}.{os.getpid()}.tmp"
            log = _run_nvcc(sources, tmp)
            os.replace(tmp, path)
        lib = ctypes.CDLL(path)
        _declare(lib)
        build_info.update(path=path, seconds=time.perf_counter() - t0, log=log)
        _lib = lib
        return lib


def check(rc: int, what: str) -> None:
    """Raise if a kernel's C entry point returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")
