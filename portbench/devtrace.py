"""The device trace of a window: its ops, their categories, the device's
busy time and idle gaps, and the check that the trace lost no launch.

The category table, the launch families and the lost-record check are a
frozen copy of the program's ``utils/profiling.py`` (kept here so that the
yardstick does not move with the program): a kernel belongs to the first
category whose key its name contains. The device ops are the trace's kernel,
memcpy and memset records, read from the exported chrome trace.
"""

from __future__ import annotations

import json
import os
import tempfile
from dataclasses import dataclass, field

CATEGORIES = (
    ("::ce_kernel", "K9 masked CE"),
    ("fwd_mma_lanes_kernel", "K10 fused fwd (lanes)"),
    ("fwd_fma_lanes_kernel", "K10 fused fwd (lanes)"),
    ("fwd_fma_shared_kernel", "K10 fused fwd (lanes)"),
    ("dw_mma_lanes_kernel", "K10 fused dW (lanes)"),
    ("dw_fma_lanes_kernel", "K10 fused dW (lanes)"),
    ("reduce_splits_lanes_kernel", "K10 fused dW (lanes)"),
    ("dx_mma_lanes_kernel", "K10 fused dX (lanes)"),
    ("dx_lanes_kernel<", "K10 fused dX (lanes)"),
    ("dx_wfrag_kernel", "K10 fused dX (lanes)"),
    ("fwd_mma_kernel", "K10 fused fwd"), ("fwd_fma_kernel", "K10 fused fwd"),
    ("dw_mma_kernel", "K10 fused dW"), ("dw_fma_kernel", "K10 fused dW"),
    ("reduce_splits_kernel", "K10 fused dW"), ("dx_kernel<", "K10 fused dX"),
    ("dx_mma_kernel", "K10 fused dX"),
    ("spmm_pipe_kernel", "K3/K4 tile SpMM"),
    ("spmm_walk_kernel", "K3/K4 tile SpMM"),
    ("sddmm_", "K8 sddmm"),
    ("spmm_fma_kernel", "K3/K4 tile SpMM"),
    ("reduce_segments_kernel", "K3/K4 tile SpMM"),
    ("dropout_lanes_bwd_kernel", "K2 relu_dropout backward (lanes)"),
    ("dropout_lanes_kernel<__nv_bfloat16, true>", "K2 relu_dropout (lanes)"),
    ("dropout_lanes_kernel<float, true>", "K2 relu_dropout (lanes)"),
    ("dropout_lanes_kernel", "K1 dropout (lanes)"),
    ("dropout_kernel<__nv_bfloat16, true>", "K2 relu_dropout"),
    ("dropout_kernel<float, true>", "K2 relu_dropout"),
    ("gat_fwd_kernel", "K5 gat_fwd"), ("merge_segments_kernel<true>", "K5 gat_fwd"),
    ("gat_bwd_kernel", "K6 gat_bwd"),
    ("pad_heads_kernel", "K5/K6/K7 padded rows"),
    ("gat_bwd_rect_row_kernel", "K7 row sweep"),
    ("gat_bwd_rect_col_kernel", "K7 column sweep"),
    ("merge_segments_kernel<false>", "K6/K7 ordered merge"),
    ("nccl", "collectives (NCCL)"),
    ("pgcn_seg::", "scatter/index (residual)"),
    ("dropout_kernel", "K1 dropout"), ("gemm", "GEMMs"), ("gemv", "GEMMs"),
    ("xmma", "GEMMs"), ("nvjet", "GEMMs"), ("cutlass", "GEMMs"),
    ("scatter", "scatter/index (residual)"),
    ("index", "scatter/index (residual)"), ("reduce", "reductions"),
    ("Memcpy", "copies"), ("Memset", "copies"),
)

# launch-counter keys (the program's ``scan.launch_counts``) -> the names of
# the kernels one counted launch starts
LAUNCHED = (
    (("dropout", "relu_dropout"), ("::dropout_kernel<",)),
    (("dropout_lanes", "relu_dropout_lanes"), ("::dropout_lanes_kernel<",)),
    (("relu_dropout_lanes_bwd",), ("::dropout_lanes_bwd_kernel<",)),
    (("bcsr", "bcsr_scaled", "bcsr_rect", "bcsr_f32", "bcsr_scaled_f32", "bcsr_rect_f32"),
     ("spmm_pipe_kernel", "spmm_fma_kernel", "spmm_walk_kernel")),
    (("gat_fwd", "gat_fwd_rect"), ("gat_fwd_kernel",)),
    (("gat_bwd",), ("gat_bwd_kernel",)),
    (("ce_train", "ce_eval"), ("::ce_kernel<",)),
    (("fused_fwd",), ("fwd_mma_kernel", "fwd_fma_kernel")),
    (("fused_dw",), ("dw_mma_kernel", "dw_fma_kernel")),
    (("fused_dx",), ("dx_kernel<", "dx_mma_kernel")),
    (("gather_sum", "segment_sum"), ("_walk_kernel<",)),
    (("gather_sum_hub", "segment_sum_hub"), ("_hub_kernel<",)),
)

_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def category(op: str) -> str:
    for key, cat in CATEGORIES:
        if key in op:
            return cat
    return "other elementwise"


@dataclass
class Trace:
    """A window's device ops: ``ops`` name -> [seconds, records];
    ``intervals`` the device ops' (start, end) in seconds of the trace's
    clock; ``host`` the host events (name, start, end) that may name an idle
    gap; ``window`` the window's (start, end) on the same clock."""

    ops: dict
    intervals: list
    host: list
    window: tuple
    shortfall: dict = field(default_factory=dict)

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def busy_s(self) -> float:
        """Seconds in which at least one device op ran, inside the window."""
        lo, hi = self.window
        busy, end = 0.0, lo
        for s, e in sorted(self.intervals):
            s, e = max(s, end), min(e, hi)
            if e > s:
                busy += e - s
                end = e
        return busy

    def seconds(self, *keys: str) -> float:
        """Device seconds of the ops whose names contain one of ``keys``."""
        return sum(sec for name, (sec, _) in self.ops.items() if any(k in name for k in keys))

    def idle_gaps(self, top: int = 10) -> list:
        """The ``top`` longest idle gaps in the window, each named by the
        benchmark's span and the host event that overlap it most (the
        innermost on a tie): [(name, s)]."""
        lo, hi = self.window
        gaps, end = [], lo
        for s, e in sorted(self.intervals):
            if s > end:
                gaps.append((end, min(s, hi)))
            end = max(end, e)
            if end >= hi:
                break
        if end < hi:
            gaps.append((end, hi))
        gaps = sorted((g for g in gaps if g[1] > g[0]), key=lambda g: g[0] - g[1])[:top]
        out = []
        for gs, ge in gaps:
            names = []
            for is_span in (True, False):
                best, key = None, (0.0, 0.0)
                for name, hs, he in self.host:
                    if name.startswith("portbench::") != is_span:
                        continue
                    ov = min(ge, he) - max(gs, hs)
                    if ov > 0 and (ov, hs - he) > key:
                        best, key = name, (ov, hs - he)
                if best is not None:
                    names.append(best)
            out.append((" / ".join(names) or "no host event", ge - gs))
        return out


WINDOW_SPAN = "portbench::window"


def read_trace(prof) -> Trace:
    """The ``Trace`` of a ``torch.profiler`` run whose window is the host
    span ``WINDOW_SPAN`` (a ``record_function``); times in seconds of the
    trace's clock."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    span = [e for e in events if e.get("name") == WINDOW_SPAN]
    if len(span) != 1:
        raise RuntimeError(f"the trace holds {len(span)} {WINDOW_SPAN} spans, not 1")
    window = (span[0]["ts"] / 1e6, (span[0]["ts"] + span[0]["dur"]) / 1e6)
    ops, intervals, host = {}, [], []
    for evt in events:
        s = evt["ts"] / 1e6
        e = s + evt.get("dur", 0) / 1e6
        if evt.get("cat") in _DEVICE_CATS:
            if e <= window[0] or s >= window[1]:
                continue
            entry = ops.setdefault(evt["name"], [0.0, 0])
            entry[0] += evt["dur"] / 1e6
            entry[1] += 1
            intervals.append((s, e))
        elif evt.get("cat") in ("cpu_op", "user_annotation", "cuda_runtime") \
                and evt["name"] != WINDOW_SPAN:
            host.append((evt["name"], s, e))
    return Trace(ops=ops, intervals=intervals, host=host, window=window)


def lost_records(ops: dict, launched: dict) -> dict:
    """The launch families whose records in ``ops`` are fewer than the
    launches counted: family -> (records seen, launches counted)."""
    short = {}
    for keys, names in LAUNCHED:
        counted = sum(launched.get(k, 0) for k in keys)
        if not counted:
            continue
        seen = sum(n for op, (_, n) in ops.items() if any(name in op for name in names))
        if seen < counted:
            short["/".join(keys)] = (seen, counted)
    return short
