"""Device-side profiling: an op table from ``torch.profiler``.

Port of ``parallel_gcn_tpu/utils/profiling.py``, which reads a
``jax.profiler`` trace. ``profile_fn`` runs a function under
``torch.profiler`` (CUDA activity on the card, CPU activity on the CPU),
``summarize_trace`` sums the time of each device op and ``print_trace_summary``
prints it. ``report`` adds what the JAX package's table lacks: the time by
category (each kernel of the port, GEMMs, the PyTorch ops between them), the
device's idle share against a host clock, and a check that the trace is
whole.

On the card the ops are the trace's kernel, memcpy and memset records,
read from the exported chrome trace: the profiler's ``key_averages`` has been
seen to miss part of a CUDA graph's replay. A profile starts with warm-up
steps outside the trace, since a cold profile has been seen to miss part of
the first replay of a mesh epoch. On the CPU the ops are the CPU ops by
their self time.

A trace can lose records. The kernel wrappers count their launches
(``scan.launch_counts``), so the table compares the launches it sees of each
kernel with the launches the wrappers made in the traced steps, profiles
once more when it sees fewer, and prints the shortfall when the second trace
is short too.
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from dataclasses import dataclass, field
from typing import Callable

import torch

# kernel categories: the first key a kernel's name contains names it
_CATEGORIES = (
    ("::ce_kernel", "K9 masked CE"),
    # K10 over seed lanes (seeds.fit_seeds)
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
    # the padded v / g rows that K5, K6 and K7 copy before their walks
    ("pad_heads_kernel", "K5/K6/K7 padded rows"),
    ("gat_bwd_rect_row_kernel", "K7 row sweep"),
    ("gat_bwd_rect_col_kernel", "K7 column sweep"),
    ("merge_segments_kernel<false>", "K6/K7 ordered merge"),
    ("nccl", "collectives (NCCL)"),
    # the ordered sums of the COO residual (and the halo's cotangent)
    ("pgcn_seg::", "scatter/index (residual)"),
    ("dropout_kernel", "K1 dropout"), ("gemm", "GEMMs"), ("gemv", "GEMMs"),
    ("xmma", "GEMMs"), ("nvjet", "GEMMs"), ("cutlass", "GEMMs"),
    ("scatter", "scatter/index (residual)"),
    ("index", "scatter/index (residual)"), ("reduce", "reductions"),
    ("Memcpy", "copies"), ("Memset", "copies"),
)

# the kernels each wrapper launches, for the trace's check: wrapper keys
# (``scan.launch_counts``) -> the names of the kernels one counted launch
# starts (one of them a launch)
LAUNCHED = (
    (("dropout", "relu_dropout"), ("::dropout_kernel<",)),
    (("dropout_lanes", "relu_dropout_lanes"), ("::dropout_lanes_kernel<",)),
    (("relu_dropout_lanes_bwd",), ("::dropout_lanes_bwd_kernel<",)),
    (("bcsr", "bcsr_scaled", "bcsr_rect", "bcsr_f32", "bcsr_scaled_f32", "bcsr_rect_f32",
      "bcsr_scaled_wide"),
     ("spmm_pipe_kernel", "spmm_fma_kernel", "spmm_walk_kernel")),
    (("gat_fwd", "gat_fwd_rect"), ("gat_fwd_kernel",)),
    (("gat_bwd",), ("gat_bwd_kernel",)),
    (("gat_bwd_rect_row",), ("gat_bwd_rect_row_kernel",)),
    (("gat_bwd_rect_col",), ("gat_bwd_rect_col_kernel",)),
    (("ce_train", "ce_eval"), ("::ce_kernel<",)),
    (("fused_fwd",), ("fwd_mma_kernel", "fwd_fma_kernel")),
    (("fused_dw",), ("dw_mma_kernel", "dw_fma_kernel")),
    (("fused_dx",), ("dx_kernel<", "dx_mma_kernel")),
    (("fused_fwd_lanes",), ("fwd_mma_lanes_kernel", "fwd_fma_lanes_kernel",
                            "fwd_fma_shared_kernel")),
    (("fused_dw_lanes",), ("dw_mma_lanes_kernel", "dw_fma_lanes_kernel")),
    (("fused_dx_lanes",), ("dx_lanes_kernel<", "dx_mma_lanes_kernel")),
    (("sddmm",), ("sddmm_",)),
    (("gather_sum", "segment_sum"), ("_walk_kernel<",)),
    (("gather_sum_hub", "segment_sum_hub"), ("_hub_kernel<",)),
)

_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def category(op: str) -> str:
    """The category of a device op (a kernel's name) in ``report``'s table."""
    for key, cat in _CATEGORIES:
        if key in op:
            return cat
    return "other elementwise"


@dataclass
class Profile:
    """The ops of ``steps`` profiled calls: ``ops`` maps an op's name to
    [total ms, records] over the steps (device ops on the card, CPU ops by
    self time on the CPU); ``host_ms`` the host clock of each call;
    ``shortfall`` each kernel family of ``LAUNCHED`` whose records are
    fewer than the launches its wrappers made (seen, counted); ``attempts``
    the traces taken."""

    device: str
    steps: int
    ops: dict
    host_ms: list
    records: int
    shortfall: dict = field(default_factory=dict)
    attempts: int = 1

    @property
    def op_ms(self) -> float:
        """The ops' ms a step."""
        return sum(ms for ms, _ in self.ops.values()) / self.steps


def _chrome_trace(prof) -> dict:
    """The profiler's trace (its chrome-trace JSON) as a dict."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)


def trace_ops(trace: dict) -> dict:
    """A chrome trace's device records (kernels, memcpys, memsets): name ->
    [total ms, records]."""
    ops: dict = {}
    for evt in trace["traceEvents"]:
        if evt.get("ph") == "X" and evt.get("cat") in _DEVICE_CATS:
            entry = ops.setdefault(evt["name"], [0.0, 0])
            entry[0] += evt["dur"] / 1e3
            entry[1] += 1
    return ops


def lost_records(ops: dict, launched: dict) -> dict:
    """The kernel families of ``LAUNCHED`` whose records in ``ops`` (as
    ``trace_ops`` gives them) are fewer than their wrappers' ``launched``
    counts: family name -> (records seen, launches counted)."""
    short = {}
    for keys, names in LAUNCHED:
        counted = sum(launched.get(k, 0) for k in keys)
        if not counted:
            continue
        seen = sum(n for op, (_, n) in ops.items() if any(name in op for name in names))
        if seen < counted:
            short["/".join(keys)] = (seen, counted)
    return short


def _launch_counts() -> dict:
    from parallel_gcn_tpu_torch.scan import launch_counts

    return launch_counts()


def _trace_once(fn, args, reps: int, warmup: int, cuda: bool):
    """``fn(*args)`` ``warmup`` times under the profiler's warm-up and
    ``reps`` times under its trace: (the last result, the ops, the host ms
    of the traced calls, the wrappers' launches in the traced calls)."""
    from torch.profiler import ProfilerActivity, profile, schedule

    ops: list = []
    host_ms, counts = [], [None, None]
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])

    def ready(prof):
        if cuda:
            ops.append(trace_ops(_chrome_trace(prof)))
        else:
            ops.append({e.key: [e.self_cpu_time_total / 1e3, e.count]
                        for e in prof.key_averages()
                        if e.self_cpu_time_total > 0 and not e.key.startswith("ProfilerStep")})

    out = None
    with profile(activities=activities,
                 schedule=schedule(wait=0, warmup=warmup, active=reps, repeat=1),
                 on_trace_ready=ready) as prof:
        for i in range(warmup + reps):
            if i == warmup:
                counts[0] = _launch_counts()
            t0 = time.perf_counter()
            out = fn(*args)
            if cuda:
                torch.cuda.synchronize()
            host_ms.append((time.perf_counter() - t0) * 1e3)
            prof.step()
    counts[1] = _launch_counts()
    launched = {k: counts[1][k] - counts[0][k] for k in counts[1]}
    return out, ops[0], host_ms[warmup:], launched


def profile_fn(fn: Callable, *args, reps: int = 1, warmup: int = 1,
               device: str | torch.device | None = None,
               per_step: dict | None = None):
    """Run ``fn(*args)`` under ``torch.profiler``: ``warmup`` calls
    untraced, then ``reps`` traced, each ended by a sync on the card.
    ``device`` (default: the card when there is one) picks the activity.
    ``per_step`` gives the kernel launches each call makes where the
    wrappers do not count them as it runs (a CUDA graph's replay:
    ``ScanResult.graph_launches``); otherwise the wrappers' counts over the
    traced calls are the launches. A trace that holds fewer launches than
    that is taken once more. Returns (the last result, a ``Profile``)."""
    dev = torch.device(device or ("cuda" if torch.cuda.is_available() else "cpu"))
    cuda = dev.type == "cuda"
    attempts = 0
    while True:
        attempts += 1
        out, ops, host_ms, launched = _trace_once(fn, args, reps, warmup, cuda)
        if per_step is not None:
            launched = {k: v * reps for k, v in per_step.items()}
        short = lost_records(ops, launched) if cuda or per_step is not None else {}
        if not short or attempts == 2:
            break
    records = sum(n for _, n in ops.values())
    return out, Profile(device=dev.type, steps=reps, ops=ops, host_ms=host_ms, records=records,
                        shortfall=short, attempts=attempts)


def summarize_trace(profile: Profile, top: int = 20) -> list[tuple[str, float, int]]:
    """[(op, total_ms, count)] over the profiled steps, longest first: the
    device ops on the card, the CPU ops on the CPU."""
    rows = sorted(profile.ops.items(), key=lambda kv: -kv[1][0])[:top]
    return [(name, ms, n) for name, (ms, n) in rows]


def print_trace_summary(profile: Profile, top: int = 20) -> None:
    for name, ms, count in summarize_trace(profile, top):
        print(f"{ms:10.3f} ms  x{count:<6} {name[:80]}")


def report(label: str, profile: Profile, host_ms: float | None = None, top: int = 10) -> float:
    """Print the ops' ms a step against ``host_ms`` a step (default: the
    profiled calls' host clock), the device's idle share, the time by
    ``category`` and the ``top`` ops, and whether the trace is whole;
    returns the ops' ms a step."""
    steps, prefix = profile.steps, "[profile]"
    host_ms = sum(profile.host_ms) / steps if host_ms is None else host_ms
    op_ms = profile.op_ms
    if profile.device == "cuda":
        print(f"{prefix} {label}: {host_ms:.3f} ms/epoch host clock, {op_ms:.3f} ms/epoch "
              f"device time ({profile.records / steps:.0f} device records an epoch), device idle "
              f"{100 * (1 - op_ms / host_ms):.1f}%")
    else:
        print(f"{prefix} {label}: {host_ms:.3f} ms/epoch host clock, {op_ms:.3f} ms/epoch "
              f"in CPU ops (self time; the CPU, no device time)")
    if profile.shortfall:
        print(f"{prefix}   the trace is short after {profile.attempts} traces: "
              + ", ".join(f"{fam} {seen} records of {counted} launches"
                          for fam, (seen, counted) in profile.shortfall.items()))
    elif profile.attempts > 1:
        print(f"{prefix}   the first trace was short; the second holds every launch")
    if op_ms == 0:
        print(f"{prefix} the profiler saw no device time: device time not measured")
        return op_ms
    by_cat: dict = {}
    for name, (ms, _) in profile.ops.items():
        cat = category(name) if profile.device == "cuda" else "CPU ops"
        by_cat[cat] = by_cat.get(cat, 0.0) + ms / steps
    for cat, ms in sorted(by_cat.items(), key=lambda kv: -kv[1]):
        print(f"{prefix}   {cat:28s} {ms:9.3f} ms/epoch {100 * ms / op_ms:5.1f}%")
    kind = "kernel" if profile.device == "cuda" else "op"
    for name, ms, _ in summarize_trace(profile, top):
        print(f"{prefix}   {kind} {ms / steps:9.3f} ms/epoch  {name[:110]}")
    return op_ms


def kernel_ms(fn: Callable[[], object], reps: int, *names: str) -> float:
    """Mean device ms a call of ``fn`` in kernels whose names contain one of
    ``names``, by ``torch.profiler`` on the card, after one warm-up call: a
    short kernel's own time, which the host's launch cost hides from
    ``utils.timer.events_ms``. A profile that saw none of them (a few µs of
    kernels) is taken again, up to 5 times."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total = sum(evt.device_time_total for evt in prof.events()
                    if evt.device_type == torch.autograd.DeviceType.CUDA
                    and any(name in evt.name for name in names))
        if total > 0:
            break
    if total <= 0:
        raise RuntimeError(f"the profiler saw no {names} kernel")
    return total / 1e3 / reps
