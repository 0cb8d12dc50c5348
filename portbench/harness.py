"""One run of one cell: set-up, the measured window of whole training runs,
the trace, the metrics and the comparison that decides ``correct``.

A cell is ``workloads/<name>.json`` (its configuration, its traffic, the
chips it needs and the limits of its comparison); a configuration is
``configs/<name>.json``; a traffic mix is ``traffic/<name>.json``, whose
``entry`` names the module that drives the program (``entries/<name>.py``:
its devices, its set-up and its call); a per-layer metric is
``metrics/<name>.py`` with ``read(ctx)``. Everything is found by name, so a
new cell, entry or metric is new files only.

The program under test is ``parallel_gcn_tpu_torch``: its config loader,
launch counters, and what the entries call (its data path and trainers).
Nothing else of it is used here.
"""

from __future__ import annotations

import gc
import importlib
import json
import math
import os
import sys
import time
from dataclasses import dataclass

import numpy as np

from portbench import data as bench_data

PORTBENCH_DIR = bench_data.PORTBENCH_DIR
REPO_DIR = os.path.dirname(PORTBENCH_DIR)
# modules a run may not hold once its window has closed (top-level names)
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "parallel_gcn_tpu")
# epochs of a run the reference follows
REFERENCE_EPOCHS = 3
# epochs of the set-up's warm-up run: the eager epoch, the capture, a replay
WARMUP_EPOCHS = 2
WARMUP_INDEX = 2**31
# what a compared number reads where the program's history is short or not finite
UNREAD = 1e30


def load_json(*parts: str) -> dict:
    with open(os.path.join(PORTBENCH_DIR, *parts)) as f:
        return json.load(f)


@dataclass
class Cell:
    """A workload with its configuration and traffic, read by name."""

    name: str
    workload: dict
    config: dict
    traffic: dict

    @classmethod
    def load(cls, name: str) -> "Cell":
        wl = load_json("workloads", f"{name}.json")
        return cls(name=name, workload=wl, config=load_json("configs", f"{wl['config']}.json"),
                   traffic=load_json("traffic", f"{wl['traffic']}.json"))

    @property
    def lanes(self) -> int:
        return int(self.traffic.get("lanes", 1))

    @property
    def family(self) -> str:
        return self.config["family"]

    def params(self) -> dict:
        """What the reference and the work count read of the configuration,
        from the ``Config`` that the program's own loader makes of it."""
        return model_params(program_config(self, data_dir=""))


def run_seeds(seed: int, index: int, lanes: int) -> list[int]:
    """The seeds of run ``index`` of a window started from ``seed``: one a
    lane, each under 2³², drawn by a ``SeedSequence`` (any size of seed)."""
    return [int(s) for s in np.random.SeedSequence([seed, index]).generate_state(lanes)]


def make_weights(family, params: dict, input_dim: int, n_classes: int, seed: int,
                 device) -> list:
    """The Glorot-uniform float32 leaves of a run, drawn on ``device`` from
    ``seed`` in one call (half-range sqrt(6/(rows+cols)) a leaf)."""
    import torch

    shapes = family.leaf_shapes(params, input_dim, n_classes)
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.rand(sum(r * c for r, c in shapes), generator=gen, device=device)
    out, at = [], 0
    for r, c in shapes:
        half = math.sqrt(6.0 / (r + c))
        out.append(flat[at: at + r * c].view(r, c) * (2 * half) - half)
        at += r * c
    return out


@dataclass
class RunRecord:
    """One training run of the window (all its lanes)."""

    seeds: list
    seconds: float  # host clock around the call, ended by a sync
    histories: list  # a lane's [epochs_run, 4] numpy history
    epochs_run: list
    replays: int
    epoch_s: float  # the program's host time a replay
    graph_launches: dict
    # the allocator at the run's end, on the fullest device (None off CUDA):
    # the process's peak so far, and what is still allocated
    peak_bytes: int | None = None
    allocated_bytes: int | None = None


def entry_module(name: str):
    """The entry ``entries/<name>.py`` that a traffic file names."""
    return importlib.import_module(f"portbench.entries.{name}")


class Entry:
    """The traffic's entry on the program's set-up: every run from fresh
    weights drawn on the first device, timed by the host clock and ended by
    a sync of every device."""

    def __init__(self, cell: Cell, cfg, params: dict, family, devices: list, prepared):
        self.cell, self.cfg, self.params, self.family = cell, cfg, params, family
        self.devices, self.prepared = devices, prepared
        self.module = entry_module(cell.traffic["entry"])
        self.cuda = [d for d in devices if d.type == "cuda"]

    def weights(self, seed: int) -> list:
        g = self.prepared.graph
        return make_weights(self.family, self.params, g["input_dim"], g["n_classes"], seed,
                            self.devices[0])

    def sync(self) -> None:
        import torch

        for d in self.cuda:
            torch.cuda.synchronize(d)

    def run(self, seeds: list[int], epochs: int | None = None) -> RunRecord:
        import torch

        cfg = self.cfg
        saved = cfg.gcn.epochs
        if epochs is not None:
            cfg.gcn.epochs = epochs
        try:
            with _span("portbench::weights"):
                weights = [self.weights(s) for s in seeds]
            self.sync()
            with _span("portbench::run"):
                t0 = time.perf_counter()
                res = self.module.call(self.prepared, cfg, seeds, weights)
                self.sync()
                seconds = time.perf_counter() - t0
        finally:
            cfg.gcn.epochs = saved
        peak = max((torch.cuda.max_memory_allocated(d) for d in self.cuda), default=None)
        held = max((torch.cuda.memory_allocated(d) for d in self.cuda), default=None)
        return RunRecord(seeds=list(seeds), seconds=seconds,
                         histories=[np.asarray(h) for h in res.histories],
                         epochs_run=list(res.epochs_run), replays=res.replays,
                         epoch_s=res.epoch_s, graph_launches=dict(res.graph_launches),
                         peak_bytes=peak, allocated_bytes=held)


def _span(name: str):
    """A host span the trace can name an idle gap by."""
    from torch.profiler import record_function

    return record_function(name)


@dataclass
class Outcome:
    """What one run of a cell measured and checked."""

    correct: bool
    attempted: int
    failed: int
    metrics: dict
    device: dict
    checks: dict
    breakdown: dict | None = None

    def line(self) -> str:
        out = {"correct": self.correct, "attempted": self.attempted, "failed": self.failed,
               "metrics": self.metrics, "device": self.device}
        if self.breakdown is not None:
            out["breakdown"] = self.breakdown
        out["checks"] = self.checks
        return json.dumps(out)


def program_config(cell: Cell, data_dir: str):
    """The program's ``Config`` of the cell: the parameter file with the
    configuration's overrides, the cached data and the whole-run path."""
    from parallel_gcn_tpu_torch.config import load_config

    overrides = dict(cell.config.get("overrides", {}))
    overrides.update(data_dir=data_dir, verbose=False, mode="scan")
    return load_config(os.path.join(PORTBENCH_DIR, cell.config["parameter_file"]), overrides)


def model_params(cfg) -> dict:
    """The model and optimizer numbers of a loaded ``Config``, as the
    reference modules and the work counts take them."""
    g, a = cfg.gcn, cfg.adam
    return dict(n_layers=g.n_layers, hidden_dims=list(g.hidden_dims),
                dropouts=list(g.dropouts), learning_rate=a.learning_rate,
                weight_decay=a.weight_decay, beta1=a.beta1, beta2=a.beta2, eps=a.eps)


@dataclass
class Context:
    """What a per-layer metric's reader may read (``metrics/<name>.py``)."""

    cell: Cell
    runs: list
    setup: dict  # the program's set-up seconds by stage
    trace: object  # devtrace.Trace or None
    work: dict  # the family's ``work``: FLOPs and Â-products a model-epoch
    graph: dict  # n, nnz, input_dim, n_classes, compute dtype bytes
    peaks: dict | None  # the card's row of peaks.json, or None

    @property
    def model_epochs(self) -> int:
        return sum(sum(r.epochs_run) for r in self.runs)


def peaks_for(kind: str) -> dict | None:
    """The row of ``peaks.json`` whose key the card's name contains."""
    for key, row in load_json("peaks.json").items():
        if key in kind:
            return row
    return None


def reader(name: str):
    return importlib.import_module(f"portbench.metrics.{name}")


def per_layer_metrics(cell_name: str) -> list[dict]:
    """``BENCHMARK.json``'s per-layer metrics that this cell reports."""
    with open(os.path.join(REPO_DIR, "BENCHMARK.json")) as f:
        bench = json.load(f)
    return [m for m in bench["per_layer"]
            if cell_name in m.get("workloads", [w["name"] for w in bench["workloads"]])]


def gaps(hist: np.ndarray, ref: np.ndarray) -> dict:
    """The numbers one lane can be compared by, over the reference's epochs
    e: ``loss{e}_gap`` and ``val{e}_gap``, the relative gap of the train
    and the val loss; ``drop_gap`` and ``val_drop_gap``, the worst relative
    gap of their fall from epoch 1; ``acc_gap``, the worst gap of the train
    or val accuracy. A cell compares those its ``limits`` name. A history
    that is short or not finite reads ``UNREAD`` (a finite number, so the
    result line stays JSON)."""
    e = len(ref)
    keys = [f"{k}{i + 1}_gap" for i in range(e) for k in ("loss", "val")]
    keys += ["drop_gap", "val_drop_gap", "acc_gap"]
    if len(hist) < e or not np.all(np.isfinite(hist[:e])):
        return dict.fromkeys(keys, UNREAD)
    p = hist[:e].astype(np.float64)
    out = {}
    for i in range(e):
        out[f"loss{i + 1}_gap"] = float(abs(p[i, 0] - ref[i, 0]) / abs(ref[i, 0]))
        out[f"val{i + 1}_gap"] = float(abs(p[i, 2] - ref[i, 2]) / abs(ref[i, 2]))
    for key, col in (("drop_gap", 0), ("val_drop_gap", 2)):
        fall_p, fall_r = p[0, col] - p[1:, col], ref[0, col] - ref[1:, col]
        out[key] = float(np.max(np.abs(fall_p - fall_r) / np.abs(fall_r)))
    out["acc_gap"] = float(np.max(np.abs(p[:, [1, 3]] - ref[:, [1, 3]])))
    return out


def compare(cell: Cell, lanes: list, ref_data, precision: str = "float32",
            fault: str | None = None) -> list[dict]:
    """Each lane's numbers against the plain reference on ``ref_data``
    (``reference.common.RefData``): ``lanes`` holds (seed, history) pairs
    of runs that the window produced; the reference follows each from the
    same weights and seeds. A history of None puts the reference there in
    the program's place, in ``precision`` or with ``fault`` (the control and
    the faults)."""
    from portbench.reference.common import family, follow

    fam = family(cell.family)
    params = cell.params()
    device = ref_data.x.device
    out = []
    for seed, hist in lanes:
        weights = make_weights(fam, params, ref_data.x.shape[1], ref_data.n_classes, seed, device)
        ref = follow(cell.family, ref_data, params, weights, seed, REFERENCE_EPOCHS)
        if hist is None:
            hist = follow(cell.family, ref_data, params, weights, seed, REFERENCE_EPOCHS,
                          precision=precision, fault=fault)
        out.append({**gaps(np.asarray(hist), ref),
                    "_program": np.asarray(hist)[:REFERENCE_EPOCHS].tolist(),
                    "_reference": ref.tolist()})
    return out


def judge(cell: Cell, per_lane: list[dict]) -> tuple[bool, int, dict]:
    """(correct, failed lanes, checks): each compared number's worst value
    over the lanes beside its limit (``limits`` of the workload file)."""
    limits = cell.workload["limits"]
    failed = sum(any(not lane[k] <= lim for k, lim in limits.items()) for lane in per_lane)
    checks = {k: {"value": float(max(lane[k] for lane in per_lane)), "limit": lim}
              for k, lim in limits.items()}
    return failed == 0 and bool(per_lane), failed, checks


@dataclass
class Setup:
    """A cell's program, ready for its window."""

    cfg: object
    entry: Entry
    stages: dict  # the program's set-up seconds by stage
    graph: dict  # n, nnz, input_dim, n_classes
    data_dir: str
    devices: list


def set_up(cell: Cell, seed: int, log, require_cuda: bool = True) -> Setup:
    """The cell's devices (its entry's), the data made or read, the entry's
    set-up of the program, and one warm-up run of the cell's shapes
    (``WARMUP_EPOCHS`` epochs)."""
    from portbench.reference.common import family

    module = entry_module(cell.traffic["entry"])
    devices = module.devices(cell, require_cuda)
    data_dir = bench_data.ensure(cell.config["data"], log=log)
    cfg = program_config(cell, data_dir)
    prepared = module.prepare(cell, cfg, devices)
    entry = Entry(cell, cfg, model_params(cfg), family(cell.family), devices, prepared)
    entry.run(run_seeds(seed, WARMUP_INDEX, cell.lanes), epochs=WARMUP_EPOCHS)
    return Setup(cfg=cfg, entry=entry, stages=prepared.stages, graph=prepared.graph,
                 data_dir=data_dir, devices=devices)


def release(devices: list) -> None:
    """Free what the program left on the devices before the reference runs."""
    import torch

    gc.collect()
    if any(d.type == "cuda" for d in devices):
        torch.cuda.empty_cache()


def run(cell_name: str, seed: int, seconds: float, trace: bool, *, t_start: float,
        require_cuda: bool = True, log=None) -> Outcome:
    """One run of ``cell_name``: set-up, window, (trace), metrics, check."""
    import torch

    from parallel_gcn_tpu_torch.scan import launch_counts

    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    cell = Cell.load(cell_name)
    chips = int(cell.workload["chips"])
    su = set_up(cell, seed, log, require_cuda)
    entry, cfg, fam, setup, graph_stats = su.entry, su.cfg, su.entry.family, su.stages, su.graph
    device, cuda = su.devices[0], entry.cuda
    setup_s = time.perf_counter() - t_start

    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        prof = profile(activities=acts)
        prof.__enter__()
    counts0 = launch_counts()
    runs: list[RunRecord] = []
    with _span("portbench::window"):
        w0 = time.perf_counter()
        while True:
            runs.append(entry.run(run_seeds(seed, len(runs), cell.lanes)))
            elapsed = time.perf_counter() - w0
            if elapsed + elapsed / len(runs) > seconds:
                break
        window_s = time.perf_counter() - w0
    counts1 = launch_counts()
    tr = None
    if prof is not None:
        prof.__exit__(None, None, None)
        from portbench import devtrace

        tr = devtrace.read_trace(prof)
        del prof
        if cuda:
            launched = {k: counts1[k] - counts0[k] for k in counts1}
            for r in runs:
                for k, v in r.graph_launches.items():
                    launched[k] = launched.get(k, 0) + v * (r.replays - 1)
            tr.shortfall = devtrace.lost_records(tr.ops, launched)
            if tr.shortfall:
                log(f"trace: fewer records than launches: {tr.shortfall}")
    # the process's peak on the fullest device: over the whole window for
    # the device line; after set-up and the window's first run for
    # peak_mem_gib, a fixed amount of work however many runs the window holds
    memory_peak = max((torch.cuda.max_memory_allocated(d) for d in cuda), default=0)
    model_epochs = sum(sum(r.epochs_run) for r in runs)

    dev_info = {"platform": "gpu" if cuda else "cpu",
                "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
                "count": chips, "memory_peak_bytes": int(memory_peak)}
    metrics: dict = {}
    breakdown = None
    if not trace:
        metrics["epoch_ms"] = {"value": window_s * 1e3 / model_epochs, "unit": "ms"}
        metrics["peak_mem_gib"] = {"value": (runs[0].peak_bytes or 0) / 2**30, "unit": "GiB"}
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}
    else:
        dtype_bytes = 2 if str(cfg.tpu.compute_dtype) in ("bfloat16", "float16") else 4
        ctx = Context(cell=cell, runs=runs, setup=setup, trace=tr,
                      work=fam.work(entry.params, graph_stats["n"], graph_stats["nnz"],
                                    graph_stats["input_dim"], graph_stats["n_classes"]),
                      graph={**graph_stats, "dtype_bytes": dtype_bytes},
                      peaks=peaks_for(dev_info["kind"]))
        for m in per_layer_metrics(cell_name):
            value = reader(m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        if tr is not None:
            dev_info["busy_s"] = tr.busy_s()
            dev_info["window_s"] = tr.window_s
            top = sorted(tr.ops.items(), key=lambda kv: -kv[1][0])[:10]
            breakdown = {"device_ops": [[name[:160], sec] for name, (sec, _) in top],
                         "idle_gaps": [[name[:160], sec] for name, sec in tr.idle_gaps(10)]}
            del tr
    log(f"window: {len(runs)} runs x {cell.lanes} lanes, {model_epochs} model-epochs in "
        f"{window_s:.3f} s; set-up {setup_s:.3f} s (program stages: "
        + ", ".join(f"{k} {v:.2f}" for k, v in setup.items()) + "); runs (s): "
        + " ".join(f"{r.seconds:.3f}" for r in runs) + "; allocated after each (GiB): "
        + " ".join(f"{(r.allocated_bytes or 0) / 2**30:.4f}" for r in runs))

    lanes = [(s, h) for r in runs for s, h in zip(r.seeds, r.histories)]
    data_dir, devices = su.data_dir, su.devices
    del su, entry, runs
    release(devices)
    from portbench.reference.common import RefData

    per_lane = compare(cell, lanes, RefData(bench_data.load_reference_arrays(data_dir), device))
    correct, failed, checks = judge(cell, per_lane)
    return Outcome(correct=correct, attempted=len(lanes), failed=failed, metrics=metrics,
                   device=dev_info, checks=checks, breakdown=breakdown)


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is one the run may not hold."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN_MODULES))

