"""The whole-run path (``mode=scan``): the epoch loop kept on the device.

Port of the JAX package's whole-run program (``train._make_scan_run``,
``parallel.train_parallel.make_parallel_run``), where one jitted
``lax.scan`` or ``lax.while_loop`` runs every epoch without a host round
trip. Here an epoch is a Python function that reads and writes device state
only:

- its dropout seeds: row ``epoch`` of a seed table drawn before the run (each
  epoch's ``train.epoch_seeds``, in the order the eager loop draws them),
  copied into the fixed slots the kernels read (``SeedSlots``);
- the weights and the Adam state, updated in place;
- the epoch counter, the metrics history [epochs, 4] and the stop flag
  (``ScanLoop``).

On a CUDA device the first epoch runs eagerly on a side stream: it builds
the kernels, the packs' cached indexes and cuBLAS's workspaces. The epoch is
then captured as one CUDA graph (capturing runs nothing), and epochs 2..N
are replays of it. A capture that fails raises. With early stopping off the
host reads nothing from the device until the run ends; with k > 0 it copies
the stop flag to pinned memory once every ``POLL_EPOCHS`` epochs and stops
queueing epochs once it reads the flag set, one chunk later. Epochs after
the stop are frozen no-ops, as the JAX loop's ``where(stopped, ...)`` body
makes them. With periodic checkpoints (early stopping off) the host pauses
after every ``every`` epochs, syncs and writes one; the same graph then
replays on, so the history is the unchunked run's. On the CPU the same
epoch function runs uncaptured.

The kernel wrappers count a launch where they enqueue it, so a captured
epoch counts once, at its capture: ``graph_launches`` of the result holds
those counts (kernels and collectives), which every replay launches again.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Sequence

import numpy as np
import torch

from parallel_gcn_tpu_torch.ops import (cuda_bcsr, cuda_ce, cuda_dropout, cuda_fused,
                                        cuda_sddmm, cuda_segment, tile_attention)
from parallel_gcn_tpu_torch.parallel import collectives

# epochs queued between two reads of the stop flag (early stopping only)
POLL_EPOCHS = 8
# epochs run eagerly before the capture (CUDA)
WARMUP_EPOCHS = 1


class SeedSlots:
    """The device memory the dropout kernels read an epoch's seeds from: one
    int64 row in ``train.epoch_seeds``' order and, for a GAT, its attention
    seeds as int32. ``slots`` are 0-d views into the two buffers, one per
    seed, fixed for the run, so a captured epoch reads each epoch's seeds
    from the addresses it was captured with."""

    def __init__(self, n_layers: int, attention: bool, device):
        self.row = torch.zeros(n_layers * (2 if attention else 1), dtype=torch.int64,
                               device=device)
        self.attn = (torch.zeros(n_layers, dtype=torch.int32, device=device)
                     if attention else None)
        if attention:
            self.slots = [s for layer in range(n_layers)
                          for s in (self.row[2 * layer], self.attn[layer])]
        else:
            self.slots = list(self.row.unbind())

    def load(self, row: torch.Tensor) -> None:
        """Write the next epoch's seeds: ``row`` int64 on the device, or in
        pinned host memory (copied without blocking the host)."""
        self.row.copy_(row, non_blocking=True)
        if self.attn is not None:
            self.attn.copy_(self.row[1::2])


def upload_seeds(row: Sequence[int], device) -> torch.Tensor:
    """One epoch's seeds as an int64 tensor that ``SeedSlots.load`` copies
    without blocking: in pinned host memory for a CUDA device (a new buffer
    each call, which the allocator keeps until the copy has run)."""
    host = torch.tensor(list(row), dtype=torch.int64)
    return host.pin_memory() if torch.device(device).type == "cuda" else host


def seed_table(rows: Sequence[Sequence[int]], device) -> torch.Tensor:
    """Every epoch's seeds, int64 [epochs, n_seeds], on ``device`` in one copy."""
    return torch.tensor([list(r) for r in rows], dtype=torch.int64).to(device)


def launch_counts() -> dict:
    """Every kernel wrapper's launch count and every collective's call count,
    by name."""
    out: dict = {}
    for counts in (cuda_dropout.launches, cuda_bcsr.launches, tile_attention.launches,
                   cuda_ce.launches, cuda_fused.launches, cuda_sddmm.launches,
                   cuda_segment.launches, collectives.counts):
        out.update(counts)
    return out


@dataclass
class ScanResult:
    history: np.ndarray  # [epochs_run, 4]: train_loss, train_acc, val_loss, val_acc
    epochs_run: int
    setup_s: float  # CUDA: the warm-up epoch and the capture, ended by a sync
    epoch_s: float  # host wall time of epochs 2..N (CUDA: the replays), one sync, per epoch
    replays: int  # graph replays (0 on the CPU)
    graph_launches: dict = field(default_factory=dict)  # launches and collectives a replay


class ScanLoop:
    """The epochs of one run on ``device``.

    ``step(slots)`` trains one epoch on the seeds in ``slots`` (a
    ``SeedSlots``' views), updating the weights and the Adam state in place,
    and returns the epoch's metrics as a float32 [4] device tensor: train
    loss and accuracy, val loss and accuracy of the updated weights, or, for
    a deferred-eval step (``final_val`` given), of the weights the epoch
    started from. ``final_val()`` then returns the val (loss, accuracy) of
    the current weights, run once after the last epoch, and the val columns
    move up one row. ``state`` lists every tensor ``step`` updates in place;
    with early stopping (``k`` > 0) an epoch after the stop puts them back.
    ``table`` holds every epoch's seeds (``seed_table``). With ``every`` > 0
    (and k = 0), ``checkpoint(n)`` runs on the host after every ``every``
    epochs but the last, the device synced: the state after epoch n of the
    run."""

    def __init__(self, step: Callable, *, state: Sequence[torch.Tensor], seeds: SeedSlots,
                 table: torch.Tensor, k: int, final_val: Callable | None = None, device,
                 every: int = 0, checkpoint: Callable[[int], None] | None = None):
        if final_val is not None and k:
            raise ValueError("the deferred-eval schedule has no early stopping")
        if every and (k or checkpoint is None):
            raise ValueError("periodic checkpoints of a scan need k = 0 and a writer")
        self.device = torch.device(device)
        self.epochs = table.shape[-2]
        self.step, self.state, self.seeds, self.table = step, list(state), seeds, table
        self.k, self.final_val = k, final_val
        self.every, self.checkpoint = every, checkpoint
        dev = self.device
        self.epoch_idx = torch.zeros(1, dtype=torch.int64, device=dev)  # epochs run
        self.stopped = torch.zeros((), dtype=torch.bool, device=dev)
        self.history = torch.zeros((self.epochs, 4), dtype=torch.float32, device=dev)
        self.window = torch.arange(1 - k, 1, device=dev) if k else None
        self.graph: torch.cuda.CUDAGraph | None = None
        self.graph_launches: dict = {}
        self.queued = 0

    def _epoch(self) -> None:
        """One epoch, on device state only (the function a graph captures)."""
        idx = self.epoch_idx
        self.seeds.load(self.table.index_select(0, idx)[0])
        if self.k:
            saved = [t.detach().clone() for t in self.state]
            was_stopped = self.stopped.clone()
        metrics = self.step(self.seeds.slots)
        with torch.no_grad():
            if self.k:
                for t, old in zip(self.state, saved):
                    t.copy_(torch.where(was_stopped, old, t))
                metrics = torch.where(was_stopped, self.history.index_select(0, idx)[0],
                                      metrics)
            self.history.index_copy_(0, idx, metrics.view(1, 4))
            if self.k:
                # the reference's rule: stop when this epoch's val loss exceeds
                # the mean of the last k, this one included (src/gcn.cu:377-395)
                last_k = self.history[:, 2].index_select(0, (idx + self.window).clamp(min=0))
                self.stopped.logical_or_((idx[0] + 1 >= self.k) & (metrics[2] > last_k.mean()))
                idx.add_((~was_stopped).long())
            else:
                idx.add_(1)

    def prepare(self) -> None:
        """On a CUDA device: the warm-up epoch on a side stream, then the
        capture of the epoch; nothing on the CPU. Ends with a sync."""
        if self.device.type != "cuda":
            return
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        warm = min(WARMUP_EPOCHS, self.epochs)
        with torch.cuda.stream(side):
            for _ in range(warm):
                self._epoch()
        torch.cuda.current_stream(self.device).wait_stream(side)
        self.queued = warm
        if warm < self.epochs:
            graph = torch.cuda.CUDAGraph()
            before = launch_counts()
            with torch.cuda.graph(graph):
                self._epoch()
            after = launch_counts()
            self.graph_launches = {key: after[key] - before[key] for key in after
                                   if after[key] != before[key]}
            self.graph = graph
        torch.cuda.synchronize(self.device)

    def epoch(self) -> None:
        """Queue the next epoch: a replay of the captured graph on CUDA."""
        if self.queued >= self.epochs:
            raise RuntimeError(f"all {self.epochs} epochs of the run are queued")
        if self.graph is not None:
            self.graph.replay()
        else:
            self._epoch()
        self.queued += 1

    def _pause(self) -> None:
        """Write a checkpoint where one is due after the queued epochs (the
        run's last is left to the caller's final one)."""
        if self.every and 0 < self.queued < self.epochs and self.queued % self.every == 0:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.checkpoint(self.queued)

    def _stop_flag(self) -> Callable[[], bool]:
        """The stop flag as it stands after the queued epochs, read later:
        a pinned non-blocking copy on CUDA."""
        if self.device.type != "cuda":
            flag = self.stopped.clone()
            return lambda: bool(flag)
        host = torch.empty((), dtype=torch.bool, pin_memory=True)
        host.copy_(self.stopped, non_blocking=True)
        copied = torch.cuda.Event()
        copied.record()

        def read() -> bool:
            copied.synchronize()
            return bool(host)

        return read

    def run(self) -> ScanResult:
        """Every epoch (fewer after an early stop); the one read of the
        history at the end."""
        t0 = time.perf_counter()
        self.prepare()
        setup = time.perf_counter() - t0
        first = self.queued
        t1 = time.perf_counter()
        self._pause()
        pending = None
        while self.queued < self.epochs:
            n = self.epochs - self.queued
            if self.k:
                n = min(n, POLL_EPOCHS)
            if self.every:
                n = min(n, self.every - self.queued % self.every)
            for _ in range(n):
                self.epoch()
            self._pause()
            if self.k:
                # read the flag of the previous chunk while this one runs
                flag = self._stop_flag()
                if pending is not None and pending():
                    break
                pending = flag
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        # a one-epoch run has no epoch after the warm-up: its one epoch's time
        epoch_s = ((time.perf_counter() - t1) / (self.queued - first) if self.queued > first
                   else setup / max(self.queued, 1))
        return self._result(setup if self.device.type == "cuda" else 0.0, epoch_s,
                            self.queued - first if self.graph is not None else 0)

    def _result(self, setup_s: float, epoch_s: float, replays: int) -> ScanResult:
        """The run's result, after the deferred schedule's final val eval."""
        if self.final_val is not None:
            with torch.no_grad():
                val = torch.stack(self.final_val())
                self.history[:, 2:] = torch.cat([self.history[1:, 2:], val[None]])
        epochs_run = int(self.epoch_idx)
        return ScanResult(
            history=self.history[:epochs_run].cpu().numpy(), epochs_run=epochs_run,
            setup_s=setup_s, epoch_s=epoch_s, replays=replays,
            graph_launches=dict(self.graph_launches))
