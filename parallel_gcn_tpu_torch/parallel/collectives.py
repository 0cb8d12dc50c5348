"""Collectives of the node-partitioned trainer, with autograd.

The JAX package runs its mesh step inside ``shard_map`` and lets autodiff
transpose the collectives (``all_gather`` into a sum ``psum_scatter``,
``all_to_all`` into the reverse ``all_to_all``). Here each rank is a process
of a ``torch.distributed`` world, and the halo exchanges are autograd
Functions with those transposes written out:

- ``gather_buffer(x_local, None)``: the all_gather halo, ``all_gather`` of
  every rank's rows; backward: a sum reduce-scatter;
- ``gather_buffer(x_local, send)``: the boundary halo, ``index_select``
  of the rows each peer needs (``send``, the ``Segments`` of the sent local
  rows), one ``all_to_all_single`` and a concatenation ``[x_local ; halo]``;
  backward: the reverse ``all_to_all_single`` of the halo's cotangent, then
  its rows summed into the sent rows in order (``ops.cuda_segment``; a row
  sent to several peers repeats).

The ring and adaptive halos call two more without autograd (their
aggregations are self-adjoint, ``parallel.train_parallel``):
``ppermute_rows``, the ring's rotation (this rank's rows to rank + 1, rank
− 1's rows back: one ``all_to_all_single`` with one live split, which NCCL
runs as one send and one receive and a CUDA graph captures), and
``all_to_all_rows`` for the push slabs.

``all_reduce_sum`` reduces gradients and metrics. ``counts`` counts every
collective call by kind, so tests can pin an epoch step's structure.

``world`` joins the world ``torch.distributed`` already has (torchrun), or
starts a world of one process over a ``FileStore`` in a temporary directory
(NCCL for CUDA tensors, gloo for CPU ones), which needs no network.
"""

from __future__ import annotations

import contextlib
import os
import shutil
import tempfile

import torch
import torch.distributed as dist

from parallel_gcn_tpu_torch.ops.cuda_segment import Segments, segment_sum_

# collective calls by kind
counts = {"all_gather": 0, "reduce_scatter": 0, "all_to_all": 0, "all_reduce": 0,
          "ppermute": 0}

# all_gather_single / reduce_scatter_single are the newer names
_all_gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor

MESH_COMMAND = ("torchrun --standalone --nproc_per_node={n} -m parallel_gcn_tpu_torch "
                "<dataset> n_devices={n} [key=value ...]")


@contextlib.contextmanager
def world(n_devices: int, device: torch.device):
    """Yield (rank, world size) of the world this process belongs to.

    With a world already initialized it must have ``n_devices`` ranks. With
    none, ``n_devices`` must be 1: a world of one is started here (backend
    ``cpu:gloo,cuda:nccl`` when ``device`` is CUDA, ``gloo`` otherwise) and
    destroyed on exit."""
    if dist.is_initialized():
        size = dist.get_world_size()
        if size != n_devices:
            raise RuntimeError(f"n_devices={n_devices} in a torch.distributed world of "
                               f"{size} ranks")
        yield dist.get_rank(), size
        return
    if n_devices != 1:
        raise RuntimeError(
            f"n_devices={n_devices} needs a torch.distributed world of {n_devices} "
            f"processes, one per GPU: {MESH_COMMAND.format(n=n_devices)}"
        )
    store_dir = tempfile.mkdtemp(prefix="pgcn_world_")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    backend = "cpu:gloo,cuda:nccl" if device.type == "cuda" else "gloo"
    try:
        dist.init_process_group(backend, init_method=f"file://{store_dir}/store",
                                rank=0, world_size=1)
        yield 0, 1
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        shutil.rmtree(store_dir, ignore_errors=True)


def local_device(device: torch.device) -> torch.device:
    """This rank's device: ``cuda:<LOCAL_RANK>`` for CUDA (torchrun sets the
    variable; 0 without it), the CPU as given."""
    if device.type != "cuda":
        return device
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", device.index or 0)))


def all_gather_rows(x: torch.Tensor) -> torch.Tensor:
    """[n_local, F] on every rank -> [world·n_local, F], rank order."""
    x = x.contiguous()
    out = x.new_empty((dist.get_world_size() * x.shape[0], *x.shape[1:]))
    _all_gather(out, x)
    counts["all_gather"] += 1
    return out


def reduce_scatter_rows(x: torch.Tensor) -> torch.Tensor:
    """[world·n_local, F] on every rank -> [n_local, F]: the sum over ranks
    of each rank's block for this rank."""
    x = x.contiguous()
    out = x.new_empty((x.shape[0] // dist.get_world_size(), *x.shape[1:]))
    _reduce_scatter(out, x)
    counts["reduce_scatter"] += 1
    return out


def all_to_all_rows(x: torch.Tensor) -> torch.Tensor:
    """Equal chunks: chunk d of this rank's rows goes to rank d, and chunk b
    of the result came from rank b."""
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x)
    counts["all_to_all"] += 1
    return out


def ppermute_rows(x: torch.Tensor) -> torch.Tensor:
    """The ring's rotation: this rank's rows go to rank + 1 and the result
    holds rank − 1's (mod the world size). A world of one returns ``x``
    and calls no backend."""
    world = dist.get_world_size()
    if world == 1:
        return x
    x = x.contiguous()
    out = torch.empty_like(x)
    rank, n = dist.get_rank(), x.shape[0]
    send = [0] * world
    recv = [0] * world
    send[(rank + 1) % world] = n
    recv[(rank - 1) % world] = n
    dist.all_to_all_single(out, x, output_split_sizes=recv, input_split_sizes=send)
    counts["ppermute"] += 1
    return out


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over ranks, in place; returns ``x``."""
    dist.all_reduce(x, op=dist.ReduceOp.SUM)
    counts["all_reduce"] += 1
    return x


def halo_rows(x_local: torch.Tensor, send: Segments) -> torch.Tensor:
    """The boundary exchange without autograd: ``[x_local ; rows received
    from each peer]``."""
    return torch.cat([x_local, all_to_all_rows(x_local.index_select(0, send.index))])


def buffer_rows(x_local: torch.Tensor, send: Segments | None) -> torch.Tensor:
    """The source buffer without autograd: all_gather or boundary halo."""
    return all_gather_rows(x_local) if send is None else halo_rows(x_local, send)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return all_gather_rows(x)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter_rows(g)


class _Halo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, send):
        ctx.send = send
        ctx.n_local = x.shape[0]
        return halo_rows(x, send)

    @staticmethod
    def backward(ctx, g):
        n = ctx.n_local
        back = all_to_all_rows(g[n:])  # each halo row's cotangent to its owner
        return segment_sum_(g[:n].clone(), ctx.send, back), None


def gather_buffer(x_local: torch.Tensor, send: Segments | None) -> torch.Tensor:
    """The source buffer of this rank's aggregation, differentiable in
    ``x_local``: the gathered matrix (all_gather halo, ``send`` None) or
    the compact ``[x_local ; halo]`` buffer (boundary halo; ``send`` the
    ``Segments`` of the sent local rows)."""
    if send is None:
        return _AllGather.apply(x_local)
    return _Halo.apply(x_local, send)
