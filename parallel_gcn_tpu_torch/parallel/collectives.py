"""Collectives of the mesh trainer, with autograd: the node axis and the
feat axis of the (nodes, feat) process grid.

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

``all_reduce_sum`` reduces gradients and metrics. Every node collective
takes the node group (``group``; None: the whole world) and reads that
group's rank and size.

Tensor parallelism (``tp`` > 1, the JAX package's 2-D ``(nodes, feat)``
mesh) runs ``n_devices × tp`` processes. Rank r has node index ``r // tp``
and feat index ``r % tp`` (JAX ``make_mesh``: adjacent ids on the feat
axis). ``grid`` builds one group per node index (the ``tp`` feat ranks
that hold the same rows) and one per feat index (the ``n_devices`` node
ranks that hold the same weight shard). A rank's ``FeatGroup`` carries the
feat collectives as autograd Functions with their transposes written out,
each taking the gradient of the loss once:

- ``psum``: ``all_reduce`` forward, identity backward (the cotangent of
  the replicated output is the same on every feat rank);
- ``psum_scatter``: the column-blocked reduce-scatter of a partial product
  (``[n, d]`` viewed as ``[tp, n, d/tp]``, made contiguous, scattered on
  dim 0); backward: the column all_gather;
- ``gather_cols``: the column all_gather; backward: the column
  reduce-scatter, which sums the partial input gradients of the
  column-sharded product that follows;
- ``copy_in`` (Megatron's *f*): identity forward, ``all_reduce``
  backward, where a replicated tensor that needs a gradient feeds a
  feat-sharded product without coming from ``gather_cols``.

The JAX package's ``shard_map`` (``check_vma=False``) transposes a
``psum`` into a ``psum``; its TP gradient is then n_dev·tp times the
loss's (ROADMAP F5). The port does not copy that.

``counts`` counts every collective call by kind (the feat kinds under
``feat_*``, where the call is issued, forward or backward), so tests can
pin an epoch step's structure.

``world`` joins the world ``torch.distributed`` already has (torchrun), or
starts a world of one process over a ``FileStore`` in a temporary directory
(NCCL for CUDA tensors, gloo for CPU ones), which needs no network.
"""

from __future__ import annotations

import contextlib
import os
import shutil
import tempfile
from dataclasses import dataclass

import torch
import torch.distributed as dist

from parallel_gcn_tpu_torch.ops.cuda_segment import Segments, segment_sum_

# collective calls by kind
counts = {"all_gather": 0, "reduce_scatter": 0, "all_to_all": 0, "all_reduce": 0,
          "ppermute": 0, "feat_psum": 0, "feat_psum_scatter": 0, "feat_all_gather": 0,
          "feat_f": 0}

# all_gather_single / reduce_scatter_single are the newer names
_all_gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor

def mesh_command(n_devices: int, tp: int = 1) -> str:
    """The torchrun command of a mesh run of ``n_devices`` node ranks and
    ``tp`` feat ranks each: one process per GPU."""
    grid = f"n_devices={n_devices}" + (f" tp={tp}" if tp > 1 else "")
    return (f"torchrun --standalone --nproc_per_node={n_devices * tp} -m "
            f"parallel_gcn_tpu_torch <dataset> {grid} [key=value ...]")


@contextlib.contextmanager
def world(n_devices: int, device: torch.device, tp: int = 1):
    """Yield (rank, world size) of the world this process belongs to.

    With a world already initialized it must have ``n_devices × tp`` ranks.
    With none, that product must be 1: a world of one is started here
    (backend ``cpu:gloo,cuda:nccl`` when ``device`` is CUDA, ``gloo``
    otherwise) and destroyed on exit."""
    n = n_devices * tp
    what = f"n_devices={n_devices}" + (f" × tp={tp}" if tp > 1 else "")
    if dist.is_initialized():
        size = dist.get_world_size()
        if size != n:
            raise RuntimeError(f"{what} in a torch.distributed world of {size} ranks")
        yield dist.get_rank(), size
        return
    if n != 1:
        raise RuntimeError(
            f"{what} needs a torch.distributed world of {n} processes, one per GPU: "
            f"{mesh_command(n_devices, tp)}"
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
        _GROUPS.clear()
        shutil.rmtree(store_dir, ignore_errors=True)


def local_device(device: torch.device) -> torch.device:
    """This rank's device: ``cuda:<LOCAL_RANK>`` for CUDA (torchrun sets the
    variable; 0 without it), the CPU as given."""
    if device.type != "cuda":
        return device
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", device.index or 0)))


def all_gather_rows(x: torch.Tensor, group=None, kind: str = "all_gather") -> torch.Tensor:
    """[n_local, F] on every rank of ``group`` -> [size·n_local, F], rank
    order."""
    x = x.contiguous()
    out = x.new_empty((dist.get_world_size(group) * x.shape[0], *x.shape[1:]))
    _all_gather(out, x, group=group)
    counts[kind] += 1
    return out


def reduce_scatter_rows(x: torch.Tensor, group=None,
                        kind: str = "reduce_scatter") -> torch.Tensor:
    """[size·n_local, F] on every rank of ``group`` -> [n_local, F]: the sum
    over ranks of each rank's block for this rank."""
    x = x.contiguous()
    out = x.new_empty((x.shape[0] // dist.get_world_size(group), *x.shape[1:]))
    _reduce_scatter(out, x, group=group)
    counts[kind] += 1
    return out


def all_to_all_rows(x: torch.Tensor, group=None) -> torch.Tensor:
    """Equal chunks: chunk d of this rank's rows goes to rank d of
    ``group``, and chunk b of the result came from rank b."""
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    counts["all_to_all"] += 1
    return out


def ppermute_rows(x: torch.Tensor, group=None) -> torch.Tensor:
    """The ring's rotation: this rank's rows go to rank + 1 of ``group`` and
    the result holds rank − 1's (mod the group's size). A group of one
    returns ``x`` and calls no backend."""
    world = dist.get_world_size(group)
    if world == 1:
        return x
    x = x.contiguous()
    out = torch.empty_like(x)
    rank, n = dist.get_rank(group), x.shape[0]
    send = [0] * world
    recv = [0] * world
    send[(rank + 1) % world] = n
    recv[(rank - 1) % world] = n
    dist.all_to_all_single(out, x, output_split_sizes=recv, input_split_sizes=send,
                           group=group)
    counts["ppermute"] += 1
    return out


def all_reduce_sum(x: torch.Tensor, group=None, kind: str = "all_reduce") -> torch.Tensor:
    """Sum over the ranks of ``group``, in place; returns ``x``."""
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    counts[kind] += 1
    return x


def halo_rows(x_local: torch.Tensor, send: Segments, group=None) -> torch.Tensor:
    """The boundary exchange without autograd: ``[x_local ; rows received
    from each peer]``."""
    return torch.cat([x_local, all_to_all_rows(x_local.index_select(0, send.index), group)])


def buffer_rows(x_local: torch.Tensor, send: Segments | None, group=None) -> torch.Tensor:
    """The source buffer without autograd: all_gather or boundary halo."""
    return all_gather_rows(x_local, group) if send is None else halo_rows(x_local, send, group)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_gather_rows(x, group)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter_rows(g, ctx.group), None


class _Halo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, send, group):
        ctx.send, ctx.group = send, group
        ctx.n_local = x.shape[0]
        return halo_rows(x, send, group)

    @staticmethod
    def backward(ctx, g):
        n = ctx.n_local
        back = all_to_all_rows(g[n:], ctx.group)  # each halo row's cotangent to its owner
        return segment_sum_(g[:n].clone(), ctx.send, back), None, None


def gather_buffer(x_local: torch.Tensor, send: Segments | None, group=None) -> torch.Tensor:
    """The source buffer of this rank's aggregation, differentiable in
    ``x_local``: the gathered matrix (all_gather halo, ``send`` None) or
    the compact ``[x_local ; halo]`` buffer (boundary halo; ``send`` the
    ``Segments`` of the sent local rows), over the node ``group``."""
    if send is None:
        return _AllGather.apply(x_local, group)
    return _Halo.apply(x_local, send, group)


# ---------------------------------------------------------------------------
# the feat axis
# ---------------------------------------------------------------------------


def _col_blocks(x: torch.Tensor, tp: int) -> torch.Tensor:
    """[n, d] -> [tp·n, d/tp]: column block b of every row, block-major."""
    n, d = x.shape
    return x.reshape(n, tp, d // tp).transpose(0, 1).reshape(tp * n, d // tp)


def _from_col_blocks(x: torch.Tensor, tp: int) -> torch.Tensor:
    """The inverse of ``_col_blocks``: [tp·n, w] -> [n, tp·w]."""
    n = x.shape[0] // tp
    return x.reshape(tp, n, x.shape[1]).transpose(0, 1).reshape(n, tp * x.shape[1])


class FeatGroup:
    """The ``size`` feat ranks of one node rank; this process is feat rank
    ``rank``. The raw collectives (``all_reduce``, ``reduce_scatter_cols``,
    ``all_gather_cols``, ``all_gather_rows``) carry no autograd; ``psum``,
    ``psum_scatter``, ``gather_cols`` and ``copy_in`` are the model's, with
    their transposes (module docstring). A test or an emulation may supply
    another object with the same methods."""

    def __init__(self, group, rank: int, size: int):
        self.group, self.rank, self.size = group, rank, size

    def all_reduce(self, x: torch.Tensor, kind: str = "feat_psum") -> torch.Tensor:
        return all_reduce_sum(x, self.group, kind)

    def reduce_scatter_cols(self, x: torch.Tensor) -> torch.Tensor:
        """[n, d] partial sums -> [n, d/size]: this rank's column block of
        their sum over the feat ranks."""
        return reduce_scatter_rows(_col_blocks(x.contiguous(), self.size), self.group,
                                   "feat_psum_scatter")

    def all_gather_cols(self, x: torch.Tensor) -> torch.Tensor:
        """[n, w] column blocks -> [n, size·w] in feat-rank order."""
        return _from_col_blocks(all_gather_rows(x, self.group, "feat_all_gather"), self.size)

    def all_gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """[r, c] row blocks -> [size·r, c] in feat-rank order."""
        return all_gather_rows(x, self.group, "feat_all_gather")

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        return _Psum.apply(x, self)

    def psum_scatter(self, x: torch.Tensor) -> torch.Tensor:
        return _PsumScatter.apply(x, self)

    def gather_cols(self, x: torch.Tensor) -> torch.Tensor:
        return _GatherCols.apply(x, self)

    def copy_in(self, x: torch.Tensor) -> torch.Tensor:
        return _CopyIn.apply(x, self)


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, feat):
        return feat.all_reduce(x.contiguous().clone())

    @staticmethod
    def backward(ctx, g):
        return g, None


class _PsumScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, feat):
        ctx.feat = feat
        return feat.reduce_scatter_cols(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.feat.all_gather_cols(g.contiguous()), None


class _GatherCols(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, feat):
        ctx.feat = feat
        return feat.all_gather_cols(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.feat.reduce_scatter_cols(g), None


class _CopyIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, feat):
        ctx.feat = feat
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.feat.all_reduce(g.contiguous().clone(), "feat_f"), None


@dataclass(frozen=True)
class Grid:
    """This process's place in the (nodes, feat) grid: ``node_rank`` of
    ``n_nodes`` (the partition's rank), ``feat`` its ``FeatGroup`` (None
    when ``tp`` is 1), ``node_group`` the ranks that share its feat index
    (None: the whole world)."""

    n_nodes: int
    tp: int
    node_rank: int
    node_group: object = None
    feat: FeatGroup | None = None

    @property
    def feat_rank(self) -> int:
        return 0 if self.feat is None else self.feat.rank


# (n_nodes, tp) -> (node groups by feat index, feat groups by node index), for
# the world they were made in: every rank makes them once, in the same order
_GROUPS: dict = {}


def grid(n_devices: int, tp: int = 1) -> Grid:
    """This rank's ``Grid`` in a world of ``n_devices × tp`` ranks (rank r:
    node index r // tp, feat index r % tp). At ``tp`` 1 the node group is
    the whole world and no group is made."""
    rank = dist.get_rank()
    if tp <= 1:
        return Grid(n_nodes=n_devices, tp=1, node_rank=rank)
    key = (id(dist.group.WORLD), n_devices, tp)
    if key not in _GROUPS:
        node = [dist.new_group([n * tp + f for n in range(n_devices)]) for f in range(tp)]
        feat = [dist.new_group([n * tp + f for f in range(tp)]) for n in range(n_devices)]
        _GROUPS[key] = (node, feat)
    node, feat = _GROUPS[key]
    n, f = divmod(rank, tp)
    return Grid(n_nodes=n_devices, tp=tp, node_rank=n, node_group=node[f],
                feat=FeatGroup(feat[n], f, tp))
