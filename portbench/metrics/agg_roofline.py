"""Kernels: the aggregation's share of its roofline. The least time of the
window's Â-products over the device time of every aggregation kernel (the
tile SpMM and the ordered sums). The products are counted from the model's
equations (the family's ``work``), not from the pack the program chose.

Products that can share a read of Â do so in the least time: a group of the
``work`` (one dependency level of one epoch) over every lane training at
that epoch moves Â's nnz·8 bytes (an index and a value) once, and each
product's N·F input and output at the element width; its least time is the
larger of its 2·nnz·F operations over the peak and those bytes over the
bandwidth."""

from portbench.metrics._device import category_seconds


def least_s(ctx, widths: tuple, lanes: int, elem_bytes: int) -> float:
    g, pk = ctx.graph, ctx.peaks
    peak = pk["bf16_flops"] if elem_bytes == 2 else pk["f32_flops"]
    cols = sum(widths) * lanes
    ops = 2.0 * g["nnz"] * cols
    moved = g["nnz"] * 8.0 + 2.0 * g["n"] * cols * elem_bytes
    return max(ops / peak, moved / pk["bytes_per_s"])


def lanes_by_epoch(run) -> list[int]:
    """The lanes of ``run`` that train at each of its epochs."""
    return [sum(e < n for n in run.epochs_run) for e in range(max(run.epochs_run, default=0))]


def read(ctx):
    tr = ctx.trace
    if tr is None or ctx.peaks is None:
        return None
    kernel_s = category_seconds(ctx, "K3/K4 tile SpMM") + tr.seconds("pgcn_seg::")
    if kernel_s <= 0:
        return None
    least = 0.0
    for run in ctx.runs:
        for lanes in lanes_by_epoch(run):
            least += sum(least_s(ctx, w, lanes, ctx.graph["dtype_bytes"])
                         for w in ctx.work["agg"])
        # the once-a-run Â·X reads the float32 input, shared by the lanes
        least += sum(least_s(ctx, w, 1, 4) for w in ctx.work["agg_run"])
    return 100.0 * least / kernel_s
