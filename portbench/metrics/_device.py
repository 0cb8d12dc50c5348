"""What the device-time readers share."""

from __future__ import annotations


def ms_per_model_epoch(ctx, seconds: float) -> float | None:
    """``seconds`` of device time as ms a model-epoch; None without a trace
    or without any such time."""
    if ctx.trace is None or seconds <= 0.0:
        return None
    return seconds * 1e3 / ctx.model_epochs


def category_seconds(ctx, *cats: str) -> float:
    from portbench.devtrace import category

    return sum(sec for name, (sec, _) in ctx.trace.ops.items() if category(name) in cats)
