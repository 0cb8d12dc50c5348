"""Host data layer: the program's set-up stages (load, reorder, permute,
pack, copy; the copy synced), as ``Dataset.setup`` and
``DeviceDataset.setup`` record them."""


def read(ctx):
    return sum(ctx.setup.values()) if ctx.setup else None
