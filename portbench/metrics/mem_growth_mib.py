"""Whole-run loop: what stays allocated on the device from one training run
of the window to the next (the allocator's count at each run's end, on the
fullest device), MiB a run, over the window's runs after the first. A
window of one run, or a run off CUDA, has nothing to read."""


def read(ctx):
    held = [r.allocated_bytes for r in ctx.runs]
    if len(held) < 2 or any(h is None for h in held):
        return None
    return (held[-1] - held[0]) / (len(held) - 1) / 2**20
