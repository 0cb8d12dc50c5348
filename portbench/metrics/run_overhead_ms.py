"""Whole-run loop: the time a run spends outside its epochs' replays (the
input's pre-aggregation, epoch 1, the capture, the test eval, the read-back):
the benchmark's synced host clock around the call less replays × the
program's time a replay, averaged over the window's runs."""


def read(ctx):
    if not ctx.runs or not any(r.replays for r in ctx.runs):
        return None
    return sum((r.seconds - r.replays * r.epoch_s) * 1e3 for r in ctx.runs) / len(ctx.runs)
