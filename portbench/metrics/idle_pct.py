"""Device: the share of the traced window in which no device op ran."""


def read(ctx):
    tr = ctx.trace
    if tr is None or tr.window_s <= 0 or not tr.intervals:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)
