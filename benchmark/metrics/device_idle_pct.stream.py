"""The share of the traced window in which nothing ran on the card."""


def read(ctx):
    tr = ctx.trace
    if tr is None or not tr.device_ops:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)
