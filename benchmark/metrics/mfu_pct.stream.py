"""The whole window's share of the card's float32 peak: K2's FLOPs for
every call of the untraced part of the window (`counts.k2_work`) over its
wall time."""

from benchmark import common, counts


def read(ctx):
    pk = common.card_peaks(ctx.dev)
    if pk is None or not ctx.window_calls:
        return None
    flops, _ = counts.k2_work(ctx.conf, ctx.p["streams"], ctx.p["frames"])
    return 100.0 * flops * ctx.window_calls / ctx.wall / pk[0]
