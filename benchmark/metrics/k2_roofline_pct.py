"""K2's share of its roofline: the least time the card could take for one
call (the larger of its FLOPs at the float32 peak and its bytes at the
memory peak, from `counts.k2_work` at the configuration's widths) over
K2's mean device time a call in the traced window."""

from benchmark import common, counts


def read(ctx):
    pk = common.card_peaks(ctx.dev)
    t = getattr(ctx, "k2_per_call", None)
    if pk is None or not t:
        return None
    flops, nbytes = counts.k2_work(ctx.conf, ctx.p["streams"], ctx.p["frames"])
    return 100.0 * max(flops / pk[0], nbytes / pk[1]) / t
