"""The window's share of the card's float32 peak: the model forward's FLOPs
(`counts.forward_macs`, twice) for every frame of every clip enhanced in the
untraced part of the window, over its wall time."""

from benchmark import common, counts


def read(ctx):
    pk = common.card_peaks(ctx.dev)
    if pk is None or not ctx.window_calls:
        return None
    hop, fft = ctx.conf["hop_size"], ctx.conf["fft_size"]
    frames = (int(ctx.p["seconds_a_clip"] * ctx.conf["sr"]) + fft) // hop
    flops = 2 * counts.forward_macs(ctx.conf) * frames * ctx.p["rows"] * ctx.window_calls
    return 100.0 * flops / ctx.wall / pk[0]
