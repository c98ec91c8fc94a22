"""The ms a call in which the card is idle while the offline path moves
audio on the host: inside the program's `enhance.pad`, `enhance.h2d`,
`enhance.d2h` and `enhance.trim` ranges in the trace, the time no device
activity covers (`Trace.busy_intervals`), over the traced calls. Nothing to
read where the program records no such ranges."""

IO_SPANS = ("enhance.pad", "enhance.h2d", "enhance.d2h", "enhance.trim")


def read(ctx):
    tr = ctx.trace
    if tr is None or not getattr(ctx, "traced_calls", 0):
        return None
    spans = [(s, e) for name, s, e in tr.host_ops if name in IO_SPANS]
    if not spans:
        return None
    busy = tr.busy_intervals()
    idle = sum((e - s) - sum(max(0.0, min(e, be) - max(s, bs)) for bs, be in busy)
               for s, e in spans)
    return 1e3 * idle / ctx.traced_calls
