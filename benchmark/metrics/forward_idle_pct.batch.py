"""The share of the offline path's model forward in which the card is idle:
over the program's `enhance.forward` ranges in the trace, the time no device
activity covers (`Trace.busy_intervals`) over their summed length. Nothing
to read where the program records no such range."""


def read(ctx):
    tr = ctx.trace
    if tr is None:
        return None
    spans = [(s, e) for name, s, e in tr.host_ops if name == "enhance.forward"]
    length = sum(e - s for s, e in spans)
    if length <= 0:
        return None
    busy = tr.busy_intervals()
    covered = sum(max(0.0, min(e, be) - max(s, bs)) for s, e in spans for bs, be in busy)
    return 100.0 * (length - covered) / length
