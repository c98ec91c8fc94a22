"""Kernel records a call of the offline path in the traced window: the
device operations the profiler saw over the calls it traced."""


def read(ctx):
    tr = ctx.trace
    if tr is None or not tr.device_ops:
        return None
    return len(tr.device_ops) / ctx.traced_calls
