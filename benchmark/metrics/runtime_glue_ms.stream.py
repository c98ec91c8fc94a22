"""The whole-cell runtime's host time a call outside the kernel's launch:
the program's `whole_cell.process` ranges in the trace, each less the
`k2.launch` ranges inside it, averaged over the traced calls, in ms.
Nothing to read where the program records no such ranges."""


def read(ctx):
    tr = ctx.trace
    if tr is None:
        return None
    calls = [(s, e) for name, s, e in tr.host_ops if name == "whole_cell.process"]
    launches = [(s, e) for name, s, e in tr.host_ops if name == "k2.launch"]
    if not calls:
        return None
    glue = sum((e - s) - sum(le - ls for ls, le in launches if s <= ls and le <= e)
               for s, e in calls)
    return 1e3 * glue / len(calls)
