"""The share of K2's span in which its thread blocks held work, from the
kernel's own records of the traced calls (`utils.timings.k2_records` of the
program): over the calls, the sum over blocks of each block's span (its
first to its last global timer reading) over blocks x the call's span (the
first block's start to the last one's end). Nothing to read where the
program keeps no such records."""

import numpy as np

from benchmark import k2_records


def read(ctx):
    busy = whole = 0.0
    for rec in k2_records.records():
        span = np.asarray(rec["span"], np.float64)
        busy += float((span[:, 1] - span[:, 0]).sum())
        whole += len(span) * float(span[:, 1].max() - span[:, 0].min())
    return 100.0 * busy / whole if whole > 0 else None
