"""K2's own stage records, as the program keeps them for its traced calls
(`utils.timings.k2_records`), for the `k2_*` metrics. Nothing to read where
the program keeps no such records."""

import numpy as np


def records():
    try:
        from deepfilternet_torch.utils import timings
    except ImportError:
        return []
    read = getattr(timings, "k2_records", None)
    return read() if read is not None else []


def family_ms(family):
    """K2's time a call in the stages of `family` (the program's
    `ops/whole_cell.py::FAMILIES`): each block's ns in those stages, averaged
    over the blocks, then over the recorded calls, in ms."""
    per_call = []
    for rec in records():
        ns = np.asarray(rec["ns"], np.float64)
        mine = np.asarray(rec["families"]) == family
        per_call.append(ns[:, mine].sum(axis=1).mean())
    return float(np.mean(per_call)) * 1e-6 if per_call else None
