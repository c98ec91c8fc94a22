"""The port's tracing: named spans, stage timings and the whole-cell
kernel's per-block stage timers. The port's copy of
`deepfilternet_tpu.utils.timings` (reference: the `timings` Cargo feature +
LOG_TIMINGS config), grown into the one switch for all of it.

* `span(name)` marks a stretch of host code at a layer boundary. While a
  `torch.profiler` is recording it opens a `torch.profiler.record_function`
  range, a host event on the clock of the profiler's device records, so a
  trace names what the host did while the device waited. With no profiler
  recording and `LOG_TIMINGS` off it costs two boolean tests and returns a
  shared null context: no object, no allocation, no call into the profiler.
* `Timings` keeps named stage durations as running sums (count, total,
  largest), so its memory stays bounded however long a process runs.
  `GLOBAL_TIMINGS` is the process's instance: spans add to it while the
  `LOG_TIMINGS` flag is on (`log_timings_enabled()` reads the flag; the data
  loader reads it at each epoch, `train/run.py` logs and resets the summary
  once an epoch).
* The whole-cell kernel (`ops/whole_cell.py::cell_process`) times each
  stage of its frame in every thread block, but only while a profiler is
  recording, and then in one call of every few (`RECORD_EVERY` there), so
  that the trace also times the kernel that ships; `k2_records()` returns
  what the last recording calls recorded.

How an operator gets spans: run the code under `torch.profiler.profile`
(the ranges and K2's records), or set `LOG_TIMINGS = true` in the `[train]`
section of the config for the loader's per-epoch summary.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from contextlib import contextmanager, nullcontext
from typing import Deque, Dict, List, Sequence

import numpy as np
import torch
import torch.autograd.profiler as _profiler


class Timings:
    """Named durations as running sums: {name: [count, total s, largest s]}.
    Safe to add to from several threads (the loader's workers do)."""

    def __init__(self):
        self._acc: Dict[str, List[float]] = {}
        self._lock = threading.Lock()

    @contextmanager
    def timed(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add(name, time.perf_counter() - t0)

    def add(self, name: str, seconds: float):
        with self._lock:
            acc = self._acc.get(name)
            if acc is None:
                self._acc[name] = [1, seconds, seconds]
            else:
                acc[0] += 1
                acc[1] += seconds
                acc[2] = max(acc[2], seconds)

    def summary(self) -> str:
        with self._lock:
            items = sorted((k, list(v)) for k, v in self._acc.items())
        return " | ".join(f"{name}: {total * 1e3:.1f}ms (n={n}, mean {total / n * 1e3:.2f}ms, "
                          f"max {top * 1e3:.2f}ms)" for name, (n, total, top) in items)

    def reset(self):
        with self._lock:
            self._acc.clear()

    def totals(self) -> Dict[str, float]:
        with self._lock:
            return {k: v[1] for k, v in self._acc.items()}


GLOBAL_TIMINGS = Timings()

# whether spans add to GLOBAL_TIMINGS: the LOG_TIMINGS flag as
# log_timings_enabled() last read it
_log_timings = False


def log_timings_enabled() -> bool:
    """The `LOG_TIMINGS` flag of the config's `[train]` section; spans add
    their durations to `GLOBAL_TIMINGS` from this call on while it is set."""
    from deepfilternet_torch.config import config

    global _log_timings
    _log_timings = bool(config("LOG_TIMINGS", False, bool, section="train"))
    return _log_timings


_OFF = nullcontext()


def tracing() -> bool:
    """Whether a torch profiler is recording."""
    return _profiler._is_profiler_enabled


@contextmanager
def _range(name: str):
    with _profiler.record_function(name):
        if _log_timings:
            with GLOBAL_TIMINGS.timed(name):
                yield
        else:
            yield


def span(name: str):
    """A context manager around a stretch of host code named `name` (a
    dotted path: the layer, then the step). A range of the trace while a
    profiler is recording; a duration in `GLOBAL_TIMINGS` while LOG_TIMINGS
    is on; else nothing."""
    if _profiler._is_profiler_enabled:
        return _range(name)
    if _log_timings:
        return GLOBAL_TIMINGS.timed(name)
    return _OFF


# ---------------------------------------------------------------------------
# the whole-cell kernel's stage timers
# ---------------------------------------------------------------------------

# recording calls whose records are kept
K2_KEEP = 48
# (design, stage names, stage families, frames, records: int64 device tensor
# [blocks, stages + 3]), newest last
_k2: Deque[tuple] = deque(maxlen=K2_KEEP)


def k2_keep(design: str, stages: Sequence[str], families: Sequence[str], frames: int,
            records: torch.Tensor):
    """Keep one recording call's record buffer, still on the device (no wait:
    the kernel fills it after the launch returns)."""
    _k2.append((design, tuple(stages), tuple(families), int(frames), records))


def k2_records() -> List[Dict]:
    """The records of the last recording calls of the whole-cell kernel,
    oldest first (waits for the device). Each: `design` ("rows" or "units"),
    `stages` (names), `families` (each stage's: "gru", "conv", "dsp", or
    "wait" for the units design's waiting on producers), `frames`, `ns`
    (int64 [blocks, stages]: each thread block's time in each stage, summed
    over its tiles and the call's frames), `span` (int64 [blocks, 2]: the
    block's first and last reading of the device's global timer, in ns) and
    `cycles` (int64 [blocks]: the block's SM cycles between the two)."""
    out = []
    for design, stages, families, frames, rec in list(_k2):
        a = rec.cpu().numpy()
        out.append(dict(design=design, stages=stages, families=families, frames=frames,
                        ns=a[:, :-3], span=a[:, -3:-1], cycles=a[:, -1]))
    return out


def k2_clear():
    _k2.clear()


def k2_split(record: Dict) -> Dict:
    """One call's record reduced: `family_ms` (each family's time averaged
    over the blocks), `stage_median_ms` and `stage_max_ms` (by stage, the
    median and the slowest block), `busy` (the blocks' own spans over
    blocks x the call's span, from the first start to the last end) and
    `call_ms` (that span)."""
    ns = np.asarray(record["ns"], np.float64)
    span_ = np.asarray(record["span"], np.float64)
    fam = np.asarray(record["families"])
    call = span_[:, 1].max() - span_[:, 0].min()
    own = span_[:, 1] - span_[:, 0]
    return dict(
        family_ms={f: float(ns[:, fam == f].sum(axis=1).mean() * 1e-6)
                   for f in dict.fromkeys(record["families"])},
        stage_median_ms=np.median(ns, axis=0) * 1e-6,
        stage_max_ms=ns.max(axis=0) * 1e-6,
        busy=float(own.sum() / (len(own) * call)) if call > 0 else 0.0,
        call_ms=float(call * 1e-6))
