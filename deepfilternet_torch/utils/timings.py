"""Opt-in stage timing instrumentation, the port's own copy of
`deepfilternet_tpu.utils.timings` (reference: the `timings` Cargo feature +
LOG_TIMINGS config).

`Timings` accumulates named stage durations; `timed(name)` is a context
manager. The data loader and training loop record into a process-global
instance when the `LOG_TIMINGS` config flag is on, and `summary()` renders
the reference-style per-stage breakdown.
"""

from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Dict, List


class Timings:
    def __init__(self):
        self._acc: Dict[str, List[float]] = defaultdict(list)

    @contextmanager
    def timed(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._acc[name].append(time.perf_counter() - t0)

    def add(self, name: str, seconds: float):
        self._acc[name].append(seconds)

    def summary(self) -> str:
        parts = []
        for name in sorted(self._acc):
            v = self._acc[name]
            parts.append(f"{name}: {sum(v) * 1e3:.1f}ms (n={len(v)}, "
                         f"mean {sum(v) / len(v) * 1e3:.2f}ms)")
        return " | ".join(parts)

    def reset(self):
        self._acc.clear()

    def totals(self) -> Dict[str, float]:
        return {k: sum(v) for k, v in self._acc.items()}


GLOBAL_TIMINGS = Timings()


def log_timings_enabled() -> bool:
    from deepfilternet_torch.config import config

    return bool(config("LOG_TIMINGS", False, bool, section="train"))
