"""The traced window: torch.profiler over a short steady stretch, reduced to
what the per-layer metrics and the result's `breakdown` read.

The profiler is started once the cell is warm and stopped after a few
seconds at most: it loses kernel records as a process ages (seen on an
H100 after ~50 s), so the window is taken early. The trace gives the
device's activity (kernels, copies, sets) and the host's operations; the
window itself is the span of a `bench.window` range recorded around it.
"""

from __future__ import annotations

import contextlib
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch

WINDOW_SPAN = "bench.window"


class Trace:
    """The reduced trace: device intervals and host ranges in seconds from
    the window's start, and the kernel records by name."""

    def __init__(self, device_ops: List[Tuple[str, float, float]],
                 host_ops: List[Tuple[str, float, float]], window_s: float):
        self.device_ops = device_ops  # (name, start, end)
        self.host_ops = host_ops
        self.window_s = window_s

    def kernels(self, name_part: str) -> List[Tuple[str, float, float]]:
        return [op for op in self.device_ops if name_part in op[0]]

    def busy_intervals(self) -> List[Tuple[float, float]]:
        """The device's activity, overlaps merged, clipped to the window."""
        spans = sorted((max(0.0, s), min(self.window_s, e)) for _, s, e in self.device_ops
                       if e > 0.0 and s < self.window_s)
        merged: List[List[float]] = []
        for s, e in spans:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals())

    def top_device_ops(self, n: int = 10) -> List[List]:
        total: Dict[str, float] = defaultdict(float)
        for name, s, e in self.device_ops:
            total[name] += e - s
        return [[k, v] for k, v in sorted(total.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> List[List]:
        """The longest stretches with nothing on the device, each named by
        the innermost host range open at its middle."""
        busy = self.busy_intervals()
        edges = [0.0] + [x for s, e in busy for x in (s, e)] + [self.window_s]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for s, e in gaps[:n]:
            mid = 0.5 * (s + e)
            open_ = [(he - hs, name) for name, hs, he in self.host_ops if hs <= mid <= he]
            label = min(open_)[1] if open_ else "host: nothing recorded"
            out.append([label, e - s])
        return out


@contextlib.contextmanager
def profiled(enabled: bool):
    """Profile the body when `enabled`; yields a holder whose `trace` is set
    on exit (None when disabled or when the window range is missing)."""
    holder = type("Holder", (), {"trace": None})()
    if not enabled:
        yield holder
        return
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.start()
    try:
        with record_function(WINDOW_SPAN):
            yield holder
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    finally:
        prof.stop()
    holder.trace = reduce(prof)


def reduce(prof) -> Optional[Trace]:
    """The profiler's raw events as a Trace relative to the window range.
    Read straight from the kineto results, without the profiler's own event
    tree, which is slow to build for a few hundred thousand kernels. Device-side
    user annotations span kernels already counted and are left out."""
    events = prof.profiler.kineto_results.events()
    cuda = torch.autograd.DeviceType.CUDA
    win = [e for e in events if e.name() == WINDOW_SPAN and e.device_type() != cuda]
    if not win:
        return None
    w0 = win[0].start_ns()
    dev, host = [], []
    for e in events:
        name = e.name()
        if name == WINDOW_SPAN:
            continue
        s = (e.start_ns() - w0) * 1e-9
        span = (name, s, s + e.duration_ns() * 1e-9)
        if e.device_type() != cuda:
            host.append(span)
        elif not e.is_user_annotation():
            dev.append(span)
    return Trace(dev, host, win[0].duration_ns() * 1e-9)
