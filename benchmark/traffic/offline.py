"""Traffic kind `offline`: whole clips enhanced by `enhance.enhance(...,
backend="offline")`, batch after batch, numpy in and numpy out, as an
archive job calls it.

Parameters: `rows` and `seconds_a_clip` (a batch's shape), `pool` (distinct
seeded batches, called in turn), `keep_every` (the check compares one call
in each run of this many, at an offset drawn from the seed, and the last),
`trace_calls` (calls profiled at the start of a traced window); with
`fixed_calls` the window makes exactly that many calls (for the tests).

The check: the reference (`reference/stream.py::offline_enhance`) enhances
the same batches from the same weights; every kept call's whole output is
compared (`audio_err`, the largest gap over the largest reference sample).
"""

from __future__ import annotations

import time
from types import SimpleNamespace

import numpy as np
import torch

from benchmark import common, harness


def _altered(enhance):
    def run(*a, **k):
        out = enhance(*a, **k).copy()
        out[out.shape[0] // 3, out.shape[1] // 2] += 0.01
        return out
    return run


def _half(enhance):
    def run(model, df_state, audio, **k):
        out = np.zeros_like(audio)
        half = audio.shape[0] // 2
        out[:half] = enhance(model, df_state, audio[:half], **k)
        return out
    return run


def _stale(enhance):
    """The call hands back the input: no state advances through the model."""
    return lambda model, df_state, audio, **k: np.array(audio, copy=True)


FAULTS = {"altered_output": _altered, "half_batch": _half, "stale_state": _stale}


def setup(cell, conf, seed, dev, fault=None, seconds=None):
    from deepfilternet_torch import enhance as enh

    p = cell["params"]
    W = common.seeded_weights(conf, seed, dev)
    model, df_state = common.port_model(conf, W[0], W[1], dev)
    samples = int(p["seconds_a_clip"] * conf["sr"])
    pool = [common.speech_like(p["rows"], samples, seed * 7919 + b + 1, dev).cpu().numpy()
            for b in range(p["pool"])]
    fn = enh.enhance if fault is None else FAULTS[fault](enh.enhance)
    run = lambda audio: fn(model, df_state, audio, backend="offline")  # noqa: E731
    run(pool[0])  # warm-up at the window's shape
    keep_off = int(np.random.default_rng(int(seed) % (2 ** 63)).integers(p["keep_every"]))
    return SimpleNamespace(p=p, conf=conf, dev=dev, W=W, model=model, run=run, pool=pool,
                           outs={}, last=None, keep_off=keep_off, calls=0, window_calls=0,
                           wall=0.0, attempted=0, failed=0, notes=[], trace=None,
                           limits=cell.get("limits", {}))


def _call(ctx):
    out = ctx.run(ctx.pool[ctx.calls % len(ctx.pool)])
    if ctx.calls % ctx.p["keep_every"] == ctx.keep_off:
        ctx.outs[ctx.calls] = out
    ctx.last = out
    ctx.calls += 1


def window(ctx, seconds):
    if ctx.traced:
        with harness.trace_window(ctx) as h:
            for _ in range(ctx.p["trace_calls"]):
                _call(ctx)
        ctx.trace = h.trace
        ctx.traced_calls = ctx.p["trace_calls"]
    first = ctx.calls
    t0 = t = time.perf_counter()
    fixed = ctx.p.get("fixed_calls")
    call_s = []
    while (ctx.calls - first < fixed) if fixed else (t - t0 < seconds):
        _call(ctx)
        call_s.append(time.perf_counter() - t)
        t += call_s[-1]
    ctx.wall = t - t0
    ctx.window_calls = ctx.calls - first
    ctx.attempted = ctx.calls
    q = np.quantile(call_s, [0.0, 0.1, 0.5, 0.9, 1.0]) * 1e3
    ctx.notes.append("calls (ms): min {:.2f} p10 {:.2f} p50 {:.2f} p90 {:.2f} max {:.2f}"
                     .format(*q))


def end_to_end(ctx):
    audio_s = ctx.window_calls * ctx.p["rows"] * ctx.p["seconds_a_clip"]
    return {"batch_rtf": audio_s / ctx.wall}


def release(ctx):
    del ctx.model, ctx.run


def check(ctx):
    from benchmark.reference.stream import offline_enhance

    ctx.outs[ctx.calls - 1] = ctx.last
    keep = sorted(ctx.outs)
    gap = top = 0.0
    with torch.no_grad():
        for k in keep:
            audio = torch.from_numpy(ctx.pool[k % len(ctx.pool)]).to(ctx.dev)
            ref = offline_enhance(ctx.W, ctx.conf, audio).cpu().numpy()
            gap = max(gap, float(np.abs(ctx.outs[k] - ref).max()))
            top = max(top, float(np.abs(ref).max()))
    ctx.notes.append(f"check: calls {keep} of {ctx.calls} compared whole")
    return {"audio_err": (gap / max(top, 1e-30), ctx.limits.get("audio_err", 0.0))}
