"""Traffic kind `stream`: many independent streams enhanced by the
whole-cell runtime (`WholeCellStreamingRuntime.process`, kernel K2), one
call per block of frames of every stream, the carry running on from call
to call.

Parameters: `streams`, `frames` (a call's frames), `pool` (distinct blocks
of seeded audio held on the device; call k takes block k mod pool),
`sample_every` (one row in each run of this many, at an offset drawn from
the seed, is followed by the reference through every call), `keep_every`
(the sampled rows' output is kept of one call in each run of this many, at
an offset drawn from the seed), `ref_rows` (rows the reference runs at
once),
`trace_calls` (calls profiled at the start of a traced window),
`matmul_dtype`.

The check, against the reference (`reference/stream.py`) on the same audio
and weights: the sampled streams are followed from their start through
every call, and the kept calls' output and their last carry compared; every
stream's last call is run again from the carry the program had left before
it, and its output and the carry after it compared. `audio_err` is the
largest gap over the largest reference sample, `carry_err` the largest gap
of a carry array over that array's largest value.
"""

from __future__ import annotations

import time
from types import SimpleNamespace

import torch

from benchmark import common, harness


def _program_carry(c) -> dict:
    """The program's StreamCarry in the reference's names."""
    m = c.model
    return dict(analysis_mem=c.analysis_mem, synthesis_mem=c.synthesis_mem,
                mean_norm=c.mean_norm, unit_norm=c.unit_norm,
                silence_ctr=c.silence_ctr.to(torch.int64), erb_buf=m.erb_buf,
                spec_buf=m.spec_buf, enc_h=m.enc_gru_h, dec_h=m.dec_gru_h, df_h=m.df_gru_h,
                ring=torch.complex(m.df_ring_re, m.df_ring_im))


# the program broken underneath, for the test that the check fails
FAULTS = {
    # the call returns the carry it was given
    "stale_state": lambda process: lambda c, a: (c, process(c, a)[1]),
    # only the first half of the streams are processed; the rest read zero
    "half_batch": lambda process: lambda c, a: _half(process, c, a),
    # one sample of the output is altered where it is produced
    "altered_output": lambda process: lambda c, a: _altered(process, c, a),
}


def _half(process, c, a):
    c2, out = process(c, a)
    out = out.clone()
    out[out.shape[0] // 2:] = 0.0
    return c2, out


def _altered(process, c, a):
    c2, out = process(c, a)
    out = out.clone()
    out[out.shape[0] // 3, out.shape[1] // 2] += 0.01
    return c2, out


def inputs(cell, conf, seed, dev):
    """The seeded weights, the audio pool, the sampled rows and the offset of
    the kept calls of a run."""
    p = cell["params"]
    s, frames, hop = p["streams"], p["frames"], conf["hop_size"]
    W = common.seeded_weights(conf, seed, dev)
    pool = [common.speech_like(s, frames * hop, seed * 7919 + b + 1, dev)
            for b in range(p["pool"])]
    gen = torch.Generator().manual_seed(int(seed) % (2 ** 63))
    every = p["sample_every"]
    rows = torch.arange(0, s, every) + torch.randint(0, every, (-(-s // every),), generator=gen)
    keep_off = int(torch.randint(0, p["keep_every"], (1,), generator=gen))
    return W, pool, rows[rows < s].to(dev), keep_off


def setup(cell, conf, seed, dev, fault=None, seconds=None):
    from deepfilternet_torch.streaming_whole_cell import WholeCellStreamingRuntime

    p = cell["params"]
    W, pool, rows, keep_off = inputs(cell, conf, seed, dev)
    model, df_state = common.port_model(conf, W[0], W[1], dev)
    rt = WholeCellStreamingRuntime(model, df_state,
                                   matmul_dtype=getattr(torch, p["matmul_dtype"]))
    process = rt.process if fault is None else FAULTS[fault](rt.process)
    # warm-up: one call at the window's shape from a throwaway carry builds
    # and loads the kernel and packs its weights
    process(rt.init(p["streams"]), pool[0])
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return SimpleNamespace(p=p, conf=conf, dev=dev, W=W, rt=rt, process=process, pool=pool,
                           carry=rt.init(p["streams"]), rows=rows, keep_off=keep_off,
                           sampled={}, last=None,
                           calls=0, wall=0.0, attempted=0, failed=0, notes=[], trace=None,
                           limits=cell.get("limits", {}))


def _call(ctx):
    ctx.prev_carry = ctx.carry
    ctx.carry, out = ctx.process(ctx.carry, ctx.pool[ctx.calls % len(ctx.pool)])
    if ctx.calls % ctx.p["keep_every"] == ctx.keep_off:
        ctx.sampled[ctx.calls] = out.index_select(0, ctx.rows)
    ctx.last = out
    if ctx.dev.type == "cuda":
        torch.cuda.synchronize()
    ctx.calls += 1


def window(ctx, seconds):
    """`fixed_calls` in the parameters makes exactly that many calls (for
    the tools that read the control); else calls until `seconds` pass."""
    from deepfilternet_torch.ops.whole_cell import cell_process

    if ctx.traced:
        before = cell_process.launches
        with harness.trace_window(ctx) as h:
            for _ in range(ctx.p["trace_calls"]):
                _call(ctx)
        ctx.trace = h.trace
        launched = cell_process.launches - before
        k2 = ctx.trace.kernels("whole_cell_kernel") if ctx.trace else []
        ctx.k2_per_call = sum(e - s for _, s, e in k2) / len(k2) if k2 else None
        ctx.notes.append(f"trace: {len(k2)} K2 records of {launched} launches counted by "
                         f"cell_process.launches ({len(k2) / max(launched, 1):.0%} kept)")
    first = ctx.calls
    t0 = time.perf_counter()
    fixed = ctx.p.get("fixed_calls")
    while (ctx.calls - first < fixed) if fixed else (time.perf_counter() - t0 < seconds):
        _call(ctx)
    ctx.wall = time.perf_counter() - t0
    ctx.window_calls = ctx.calls - first
    ctx.attempted = ctx.calls * ctx.p["streams"]


def end_to_end(ctx):
    call_s = ctx.p["frames"] * ctx.conf["hop_size"] / ctx.conf["sr"]
    return {"stream_rtf": ctx.window_calls * ctx.p["streams"] * call_s / ctx.wall}


def release(ctx):
    """Free the program's state; keep what it produced."""
    kept = sum(t.numel() * t.element_size() for t in ctx.sampled.values())
    ctx.notes.append(f"memory: the check kept {kept} bytes of output on the device "
                     f"({len(ctx.sampled)} calls x {len(ctx.rows)} rows)")
    ctx.result_carry = _program_carry(ctx.carry)
    ctx.before_last = _program_carry(ctx.prev_carry)
    del ctx.rt, ctx.process, ctx.carry, ctx.prev_carry


_GRU_STATES = ("enc_h", "dec_h", "df_h")  # [layers, streams, hidden]


def _rows(carry, idx):
    return {k: v[:, idx] if k in _GRU_STATES else v[idx] for k, v in carry.items()}


class _Gaps:
    """The largest gap and largest reference value of each output."""

    def __init__(self):
        self.gap = {}

    def add(self, name, got, ref):
        g = float((got.to(ref.dtype) - ref).abs().max())
        m = float(ref.abs().max())
        pg, pm = self.gap.get(name, (0.0, 0.0))
        self.gap[name] = (max(pg, g), max(pm, m))

    def rel(self, name):
        g, m = self.gap[name]
        return g / max(m, 1e-30)


def check(ctx):
    from benchmark.reference.stream import init_carry, stream_block

    p, conf, dev, pool = ctx.p, ctx.conf, ctx.dev, ctx.pool
    gaps = _Gaps()
    last = ctx.calls - 1
    with torch.no_grad():
        # the sampled streams, from their start
        carry = init_carry(conf, len(ctx.rows), dev)
        for k in range(ctx.calls):
            carry, out = stream_block(ctx.W, conf, carry,
                                      pool[k % len(pool)].index_select(0, ctx.rows))
            if k in ctx.sampled:
                gaps.add("audio", ctx.sampled[k], out)
        for name, ref in carry.items():
            gaps.add(name, _rows(ctx.result_carry, ctx.rows)[name], ref)
        # every stream's last call, from the carry the program had before it
        for lo in range(0, p["streams"], p["ref_rows"]):
            idx = torch.arange(lo, min(p["streams"], lo + p["ref_rows"]), device=dev)
            carry, out = stream_block(ctx.W, conf, _rows(ctx.before_last, idx),
                                      pool[last % len(pool)].index_select(0, idx))
            gaps.add("audio", ctx.last.index_select(0, idx), out)
            for name, ref in carry.items():
                gaps.add(name, _rows(ctx.result_carry, idx)[name], ref)
    names = [k for k in gaps.gap if k != "audio"]
    ctx.notes.append("carry gaps: " + ", ".join(
        f"{k} {gaps.gap[k][0]:.3e}/{gaps.gap[k][1]:.3e}" for k in names))
    return {
        "audio_err": (gaps.rel("audio"), ctx.limits.get("audio_err", 0.0)),
        "carry_err": (max(gaps.rel(k) for k in names), ctx.limits.get("carry_err", 0.0)),
    }
